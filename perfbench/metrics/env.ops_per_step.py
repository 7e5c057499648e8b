"""Tensor ops dispatched by one training env step (``RocketLeagueEnv.step``),
counted by the frozen copy of the dispatch counter on a step after the
window.  A count, the same from run to run."""


def read(t):
    return t.get("ops_per_step")
