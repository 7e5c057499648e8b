"""The training env step's host time per call (``RocketLeagueEnv.step``, no
wait for the device): the mean of the benchmark's ``env.step`` span over
the window's calls, in ms (host clock)."""


def read(t):
    spans = t["spans"].get("env.step")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1000
