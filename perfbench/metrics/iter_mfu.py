"""The whole iteration's share of the chips' peak, in %: the least time of
the window's model work (policy inference in bf16, the critic's values
and the update's forward and backward passes in fp32, the skill match's
policy samples in bf16; each at its peak, from the rows the window's
calls took on every rank and the configuration's widths) on the run's
cards over the window's wall time."""

from perfbench import flops


def read(t):
    if not t["rows"]:
        return None
    return (flops.least_time_s(t["config"], t["rows"]) / t.get("chips", 1)
            / t["window_s"] * 100)
