"""The arena-step kernel's share of its roofline, in %: the least time of
one traced launch (the larger of the fp32 operations its inputs need, as
the frozen plain step counts them, over the chip's fp32 peak, and the
state's bytes in and out over its memory bandwidth) over that launch's
device time in the profiler's trace."""

from perfbench import flops


def read(t):
    launch = t.get("launch")
    if not launch or not launch["kernel_s"]:
        return None
    share, _ = flops.roofline_share(launch["ops"], launch["bytes"],
                                    launch["kernel_s"])
    return share * 100
