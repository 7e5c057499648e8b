"""The data-parallel all-reduces' own device time in the traced iteration,
in ms: for each NCCL all-reduce kernel (every rank runs the same ones, in
the same order), the least of its device times over the ranks, summed.  A
kernel's time includes its wait for the last rank to join; the rank that
joins last waits least, so the least time is the transfer's and the
launch's, and the wait is ``parallel.allreduce_skew_ms``'s."""


def read(t):
    ranks = t.get("allreduce_launches") or []
    if not ranks or not ranks[0] or len({len(r) for r in ranks}) != 1:
        return None
    return sum(min(k) for k in zip(*ranks)) * 1000
