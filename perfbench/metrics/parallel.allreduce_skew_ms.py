"""The ranks' skew at the data-parallel all-reduces in the traced
iteration, in ms: for each NCCL all-reduce kernel (every rank runs the
same ones, in the same order), the most of its device times over the ranks
less the least, summed: how long the first rank to join waits for the
last, as each rank's host sets its own pace."""


def read(t):
    ranks = t.get("allreduce_launches") or []
    if not ranks or not ranks[0] or len({len(r) for r in ranks}) != 1:
        return None
    return sum(max(k) - min(k) for k in zip(*ranks)) * 1000
