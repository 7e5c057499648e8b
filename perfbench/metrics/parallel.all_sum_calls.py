"""The program's all-reduces per window iteration on rank 0: the port's
own counter ``shard.all_sum.calls`` (``envs/shard.py``, counted with the
tracer's spans off) over the window, over its iterations."""


def read(t):
    return t.get("all_sum_calls") or None
