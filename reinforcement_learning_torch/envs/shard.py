"""The block of arenas a process steps, and the reductions over the
processes that hold the others.

Unsharded, the block is the whole env and every reduction returns its
input.  ``parallel/mesh.py`` makes the sharded ones, one block per rank of
a device mesh; the env draws at the global shape and keeps its block, and
the trainer and the learner sum every batch statistic with ``all_sum``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from reinforcement_learning_torch.utils import tracing


class EnvShard:
    """Arenas ``[offset, offset + local_envs)`` of ``global_envs``.
    ``groups``: the process groups summed over in turn, innermost mesh
    axis first (none unsharded); ``rank``: the flattened index in the
    mesh, which is the process's rank."""

    def __init__(self, global_envs: int, offset: int = 0,
                 local_envs: int | None = None, groups: tuple = (),
                 rank: int = 0):
        self.global_envs = global_envs
        self.offset = offset
        self.local_envs = global_envs if local_envs is None else local_envs
        self.groups = groups
        self.rank = rank

    @property
    def sharded(self) -> bool:
        return bool(self.groups)

    @property
    def whole(self) -> bool:
        return self.local_envs == self.global_envs

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s leading (env) axis."""
        if self.whole:
            return x
        return x[self.offset:self.offset + self.local_envs]

    def take_rows(self, x: torch.Tensor, per_env: int) -> torch.Tensor:
        """This rank's rows of ``x``, ``per_env`` consecutive rows per
        arena."""
        if self.whole:
            return x
        return x[self.offset * per_env:
                 (self.offset + self.local_envs) * per_env]

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (over each mesh axis in turn,
        so every rank ends with the same bits) and return it."""
        for group in self.groups:
            dist.all_reduce(t, group=group)
        if self.groups:
            tracing.count("shard.all_sum.calls")
            tracing.count("shard.all_sum.bytes", t.numel() * t.element_size())
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of ``x`` in rank order: the whole env axis,
        on every rank."""
        if not self.sharded:
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def local_rows(self, perm: torch.Tensor, players: int) -> list:
        """Split minibatches of global row ids (``perm``: (batches, rows),
        rows flat in (step, arena, player) order over the global arenas)
        into this rank's rows of each, as ids into its local rows (the
        same order over its arenas), in the minibatch's order.  One host
        sync for all the minibatches."""
        if self.whole:
            return list(perm)
        per_step = self.global_envs * players
        t, rem = perm // per_step, perm % per_step
        arena, p = rem // players, rem % players
        mine = (arena >= self.offset) & (arena < self.offset
                                         + self.local_envs)
        local = (t * (self.local_envs * players)
                 + (arena - self.offset) * players + p)
        return list(torch.split(local[mine], mine.sum(1).tolist()))

    def from_root(self, flag: bool, device) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if not self.sharded:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.broadcast(t, src=0)
        return bool(t.item())
