"""Welford running statistics on the device (GigaLearnCPP/Util/
WelfordStat.h): a scalar running std for return standardisation (:7-67)
and a per-feature one for observation standardisation (:69-243).  All
float32, as the JAX package keeps them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WelfordState:
    count: torch.Tensor     # () float32
    mean: torch.Tensor      # () or (D,)
    m2: torch.Tensor        # () or (D,)

    @staticmethod
    def make(shape=(), device=None) -> "WelfordState":
        def z(s):
            return torch.zeros(s, dtype=torch.float32, device=device)
        return WelfordState(count=z(()), mean=z(shape), m2=z(shape))

    @property
    def variance(self) -> torch.Tensor:
        """Population variance m2 / count; 1 while count <= 1."""
        return torch.where(self.count > 1,
                           self.m2 / torch.clamp(self.count, min=1.0),
                           torch.ones_like(self.m2))

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.variance, min=1e-12))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t


def update_batch(state: WelfordState, x: torch.Tensor,
                 all_sum=_local) -> WelfordState:
    """Merge a batch of samples (leading axis: samples; trailing dims equal
    ``state.mean``'s) by the parallel Welford/Chan update.  The batch's
    count and sum, then its squares about their mean, are summed by
    ``all_sum``: by default ``x`` is the whole batch; a data-parallel rank
    passes ``EnvShard.all_sum``, so that the update sees every rank's part
    of the batch at once."""
    x = x.reshape((-1,) + tuple(state.mean.shape)).to(torch.float32)
    first = all_sum(torch.cat([
        torch.full((1,), float(x.shape[0]), device=x.device),
        torch.sum(x, dim=0).reshape(-1)]))
    n_b = first[0]
    mean_b = first[1:].reshape(state.mean.shape) / n_b
    m2_b = all_sum(torch.sum((x - mean_b) ** 2, dim=0).contiguous())
    n_a = state.count
    n = n_a + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * (n_b / torch.clamp(n, min=1.0))
    m2 = state.m2 + m2_b + delta ** 2 * (n_a * n_b / torch.clamp(n, min=1.0))
    return WelfordState(count=n, mean=mean, m2=m2)


def standardize_obs(state: WelfordState, obs: torch.Tensor,
                    min_std: float = 0.1,
                    max_mean_range: float = 3.0) -> torch.Tensor:
    """Observation standardisation (WelfordStat.h:132-215): the mean
    clamped to +-max_mean_range, the std held at least min_std."""
    mean = torch.clamp(state.mean, -max_mean_range, max_mean_range)
    std = torch.clamp(state.std, min=min_std)
    return (obs - mean) / std
