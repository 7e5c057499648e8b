"""Generalized Advantage Estimation (GigaLearnCPP/PPO/GAE.cpp:7-208) on a
fixed ``(T, B)`` layout, time-major, oldest first:

  * rewards divided by the running return std (unless it is 0 or 1) and
    clipped to ``reward_clip_range`` (GAE.cpp:104-167); the ``returns``
    output, which feeds the return-std statistics, sums the raw rewards;
  * terminals (GAE.cpp:68-102): NORMAL bootstraps 0, TRUNCATED the
    critic value of the final (pre-reset) observation;
  * the reverse recurrence adv = delta + gamma*lambda*notDone*adv, and
    target values = value predictions + advantages (GAE.cpp:200).
"""

from __future__ import annotations

import torch

from perfbench.reference.rlt.envs.terminals import NORMAL, TRUNCATED


def _local(t: torch.Tensor) -> torch.Tensor:
    return t


def compute_gae(rewards, terminal_types, value_preds, next_value_preds,
                gamma: float = 0.99, lam: float = 0.95, return_std=None,
                reward_clip_range: float = 200.0, all_sum=_local):
    """All inputs ``(T, B)``.  ``next_value_preds[t]`` is the critic value
    of step t's post-step observation before auto-reset.  Returns
    (advantages, target_values, returns, reward_clip_portion).
    ``all_sum`` sums the clip portion's totals: a data-parallel rank
    passes ``EnvShard.all_sum``, so that they are over every rank's
    columns; the recurrence runs per column."""
    is_normal = terminal_types == NORMAL
    is_trunc = terminal_types == TRUNCATED
    not_done = (~is_normal & ~is_trunc).to(torch.float32)

    if return_std is not None:
        return_std = torch.as_tensor(return_std, dtype=torch.float32,
                                     device=rewards.device)
        inv = 1.0 / torch.clamp(return_std, min=1e-8)
        should_norm = (return_std != 0.0) & (return_std != 1.0)
        norm_rew = torch.where(should_norm, rewards * inv, rewards)
        clipped = (torch.clamp(norm_rew, -reward_clip_range,
                               reward_clip_range)
                   if reward_clip_range > 0 else norm_rew)
        total, total_clipped = all_sum(torch.stack([
            torch.sum(torch.abs(norm_rew)), torch.sum(torch.abs(clipped))]))
        clip_portion = torch.where(
            should_norm,
            (total - total_clipped) / torch.clamp(total, min=1e-7),
            torch.zeros_like(total))
        used_rewards = torch.where(should_norm, clipped, rewards)
    else:
        used_rewards = rewards
        clip_portion = torch.zeros((), device=rewards.device)

    next_vals = torch.where(is_normal, 0.0, next_value_preds)
    delta = used_rewards + gamma * next_vals - value_preds

    T = rewards.shape[0]
    advs = torch.empty_like(delta)
    rets = torch.empty_like(delta)
    adv = torch.zeros_like(delta[0])
    ret = torch.zeros_like(delta[0])
    for t in range(T - 1, -1, -1):
        adv = delta[t] + gamma * lam * not_done[t] * adv
        ret = rewards[t] + gamma * not_done[t] * ret
        advs[t] = adv
        rets[t] = ret
    return advs, value_preds + advs, rets, clip_portion
