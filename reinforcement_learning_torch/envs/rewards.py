"""Reward functions (RLGymCPP/Rewards/), batched over envs.

Each reward maps a ``RewardCtx`` to an ``(N, P)`` float tensor; the env sums
them with weights like ``EnvSet::StepSecondHalf`` (EnvSet.cpp:202-250).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m


@dataclasses.dataclass
class RewardCtx:
    """What a reward sees (GameState/Player, GameState.h:20-75): per-player
    fields ``(N, P, ...)``, per-arena fields ``(N, ...)``."""
    cars: object                  # CarsState, current
    prev_cars: object             # CarsState, previous step
    ball: object                  # BallState
    prev_ball: object
    teams: torch.Tensor           # (P,) int, 0 = blue, 1 = orange
    ball_touched_step: torch.Tensor  # (N, P) bool
    goal_scored: torch.Tensor     # (N,) bool
    has_prev: torch.Tensor        # (N,) bool, False on the reset step
    is_final: torch.Tensor        # (N,) int32 TerminalType of this step
    events: dict                  # name -> (N, P) bool
    blue_score: torch.Tensor = None    # (N,) goals this episode
    orange_score: torch.Tensor = None


RewardFn = Callable[[RewardCtx], torch.Tensor]


def goal_reward(concede_scale: float = -1.0) -> RewardFn:
    """Team goal reward, already zero-sum (CommonRewards.h:31-45)."""
    def fn(ctx: RewardCtx) -> torch.Tensor:
        # the ball is in the net on its y-sign side; the other team scored
        net_side_team = torch.where(ctx.ball.pos[:, 1] < 0, 0, 1)
        scored = ctx.teams[None, :] != net_side_team[:, None]
        val = torch.where(scored, 1.0, concede_scale)
        return torch.where(ctx.goal_scored[:, None], val, 0.0)
    fn.__name__ = "GoalReward"
    return fn


def velocity_player_to_ball_reward() -> RewardFn:
    def fn(ctx):
        dir_to_ball = m.normalize(ctx.ball.pos[:, None, :] - ctx.cars.pos)
        return m.dot(dir_to_ball, ctx.cars.vel / C.CAR_MAX_SPEED)
    fn.__name__ = "VelocityPlayerToBallReward"
    return fn


def touch_ball_reward() -> RewardFn:
    def fn(ctx):
        return ctx.ball_touched_step.to(torch.float32)
    fn.__name__ = "TouchBallReward"
    return fn


@dataclasses.dataclass
class WeightedReward:
    fn: RewardFn
    weight: float

    @property
    def name(self):
        return getattr(self.fn, "__name__", "reward")


def combine_rewards(weighted: list[WeightedReward]):
    """Returns fn(ctx) -> (total (N, P), per-reward dict name -> (N, P))."""
    def fn(ctx: RewardCtx):
        per = {}
        total = None
        for wr in weighted:
            r = wr.fn(ctx)
            per[wr.name] = r
            total = r * wr.weight if total is None else total + r * wr.weight
        return total, per
    return fn
