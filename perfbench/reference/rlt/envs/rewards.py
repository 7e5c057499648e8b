"""Reward functions (RLGymCPP/Rewards/), batched over envs.

Each reward maps a ``RewardCtx`` to an ``(N, P)`` float tensor; the env sums
them with weights like ``EnvSet::StepSecondHalf`` (EnvSet.cpp:202-250).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt import maths as m


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


def goal_back(orange: torch.Tensor) -> torch.Tensor:
    """The back of the orange goal where ``orange``, else of the blue one
    (the JAX package's ``ORANGE_GOAL_BACK`` / ``BLUE_GOAL_BACK``):
    (..., 3)."""
    y = torch.where(orange, 6000.0, -6000.0)
    return torch.stack([torch.zeros_like(y), y,
                        torch.full_like(y, C.GOAL_HEIGHT / 2)], dim=-1)


def _per_arena(x, ctx):
    """An (N,) value on every player of its arena: (N, P)."""
    return x[:, None].expand(-1, ctx.teams.shape[0])


# --- event rewards (CommonRewards.h:7-28) ---------------------------------

def event_reward(name: str, negative: bool = False) -> RewardFn:
    def fn(ctx: RewardCtx) -> torch.Tensor:
        val = ctx.events[name].to(torch.float32)
        return -val if negative else val
    fn.__name__ = f"Event_{name}{'_neg' if negative else ''}"
    return fn


def player_goal_reward():
    return event_reward("goal")


def assist_reward():
    return event_reward("assist")


def shot_reward():
    return event_reward("shot")


def save_reward():
    return event_reward("save")


def bump_reward():
    return event_reward("bump")


def bumped_penalty():
    return event_reward("bumped", negative=True)


def demo_reward():
    return event_reward("demo")


def demoed_penalty():
    return event_reward("demoed", negative=True)


# --- continuous rewards ----------------------------------------------------

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


def velocity_reward(is_negative: bool = False) -> RewardFn:
    def fn(ctx):
        return m.norm(ctx.cars.vel) / C.CAR_MAX_SPEED * (1 - 2 * is_negative)
    fn.__name__ = "VelocityReward"
    return fn


def velocity_ball_to_goal_reward(own_goal: bool = False) -> RewardFn:
    def fn(ctx):
        target = goal_back((ctx.teams == 0) ^ own_goal)
        dir_to_goal = m.normalize(target[None] - ctx.ball.pos[:, None, :])
        return m.dot(dir_to_goal,
                     (ctx.ball.vel / C.BALL_MAX_SPEED)[:, None, :])
    fn.__name__ = "VelocityBallToGoalReward"
    return fn


def velocity_player_to_ball_reward() -> RewardFn:
    def fn(ctx):
        dir_to_ball = m.normalize(ctx.ball.pos[:, None, :] - ctx.cars.pos)
        return m.dot(dir_to_ball, ctx.cars.vel / C.CAR_MAX_SPEED)
    fn.__name__ = "VelocityPlayerToBallReward"
    return fn


def face_ball_reward() -> RewardFn:
    def fn(ctx):
        dir_to_ball = m.normalize(ctx.ball.pos[:, None, :] - ctx.cars.pos)
        return m.dot(ctx.cars.forward, dir_to_ball)
    fn.__name__ = "FaceBallReward"
    return fn


def touch_ball_reward() -> RewardFn:
    def fn(ctx):
        return ctx.ball_touched_step.to(torch.float32)
    fn.__name__ = "TouchBallReward"
    return fn


def speed_reward() -> RewardFn:
    def fn(ctx):
        return m.norm(ctx.cars.vel) / C.CAR_MAX_SPEED
    fn.__name__ = "SpeedReward"
    return fn


def wavedash_reward() -> RewardFn:
    """CommonRewards.h:107-119: landed while previously flipping."""
    def fn(ctx):
        r = (ctx.cars.is_on_ground & ctx.prev_cars.is_flipping
             & ~ctx.prev_cars.is_on_ground).to(torch.float32)
        return torch.where(ctx.has_prev[:, None], r, 0.0)
    fn.__name__ = "WavedashReward"
    return fn


def pickup_boost_reward() -> RewardFn:
    """CommonRewards.h:120-132: sqrt-difference of boost on pickup."""
    def fn(ctx):
        gained = ctx.cars.boost > ctx.prev_cars.boost
        r = torch.sqrt(ctx.cars.boost / 100.0) - torch.sqrt(
            ctx.prev_cars.boost / 100.0)
        return torch.where(ctx.has_prev[:, None] & gained, r, 0.0)
    fn.__name__ = "PickupBoostReward"
    return fn


def save_boost_reward(exponent: float = 0.5) -> RewardFn:
    def fn(ctx):
        return torch.clamp((ctx.cars.boost / 100.0) ** exponent, 0.0, 1.0)
    fn.__name__ = "SaveBoostReward"
    return fn


def air_reward() -> RewardFn:
    def fn(ctx):
        return (~ctx.cars.is_on_ground).to(torch.float32)
    fn.__name__ = "AirReward"
    return fn


def touch_accel_reward() -> RewardFn:
    """CommonRewards.h:153-178: reward for speeding the ball up, total 1.0
    from 0 to 110 kph."""
    max_speed = C.kph_to_vel(110)

    def fn(ctx):
        prev_frac = torch.clamp(m.norm(ctx.prev_ball.vel) / max_speed,
                                max=1.0)
        cur_frac = torch.clamp(m.norm(ctx.ball.vel) / max_speed, max=1.0)
        gain = torch.clamp(cur_frac - prev_frac, min=0.0)
        return torch.where(ctx.has_prev[:, None] & ctx.ball_touched_step,
                           _per_arena(gain, ctx), 0.0)
    fn.__name__ = "TouchAccelReward"
    return fn


def strong_touch_reward(min_kph: float = 20,
                        max_kph: float = 130) -> RewardFn:
    """CommonRewards.h:181-203."""
    min_vel, max_vel = C.kph_to_vel(min_kph), C.kph_to_vel(max_kph)

    def fn(ctx):
        hit_force = m.norm(ctx.ball.vel - ctx.prev_ball.vel)
        r = torch.where(hit_force < min_vel, 0.0,
                        torch.clamp(hit_force / max_vel, max=1.0))
        return torch.where(ctx.has_prev[:, None] & ctx.ball_touched_step,
                           _per_arena(r, ctx), 0.0)
    fn.__name__ = "StrongTouchReward"
    return fn


# --- wrappers --------------------------------------------------------------

def losing_penalty_reward(penalty_per_goal_behind: float = 0.01
                          ) -> RewardFn:
    """Continuous penalty for players whose team trails on the episode
    score, proportional to the deficit (LosingPenaltyReward,
    ExampleMain.cpp:86-124)."""
    def fn(ctx: RewardCtx) -> torch.Tensor:
        blue = ctx.blue_score.to(torch.float32)[:, None]
        orange = ctx.orange_score.to(torch.float32)[:, None]
        deficit = torch.where(ctx.teams[None, :] == 0, orange - blue,
                              blue - orange)
        return -penalty_per_goal_behind * torch.clamp(deficit, min=0.0)
    fn.__name__ = "LosingPenaltyReward"
    return fn


def zero_sum(child: RewardFn, team_spirit: float = 1.0,
             opponent_scale: float = 1.0) -> RewardFn:
    """ZeroSumReward (ZeroSumReward.cpp:18-48):
    own*(1-spirit) + avgTeam*spirit - avgOpp*scale."""
    def fn(ctx: RewardCtx) -> torch.Tensor:
        raw = child(ctx)
        blue = (ctx.teams == 0).to(torch.float32)
        orange = 1.0 - blue
        n_blue = torch.clamp(torch.sum(blue), min=1.0)
        n_orange = torch.clamp(torch.sum(orange), min=1.0)
        avg_blue = (torch.sum(raw * blue, dim=-1) / n_blue)[:, None]
        avg_orange = (torch.sum(raw * orange, dim=-1) / n_orange)[:, None]
        is_blue = ctx.teams[None, :] == 0
        avg_team = torch.where(is_blue, avg_blue, avg_orange)
        avg_opp = torch.where(is_blue, avg_orange, avg_blue)
        return (raw * (1.0 - team_spirit) + avg_team * team_spirit
                - avg_opp * opponent_scale)
    fn.__name__ = f"ZeroSum_{getattr(child, '__name__', 'child')}"
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
