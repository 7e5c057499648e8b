"""Terminal conditions (RLGymCPP/TerminalConditions/), batched over envs.

A condition maps a context with ``(N,)`` fields to an ``(N,)`` int32
``TerminalType``: NOT / NORMAL / TRUNCATED (TerminalCondition.h:6-22);
NORMAL wins over TRUNCATED when both fire (EnvSet.cpp:166-180).
"""

from __future__ import annotations

import torch

NOT_TERMINAL = 0
NORMAL = 1
TRUNCATED = 2


def _select(cond, value):
    return torch.where(cond, value, NOT_TERMINAL).to(torch.int32)


def goal_score_condition():
    """Terminal when a goal was scored this step (GoalScoreCondition.h)."""
    def fn(ctx):
        return _select(ctx.goal_scored, NORMAL)
    fn.__name__ = "GoalScoreCondition"
    return fn


def no_touch_condition(timeout_seconds: float, step_seconds: float):
    """Truncation after no player touched the ball for ``timeout_seconds``
    (NoTouchCondition.h:5-33)."""
    limit = int(round(timeout_seconds / step_seconds))

    def fn(ctx):
        return _select(ctx.steps_since_touch >= limit, TRUNCATED)
    fn.__name__ = "NoTouchCondition"
    return fn


def timeout_condition(timeout_seconds: float, step_seconds: float):
    """Truncation after a fixed episode length."""
    limit = int(round(timeout_seconds / step_seconds))

    def fn(ctx):
        return _select(ctx.steps_since_reset >= limit, TRUNCATED)
    fn.__name__ = "TimeoutCondition"
    return fn


def score_limit_condition(limit_goals: int):
    """Terminal when either team reaches ``limit_goals`` this episode
    (ScoreLimitCondition, ExampleMain.cpp:46-82), from the env's episode
    score counters, which count every goal step as the reference's do."""
    def fn(ctx):
        return _select((ctx.blue_score >= limit_goals)
                       | (ctx.orange_score >= limit_goals), NORMAL)
    fn.__name__ = "ScoreLimitCondition"
    return fn


def combine_conditions(conds):
    """EnvSet.cpp:166-180: NOT < TRUNCATED < NORMAL precedence."""
    def fn(ctx):
        result = None
        for cond in conds:
            cur = cond(ctx)
            if result is None:
                result = torch.zeros_like(cur)
            result = torch.where(cur == NORMAL, NORMAL,
                                 torch.where(result == NOT_TERMINAL, cur,
                                             result))
        return result.to(torch.int32)
    return fn
