"""Ball trajectory prediction, the BallPredTracker equivalent, batched
over balls.

The reference keeps a car-less internal arena and steps only the ball
forward ``numPredTicks`` to serve bots a lookahead trajectory
(Sim/BallPredTracker/BallPredTracker.{h,cpp}:1-80: ``UpdatePredFromArena``
re-simulates from the first changed tick, ``GetBallStateForTime`` samples
by delta time).  Here the predictor runs the ball-only subset of the
portable engine's tick (physics/step.arena_tick's ball path,
physics/contacts.resolve_ball_world), so a prediction is what the engine
would simulate with no car touching the ball.  Every field has a leading
ball axis ``(N, ...)``; one call predicts every ball's horizon.
"""

from __future__ import annotations

import dataclasses

import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.device import constant, tree_map
from reinforcement_learning_torch.physics import contacts
from reinforcement_learning_torch.physics import world as worldmod
from reinforcement_learning_torch.physics.state import BallState, MutatorConfig


def ball_only_tick(ball: BallState, mut: MutatorConfig,
                   game_mode: str = "soccar", use_mesh: bool = True,
                   dt: float = 1.0 / 120.0) -> BallState:
    """One physics tick of the balls with no cars (the ball's part of
    Arena::Step, Arena.cpp:716-812: sleep, gravity and drag, world
    contact, transform integration, clamps)."""
    dev = ball.pos.device
    grid = worldmod.get_grid(game_mode, dev) if use_mesh else None
    gravity = constant((0.0, 0.0, mut.gravity_z), dev)

    awake = ((m.norm(ball.vel) > 0) | (m.norm(ball.ang_vel) > 0))[..., None]
    ball_vel_pre = ball.vel
    drag = (1.0 - mut.ball_drag) ** dt
    ball = dataclasses.replace(ball, vel=torch.where(
        awake, (ball.vel + gravity * dt) * drag, ball.vel))

    puck_axis = ball.rot[..., :, 2] if game_mode == "snowday" else None
    bw_dv, bw_dw, bw_push, _, _ = contacts.resolve_ball_world(
        ball, mut, puck_axis, game_mode, vel_pre_uu=ball_vel_pre, grid=grid)
    ball = dataclasses.replace(ball, vel=ball.vel + bw_dv,
                               ang_vel=ball.ang_vel + bw_dw)

    awake = ((m.norm(ball.vel) > 0) | (m.norm(ball.ang_vel) > 0))[..., None]
    return dataclasses.replace(
        ball,
        pos=ball.pos + torch.where(awake, ball.vel * dt + bw_push, 0.0),
        rot=torch.where(awake[..., None],
                        m.integrate_rotation(ball.rot, ball.ang_vel, dt),
                        ball.rot),
        vel=m.clamp_norm(ball.vel, mut.ball_max_speed),
        ang_vel=m.clamp_norm(ball.ang_vel, C.BALL_MAX_ANG_SPEED))


def predict_ball(ball: BallState, mut: MutatorConfig, num_ticks: int,
                 game_mode: str = "soccar",
                 use_mesh: bool = True) -> BallState:
    """``num_ticks`` future states of every ball (BallPredTracker.cpp:62-69
    re-predict loop): a BallState whose fields have a tick axis after the
    ball axis, ``(N, T, ...)``; entry t is the state after t+1 ticks."""
    traj = []
    for _ in range(num_ticks):
        ball = ball_only_tick(ball, mut, game_mode, use_mesh)
        traj.append(ball)
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *traj)


class BallPredTracker:
    """The reference tracker's API (BallPredTracker.h:10-38), over a batch
    of balls."""

    def __init__(self, num_pred_ticks: int = 120,
                 mut: MutatorConfig | None = None,
                 game_mode: str = "soccar", use_mesh: bool = True):
        self.num_pred_ticks = num_pred_ticks
        self.mut = mut or MutatorConfig.for_mode(game_mode)
        self.game_mode = game_mode
        self.use_mesh = use_mesh
        self.pred: BallState | None = None

    def update(self, ball: BallState) -> BallState:
        """UpdatePredFromArena: refresh the whole horizon from the current
        ball states (N, ...).  Like the reference's ``predData``
        (BallPredTracker.cpp:37-60), entry 0 is the CURRENT state and
        entry t the state after t ticks: fields (N, num_pred_ticks,
        ...)."""
        traj = predict_ball(ball, self.mut, self.num_pred_ticks - 1,
                            self.game_mode, self.use_mesh)
        self.pred = tree_map(
            lambda cur, fut: torch.cat([cur[:, None], fut], dim=1),
            ball, traj)
        return self.pred

    def get_ball_state_for_time(self, delta_time: float) -> BallState:
        """GetBallStateForTime (BallPredTracker.cpp:71-79): floors
        ``predTime / tickTime`` into predData, so delta_time=0 returns the
        current state."""
        if self.pred is None:
            raise RuntimeError("call update() first")
        idx = int(delta_time * 120.0)
        idx = max(0, min(self.num_pred_ticks - 1, idx))
        return tree_map(lambda x: x[:, idx], self.pred)
