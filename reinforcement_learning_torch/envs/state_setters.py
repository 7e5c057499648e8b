"""Episode-reset state setters (RLGymCPP/StateSetters/,
Arena::ResetToRandomKickoff, Arena.cpp:112-216), batched over envs.

A setter is ``fn(generator, params, teams, num_envs, device) ->
PhysicsState``.  The kickoff's randomness is the shuffle of the spawn
slots and, in heatseeker, the side the ball starts on, both drawn from
``generator``; a caller can hand in its own draws (``order_fn``,
``side_fn``).
"""

from __future__ import annotations

import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.physics import step as stepmod


def spawn_table(game_mode: str):
    """(slot count, spawn table rows x, y, yaw) of the kickoff."""
    if game_mode == "heatseeker":
        return (C.CAR_SPAWN_LOCATION_AMOUNT_HEATSEEKER,
                C.CAR_SPAWN_LOCATIONS_HEATSEEKER)
    if game_mode in ("soccar", "snowday"):
        return C.CAR_SPAWN_LOCATION_AMOUNT, C.CAR_SPAWN_LOCATIONS_SOCCAR
    raise NotImplementedError(
        f"kickoff for game_mode={game_mode!r} is not ported")


def kickoff_positions(order: torch.Tensor, teams: torch.Tensor,
                      game_mode: str = "soccar"):
    """Car kickoff placement (Arena.cpp:112-193): the i-th car of each
    team takes shuffled slot ``order[:, i]``, mirrored for orange.
    ``order``: (N, slots) permutations; ``teams``: (P,).  Returns
    (pos (N, P, 3), yaw (N, P))."""
    n_slots, rows = spawn_table(game_mode)
    table = torch.as_tensor(rows, dtype=torch.float32, device=order.device)
    blue = teams == 0
    rank = torch.where(blue, torch.cumsum(blue.to(torch.int64), 0),
                       torch.cumsum((~blue).to(torch.int64), 0)) - 1
    rank = torch.clamp(rank, max=n_slots - 1)
    slot = order[:, rank]                                   # (N, P)
    spawn = table[slot]                                     # (N, P, 3)
    sign = torch.where(blue, 1.0, -1.0)
    pos = torch.stack([spawn[..., 0] * sign, spawn[..., 1] * sign,
                       torch.full_like(spawn[..., 0], C.CAR_SPAWN_REST_Z)],
                      dim=-1)
    yaw = spawn[..., 2] + torch.where(blue, 0.0, torch.pi)
    return pos, yaw


def kickoff_state(order_fn=None, side_fn=None):
    """KickoffState (StateSetters/KickoffState.h) in soccar, heatseeker
    and snowday.  ``order_fn(num_envs, generator, device)`` draws the slot
    shuffles (default: uniform permutations from ``generator``);
    ``side_fn(num_envs, generator, device)`` the heatseeker ball's side
    ((N,) bool, True for +y; default: a fair coin per arena)."""
    def fn(generator, params, teams, num_envs, device):
        mode = params.game_mode
        n_slots, _ = spawn_table(mode)
        phys = stepmod.make_physics_state(params, batch=(num_envs,),
                                          device=device)
        if order_fn is None:
            order = torch.argsort(torch.rand(
                num_envs, n_slots, generator=generator, device=device),
                dim=-1)
        else:
            order = order_fn(num_envs, generator, device)
        pos, yaw = kickoff_positions(order, teams, mode)
        cars = phys.arena.cars
        cars.pos = pos
        cars.rot = m.euler_to_rotmat(yaw)
        cars.boost = torch.full_like(cars.boost,
                                     params.mutators.car_spawn_boost_amount)
        ball = phys.arena.ball
        # the mode's kickoff ball (Arena.cpp:196-208)
        if mode == "heatseeker":
            plus = (side_fn(num_envs, generator, device) if side_fn
                    else torch.rand(num_envs, generator=generator,
                                    device=device) < 0.5)
            scale = torch.ones(num_envs, 3, device=device)
            scale[:, 1] = torch.where(plus, 1.0, -1.0)
            ball.pos = torch.tensor(C.Heatseeker.BALL_START_POS,
                                    device=device) * scale
            ball.vel = torch.tensor(C.Heatseeker.BALL_START_VEL,
                                    device=device) * scale
        elif mode == "snowday":
            # FLT_EPSILON of upward speed keeps the puck awake
            ball.vel = torch.zeros_like(ball.vel)
            ball.vel[:, 2] = 1.19e-7
        return phys
    fn.__name__ = "KickoffState"
    return fn
