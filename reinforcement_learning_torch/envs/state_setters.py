"""Episode-reset state setters (RLGymCPP/StateSetters/,
Arena::ResetToRandomKickoff, Arena.cpp:112-216), batched over envs.

A setter is ``fn(generator, params, teams, num_envs, device) ->
PhysicsState``.  The kickoff's only randomness is the shuffle of the spawn
slots, drawn from ``generator``; ``kickoff_positions`` takes that shuffle
as a tensor so a caller can hand in its own.
"""

from __future__ import annotations

import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.physics import step as stepmod


def kickoff_positions(order: torch.Tensor, teams: torch.Tensor):
    """Car kickoff placement (Arena.cpp:112-193), soccar: the i-th car of
    each team takes shuffled slot ``order[:, i]``, mirrored for orange.
    ``order``: (N, slots) permutations; ``teams``: (P,).  Returns
    (pos (N, P, 3), yaw (N, P))."""
    n_slots = C.CAR_SPAWN_LOCATION_AMOUNT
    table = torch.as_tensor(C.CAR_SPAWN_LOCATIONS_SOCCAR,
                            dtype=torch.float32, device=order.device)
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


def kickoff_state(order_fn=None):
    """KickoffState (StateSetters/KickoffState.h), soccar.  ``order_fn(
    num_envs, generator, device)`` draws the slot shuffles; the default
    draws uniform permutations from ``generator``."""
    def draw(num_envs, generator, device):
        u = torch.rand(num_envs, C.CAR_SPAWN_LOCATION_AMOUNT,
                       generator=generator, device=device)
        return torch.argsort(u, dim=-1)

    order_fn = order_fn or draw

    def fn(generator, params, teams, num_envs, device):
        if params.game_mode != "soccar":
            raise NotImplementedError(
                f"kickoff for game_mode={params.game_mode!r} is not ported")
        phys = stepmod.make_physics_state(params, batch=(num_envs,),
                                          device=device)
        pos, yaw = kickoff_positions(order_fn(num_envs, generator, device),
                                     teams)
        cars = phys.arena.cars
        cars.pos = pos
        cars.rot = m.euler_to_rotmat(yaw)
        cars.boost = torch.full_like(cars.boost,
                                     params.mutators.car_spawn_boost_amount)
        return phys
    fn.__name__ = "KickoffState"
    return fn
