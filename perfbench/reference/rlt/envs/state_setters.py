"""Episode-reset state setters (RLGymCPP/StateSetters/,
Arena::ResetToRandomKickoff, Arena.cpp:112-216), batched over envs.

A setter is ``fn(generator, params, teams, num_envs, device) ->
PhysicsState``.  Every draw comes from ``generator``; a caller can hand
in its own draws instead (the kickoff's ``order_fn``, ``side_fn`` and
``fuzz_fn``, ``random_state``'s ``draws_fn``, ``combined_state``'s
``pick_fn``), which is how the tests give the port the JAX package's.
"""

from __future__ import annotations

import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt import maths as m
from perfbench.reference.rlt.device import tree_map
from perfbench.reference.rlt.physics import step as stepmod


def spawn_table(game_mode: str):
    """(slot count, spawn table rows x, y, yaw) of the kickoff."""
    if game_mode == "heatseeker":
        return (C.CAR_SPAWN_LOCATION_AMOUNT_HEATSEEKER,
                C.CAR_SPAWN_LOCATIONS_HEATSEEKER)
    if game_mode == "hoops":
        return C.CAR_SPAWN_LOCATION_AMOUNT, C.CAR_SPAWN_LOCATIONS_HOOPS
    if game_mode in ("soccar", "snowday"):
        return C.CAR_SPAWN_LOCATION_AMOUNT, C.CAR_SPAWN_LOCATIONS_SOCCAR
    raise ValueError(f"no kickoff for game_mode={game_mode!r}")


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


def kickoff_state(fuzz: float = 0.0, order_fn=None, side_fn=None,
                  fuzz_fn=None):
    """KickoffState (StateSetters/KickoffState.h) in every game mode;
    with ``fuzz`` > 0 FuzzedKickoffState, each car's spawn position moved
    by U(-fuzz, fuzz) per axis.  ``order_fn(num_envs, generator, device)``
    draws the slot shuffles (default: uniform permutations from
    ``generator``); ``side_fn(num_envs, generator,
    device)`` the heatseeker ball's side ((N,) bool, True for +y; default:
    a fair coin per arena); ``fuzz_fn(num_envs, num_cars, generator,
    device)`` the (N, P, 3) position offsets."""
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
        if fuzz > 0:
            pos = pos + (fuzz_fn(num_envs, len(teams), generator, device)
                         if fuzz_fn else
                         torch.rand(num_envs, len(teams), 3,
                                    generator=generator, device=device)
                         * (2 * fuzz) - fuzz)
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
        elif mode == "hoops":
            # the hoops ball is thrown up at kickoff
            ball.vel = torch.zeros_like(ball.vel)
            ball.vel[:, 2] = C.BALL_HOOPS_Z_VEL
        return phys
    fn.__name__ = "KickoffState" if fuzz == 0 else "FuzzedKickoffState"
    return fn


RANDOM_STATE_BOUNDS = (3500.0, 4000.0, 1820.0, 150.0)   # x, y, z, car z


def random_state_draws(num_envs, num_cars, generator, device) -> dict:
    """The uniform draws of ``random_state`` (RandomState.cpp:11-62):
    ball position, direction, speed and spin; each car's position, yaw,
    pitch, roll, velocity direction and speed, spin direction, the
    on-ground coin and its boost."""
    X, Y, Z, CZ = RANDOM_STATE_BOUNDS
    N, P = num_envs, num_cars

    def u(shape, lo, hi):
        if isinstance(lo, tuple):      # per axis of a trailing 3
            return torch.stack([u(shape[:-1], a, b)
                                for a, b in zip(lo, hi)], dim=-1)
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)
    pi = torch.pi
    return dict(
        ball_pos=u((N, 3), (-X, -Y, 92.75), (X, Y, Z)),
        ball_dir=u((N, 3), -1.0, 1.0),
        ball_speed=u((N,), 0.0, 4000.0),
        ball_ang=u((N, 3), -4.0, 4.0),
        car_pos=u((N, P, 3), (-X, -Y, CZ), (X, Y, Z)),
        yaw=u((N, P), -pi, pi),
        pitch=u((N, P), -pi / 2, pi / 2),
        roll=u((N, P), -pi, pi),
        car_dir=u((N, P, 3), -1.0, 1.0),
        car_speed=u((N, P, 1), 0.0, C.CAR_MAX_SPEED),
        ang_dir=u((N, P, 3), -1.0, 1.0),
        ground=u((N, P), 0.0, 1.0),
        boost=u((N, P), 0.0, 100.0))


def random_state(cars_on_ground_only: bool = False,
                 rand_ball_speed: bool = True,
                 rand_car_speed: bool = True, draws_fn=None):
    """RandomState (RandomState.cpp:11-62): the ball and the cars anywhere
    in the field at random speeds, half the cars on the ground (all with
    ``cars_on_ground_only``).  ``draws_fn`` stands in for
    ``random_state_draws``."""
    def fn(generator, params, teams, num_envs, device):
        phys = stepmod.make_physics_state(params, batch=(num_envs,),
                                          device=device)
        n = len(teams)
        d = (draws_fn or random_state_draws)(num_envs, n, generator, device)
        ball = phys.arena.ball
        ball.pos = d["ball_pos"]
        if rand_ball_speed:
            ball.vel = m.normalize(d["ball_dir"]) * d["ball_speed"][:, None]
            ball.ang_vel = d["ball_ang"]
        cpos = d["car_pos"]
        yaw, pitch, roll = d["yaw"], d["pitch"], d["roll"]
        vel = torch.zeros(num_envs, n, 3, device=device)
        ang_vel = torch.zeros(num_envs, n, 3, device=device)
        if rand_car_speed:
            vel = m.normalize(d["car_dir"]) * d["car_speed"]
            ang_vel = m.normalize(d["ang_dir"]) * C.CAR_MAX_ANG_SPEED
        if cars_on_ground_only:
            on_ground = torch.ones(num_envs, n, dtype=torch.bool,
                                   device=device)
        else:
            on_ground = d["ground"] > 0.5
        cpos = torch.cat([cpos[..., :2], torch.where(
            on_ground, 17.0, cpos[..., 2])[..., None]], dim=-1)
        pitch = torch.where(on_ground, 0.0, pitch)
        roll = torch.where(on_ground, 0.0, roll)
        vel = torch.cat([vel[..., :2], torch.where(
            on_ground, 0.0, vel[..., 2])[..., None]], dim=-1)
        ang_vel = torch.where(on_ground[..., None], 0.0, ang_vel)
        cars = phys.arena.cars
        cars.pos = cpos
        cars.rot = m.euler_to_rotmat(yaw, pitch, roll)
        cars.vel, cars.ang_vel = vel, ang_vel
        cars.boost = d["boost"]
        cars.is_on_ground = on_ground
        return phys
    fn.__name__ = "RandomState"
    return fn


def combined_state(setters_and_weights, pick_fn=None):
    """CombinedState (CombinedState.h:10-49): each arena takes one child
    setter, chosen at random by weight.  Every child builds a state for
    every arena (from the same generator, in order) and each arena keeps
    its pick's.  ``pick_fn(num_envs, generator, device)`` stands in for
    the (N,) pick."""
    setters = [s for s, _ in setters_and_weights]
    weights = torch.tensor([float(w) for _, w in setters_and_weights])
    probs = weights / weights.sum()

    def fn(generator, params, teams, num_envs, device):
        if pick_fn is not None:
            idx = pick_fn(num_envs, generator, device)
        else:
            u = torch.rand(num_envs, generator=generator, device=device)
            edges = torch.cumsum(probs, 0).to(device)[:-1]
            idx = torch.searchsorted(edges, u, right=True)
        states = [s(generator, params, teams, num_envs, device)
                  for s in setters]

        def pick(*xs):
            out = xs[0]
            for i, x in enumerate(xs[1:], 1):
                sel = (idx == i).reshape((-1,) + (1,) * (x.dim() - 1))
                out = torch.where(sel, x, out)
            return out
        return tree_map(pick, *states)
    fn.__name__ = "CombinedState"
    return fn
