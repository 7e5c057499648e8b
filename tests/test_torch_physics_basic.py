"""tests/test_physics_basic.py's 12 behaviours on the port's portable
physics engine: resting car and ball, throttle, boost, jump, the ball's
bounce, gravity, steering, supersonic, a boost pad, a goal and wheel rays
on the ball and on a roof, as 12 arenas of ONE batched 240-tick rollout
at full fidelity (a module fixture), with the JAX tests' own bounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch import maths as tm
from reinforcement_learning_torch.physics import car as tcar
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.physics import world as tworld
from reinforcement_learning_torch.physics.state import BallState, CarsState

torch.set_num_threads(1)

N_TICKS = 240
BASIC = ("rest", "ball_rest", "throttle", "boost", "jump", "ball_bounce",
         "gravity", "steer", "supersonic", "pad", "goal", "wheel_rays")


def _ctrl(**kw):
    c = np.zeros(8, np.float32)
    idx = dict(throttle=0, steer=1, jump=5, boost=6)
    for k, v in kw.items():
        c[idx[k]] = v
    return c


@pytest.fixture(scope="module")
def basic_rollout():
    """One 240-tick rollout of 12 arenas of 2 cars at full fidelity: arena
    i sets up behaviour BASIC[i] for car 0 (car 1 parked on the ground
    away from the play), fixed controls.  Returns (per-tick trace dict,
    final state, the state after 90 ticks)."""
    n = len(BASIC)
    params = tstep.ArenaParams(num_cars=2)
    phys = tstep.make_physics_state(params, batch=(n,), device="cpu")
    cars, ball = phys.arena.cars, phys.arena.ball
    pos = np.tile(np.float32([[-1000.0, 0.0, TC.CAR_SPAWN_REST_Z],
                              [2000.0, 2000.0, 17.01]]), (n, 1, 1))
    vel = np.zeros((n, 2, 3), np.float32)
    ctl = np.zeros((n, 2, 8), np.float32)
    bpos = np.tile(np.float32([0.0, 0.0, TC.BALL_REST_Z]), (n, 1))
    bvel = np.zeros((n, 3), np.float32)
    boost = np.full((n, 2), TC.BOOST_SPAWN_AMOUNT, np.float32)
    on_ground = np.ones((n, 2), bool)
    i = BASIC.index
    ctl[i("throttle"), 0] = _ctrl(throttle=1)
    ctl[i("boost"), 0] = _ctrl(throttle=1, boost=1)
    ctl[i("jump"), 0] = _ctrl(jump=1)
    ctl[i("steer"), 0] = _ctrl(throttle=1, steer=1)
    ctl[i("supersonic"), 0] = _ctrl(throttle=1)
    bpos[i("ball_bounce")] = (0.0, 0.0, 1000.0)
    bvel[i("ball_bounce")] = (0.0, 0.0, -1.0)
    pos[i("gravity"), 0] = (0.0, 0.0, 1500.0)
    on_ground[i("gravity"), 0] = False
    vel[i("supersonic"), 0] = (2300.0, 0.0, 0.0)
    pos[i("pad"), 0] = (-3584.0, 0.0, TC.CAR_SPAWN_REST_Z)
    boost[i("pad"), 0] = 10.0
    bpos[i("goal")] = (0.0, 5000.0, 300.0)
    bvel[i("goal")] = (0.0, 2000.0, 0.0)
    ball_top = 93.15 + 91.25
    pos[i("wheel_rays"), 0] = (0.0, 0.0, ball_top + 40.0)
    cars.pos, cars.vel = torch.from_numpy(pos), torch.from_numpy(vel)
    cars.controls = torch.from_numpy(ctl)
    cars.boost = torch.from_numpy(boost)
    cars.is_on_ground = torch.from_numpy(on_ground)
    ball.pos, ball.vel = torch.from_numpy(bpos), torch.from_numpy(bvel)
    teams = (0, 1)
    gen = torch.Generator().manual_seed(0)
    trace = {k: [] for k in ("car_pos", "car_vel", "ball_pos", "ball_vel",
                             "on_ground")}
    at90 = None
    for t in range(N_TICKS):
        r = torch.randint(0, 4, (n, 2), generator=gen, dtype=torch.int32)
        phys = tstep.arena_tick(phys, teams, r, params)
        a = phys.arena
        for k, v in (("car_pos", a.cars.pos[:, 0]),
                     ("car_vel", a.cars.vel[:, 0]),
                     ("ball_pos", a.ball.pos), ("ball_vel", a.ball.vel),
                     ("on_ground", a.cars.is_on_ground[:, 0])):
            trace[k].append(v.numpy().copy())
        if t == 89:
            at90 = phys
    trace = {k: np.stack(v, 1) for k, v in trace.items()}   # (n, T, ...)
    return trace, phys, at90, params


def _arena(rollout, name):
    trace, phys, at90, params = rollout
    i = BASIC.index(name)
    return {k: v[i] for k, v in trace.items()}, phys, i


@pytest.mark.parametrize("name", BASIC)
def test_basic_behaviour(basic_rollout, name):
    """tests/test_physics_basic.py's behaviours, one per arena."""
    tr, phys, i = _arena(basic_rollout, name)
    cars, a = phys.arena.cars, phys.arena
    if name == "rest":
        assert bool(cars.is_on_ground[i, 0])
        z = float(cars.pos[i, 0, 2])
        assert 10.0 < z < 25.0, z
        assert float(cars.vel[i, 0].norm()) < 15.0
        assert abs(float(cars.pos[i, 0, 0]) + 1000.0) < 5.0
        assert abs(float(cars.pos[i, 0, 1])) < 5.0
    elif name == "ball_rest":
        np.testing.assert_allclose(a.ball.pos[i].numpy(),
                                   [0.0, 0.0, TC.BALL_REST_Z], atol=1e-5)
    elif name == "throttle":
        fwd_speed = float(tr["car_vel"][119] @ cars.rot[i, 0, :, 0].numpy())
        assert 400.0 < fwd_speed < 1410.0, fwd_speed
        vend = float(np.linalg.norm(tr["car_vel"][-1]))
        assert 1200.0 < vend < 1500.0, vend
        assert float(cars.pos[i, 0, 0]) > -500.0
    elif name == "boost":
        assert float(np.linalg.norm(tr["car_vel"][119])) > 900.0
        assert float(cars.boost[i, 0]) < 1.0
        vmax = np.max(np.linalg.norm(tr["car_vel"], axis=-1))
        assert vmax <= TC.CAR_MAX_SPEED + 1.0
    elif name == "jump":
        assert not tr["on_ground"][30]
        assert float(np.max(tr["car_pos"][:, 2])) > 100.0
        assert float(np.max(tr["car_vel"][:, 2])) > 250.0
    elif name == "ball_bounce":
        zs, vzs = tr["ball_pos"][:, 2], tr["ball_vel"][:, 2]
        assert float(np.min(zs)) > 80.0
        assert float(np.max(vzs)) > 200.0
        ratio = float(np.max(vzs)) / -float(np.min(vzs))
        assert 0.45 < ratio < 0.75, ratio
    elif name == "gravity":
        assert -80.0 < float(tr["car_vel"][11, 2]) < -50.0
    elif name == "steer":
        yaw, _, _ = tm.rotmat_to_euler(cars.rot[i, 0])
        assert abs(float(yaw)) > 0.5
    elif name == "supersonic":
        assert float(np.linalg.norm(tr["car_vel"][0])) > 2000.0
    elif name == "pad":
        assert float(cars.boost[i, 0]) == 100.0
        assert 7.0 < float(a.pads.cooldown[i, 0]) <= 10.0
    elif name == "goal":
        assert bool(a.goal_scored[i])
    elif name == "wheel_rays":
        _wheel_rays(basic_rollout, i)


def _wheel_rays(rollout, i):
    """A car dropped onto the resting ball stands on it with every wheel
    in non-world contact, and wheels over another car's roof report that
    car's index (Arena.cpp:733-750)."""
    _, _, at90, params = rollout
    a = at90.arena
    assert bool(a.cars.is_on_ground[i, 0])
    assert float(a.cars.pos[i, 0, 2]) > 150.0
    cfg, mut = params.car_config, params.mutators
    sel = lambda x: x[i:i + 1]  # noqa: E731
    cars = CarsState(**{f.name: sel(getattr(a.cars, f.name))
                        for f in dataclasses.fields(CarsState)})
    ball = BallState(**{f.name: sel(getattr(a.ball, f.name))
                        for f in dataclasses.fields(BallState)})
    inv_l = tcar.car_tables(cfg, mut.car_mass, torch.device("cpu"))[
        "inv_i_local"]
    iw = tcar.inv_inertia_world(cars.rot, inv_l)
    alive = torch.ones(1, 2, dtype=torch.bool)
    rc = tcar.wheel_raycasts(cars, cfg, mut, params.dt, iw, "soccar",
                             grid=tworld.get_grid("soccar", "cpu"),
                             ball=ball, alive=alive)
    assert (rc.ground_idx[0, 0] == -2).all()
    assert not rc.in_world_contact[0, 0].any()
    assert (rc.ground_idx[0, 1] == -1).all()
    roof_z = 17.01 + 36.16 + 12.0
    cars.pos = torch.tensor([[[2000.0, 2000.0, roof_z],
                              [2000.0, 2000.0, 17.01]]])
    cars.rot = torch.eye(3).expand(1, 2, 3, 3).clone()
    iw = tcar.inv_inertia_world(cars.rot, inv_l)
    rc = tcar.wheel_raycasts(cars, cfg, mut, params.dt, iw, "soccar",
                             grid=tworld.get_grid("soccar", "cpu"),
                             ball=ball, alive=alive)
    assert (rc.ground_idx[0, 0] == 1).all()
