"""The port's plain physics step (reinforcement_learning_torch/ops/ctick)
against the JAX megakernel body ``ops/ctick.step``, in plane mode and at
full fidelity (the facet arena and dynamic wheel rays).

``ctick.step`` is far too slow for a unit test on XLA:CPU (the plane tick
jitted takes minutes to compile; the mesh tick more than ten, or some 150 s
per env step run eagerly), so its outputs for fixed scenarios are stored:

* ``tests/data/torch_physics_golden.npz``, plane mode: the scenarios of
  ``tests/test_ctick.py`` (ground, airborne, multi-step, demo/respawn) plus
  two cars overlapping (car-car bump and demo) and a car driving into the
  ball;
* ``tests/data/torch_physics_mesh_golden.npz``, full fidelity, made
  eagerly (``jax.disable_jit``): midfield ground and airborne cars; the
  ball into the floor and ceiling fillets, a corner and the goal mouth
  while cars drive up a side wall and a fillet; a car dropped on the ball
  and a car dropped on another car's roof; and one step of the port's
  default 2v2 env from its kickoff.

Inputs are made by numpy from fixed seeds.  Regenerate the files with

    python -m tests.test_torch_physics [plane] [mesh]

(both without arguments; E=8 arenas x 4 cars).  Each file stores a hash
of the JAX sources it came from, and the tests fail once they change.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from reinforcement_learning_torch.ops import arena_step as arena_step_mod
from reinforcement_learning_torch.ops import ctick as tctick
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.utils import tracing

torch.set_num_threads(1)

E, CARS = 8, 4
TEAMS = (0, 0, 1, 1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "torch_physics_golden.npz")
MESH_GOLDEN = os.path.join(DATA, "torch_physics_mesh_golden.npz")
# The JAX modules ``ctick.step`` runs in plane mode; the golden file stores
# their hash, so a change to the reference fails the test until the file is
# regenerated.
REFERENCE_SOURCES = (
    "constants.py", "maths.py", "ops/ctick.py", "ops/cvec.py", "ops/pack.py",
    "physics/arena_geom.py", "physics/box_box.py", "physics/car.py",
    "physics/formulas.py", "physics/state.py", "physics/step.py")
# ... and at full fidelity
MESH_REFERENCE_SOURCES = REFERENCE_SOURCES + ("physics/facet_arena.py",
                                              "physics/mesh.py")


def reference_hash(sources=REFERENCE_SOURCES) -> str:
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reinforcement_learning_tpu")
    h = hashlib.sha256()
    for rel in sources:
        h.update(rel.encode())
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _rotmat(yaw, pitch, roll):
    """maths.euler_to_rotmat in numpy (float32 result)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(-pitch), np.sin(-pitch)
    cr, sr = np.cos(-roll), np.sin(-roll)
    rows = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]
    return np.stack([np.stack(r, -1) for r in rows], -2).astype(np.float32)


def random_overrides(seed: int, airborne: bool) -> dict:
    """Field overrides (dotted names) on the default batched state: cars
    spread over a grid (no contacts between them), random ball."""
    rng = np.random.RandomState(seed)
    grid = np.array([[-2000., -2000.], [2000., -2000.],
                     [-2000., 2000.], [2000., 2000.]], np.float32)
    xy = grid[None] + rng.uniform(-300, 300, (E, CARS, 2))
    if airborne:
        z = rng.uniform(200, 900, (E, CARS))
        vel = rng.uniform(-800, 800, (E, CARS, 3))
        ang_vel = rng.uniform(-3, 3, (E, CARS, 3))
        pitch = rng.uniform(-1.2, 1.2, (E, CARS))
        roll = rng.uniform(-3.0, 3.0, (E, CARS))
    else:
        z = np.full((E, CARS), 17.0)
        vel = np.concatenate([rng.uniform(-700, 700, (E, CARS, 2)),
                              np.zeros((E, CARS, 1))], -1)
        ang_vel = np.zeros((E, CARS, 3))
        pitch = roll = np.zeros((E, CARS))
    yaw = rng.uniform(-3.1, 3.1, (E, CARS))
    ball_pos = np.stack([rng.uniform(-3000, 3000, E),
                         rng.uniform(-4000, 4000, E),
                         rng.uniform(93.15, 1500, E)], -1)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "arena.cars.pos": f(np.concatenate([xy, z[..., None]], -1)),
        "arena.cars.vel": f(vel), "arena.cars.ang_vel": f(ang_vel),
        "arena.cars.rot": _rotmat(yaw, pitch, roll),
        "arena.cars.boost": f(rng.uniform(0, 100, (E, CARS))),
        "arena.ball.pos": f(ball_pos),
        "arena.ball.vel": f(rng.uniform(-1200, 1200, (E, 3))),
        "arena.ball.ang_vel": f(rng.uniform(-4, 4, (E, 3))),
    }


def random_controls(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    analog = rng.uniform(-1, 1, (E, CARS, 5))
    buttons = (rng.uniform(0, 1, (E, CARS, 3)) > 0.5)
    return np.concatenate([analog, buttons], -1).astype(np.float32)


def scenarios() -> dict:
    """name -> (overrides, [controls per env step], respawn_idx (E, C))."""
    zero_r = np.zeros((E, CARS), np.int32)
    out = {
        "ground": (random_overrides(7, False), [random_controls(3)], zero_r),
        "airborne": (random_overrides(42, True), [random_controls(3)],
                     zero_r),
        "multi_step": (random_overrides(5, False),
                       [random_controls(100 + i) for i in range(4)], zero_r),
    }
    # demo / respawn: car 0 demoed, frozen (2 s left) or expiring (1 tick)
    for name, timer in (("demo_frozen", 2.0), ("demo_respawn", 1 / 120.0)):
        ov = random_overrides(11, False)
        demoed = np.zeros((E, CARS), bool)
        demoed[:, 0] = True
        t = np.zeros((E, CARS), np.float32)
        t[:, 0] = timer
        ov["arena.cars.is_demoed"] = demoed
        ov["arena.cars.demo_respawn_timer"] = t
        ctl = random_controls(12)
        ctl[:, 0] = 0.0
        out[name] = (ov, [ctl], np.full((E, CARS), 2, np.int32))
    # two opposing cars meeting nearly head-on, hitboxes a few uu into each
    # other: a bump, and a demo where the attacker is supersonic (even
    # envs).  Yaw and sideways speed keep the pair off the exact symmetry
    # where the friction direction hangs on a 1.49e-8 threshold, and the
    # shallow overlap keeps the pushout solver well conditioned.
    rng = np.random.RandomState(13)
    ov = random_overrides(13, False)
    pos, vel, rot = (ov[f"arena.cars.{n}"].copy()
                     for n in ("pos", "vel", "rot"))
    sup = np.zeros((E, CARS), bool)
    for e in range(E):
        x0, y0 = rng.uniform(-500, 500), rng.uniform(-500, 500)
        yaw0 = rng.uniform(-0.15, 0.15)
        yaw2 = np.pi + rng.uniform(-0.15, 0.15)
        speed = 2250.0 if e % 2 == 0 else 900.0
        pos[e, 0] = (x0, y0, 17.0)
        pos[e, 2] = (x0 + 140.0 + 0.5 * e, y0 + rng.uniform(-20, 20), 17.0)
        vel[e, 0] = (speed * np.cos(yaw0), speed * np.sin(yaw0), 0.0)
        vel[e, 2] = (-300.0, rng.uniform(-100, 100), 0.0)
        rot[e, 0] = _rotmat(yaw0, 0.0, 0.0)
        rot[e, 2] = _rotmat(yaw2, 0.0, 0.0)
        sup[e, 0] = e % 2 == 0
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.cars.is_supersonic": sup})
    ctl = np.zeros((E, CARS, 8), np.float32)
    ctl[:, 0, 0] = 1.0
    out["car_car"] = (ov, [ctl], zero_r)
    # car 0 drives into the resting ball
    ov = random_overrides(17, False)
    pos, vel, rot = (ov[f"arena.cars.{n}"].copy()
                     for n in ("pos", "vel", "rot"))
    bpos = np.zeros((E, 3), np.float32)
    for e in range(E):
        bx, by = 400.0 * (e - 4), 300.0
        bpos[e] = (bx, by, 93.15)
        pos[e, 0] = (bx - 150.0 + 4.0 * e, by + 5.0 * (e - 4), 17.0)
        vel[e, 0] = (800.0 + 100.0 * e, 0.0, 0.0)
        rot[e, 0] = np.eye(3, dtype=np.float32)
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.ball.pos": bpos,
               "arena.ball.vel": np.zeros((E, 3), np.float32),
               "arena.ball.ang_vel": np.zeros((E, 3), np.float32)})
    out["car_ball"] = (ov, [ctl, ctl], zero_r)
    return out


def _yaw_pitch(yaw, pitch):
    return _rotmat(np.float32(yaw), np.float32(pitch), np.float32(0.0))


def mesh_scenarios() -> dict:
    """Full-fidelity scenarios: name -> (overrides, [controls per env
    step], respawn_idx (E, C)).  Different arenas of one batch hold
    different situations."""
    zero_r = np.zeros((E, CARS), np.int32)
    still = np.zeros((E, CARS, 8), np.float32)
    out = {}
    # midfield: arenas 0-3 on the ground, 4-7 in the air
    ground, air = random_overrides(22, False), random_overrides(21, True)
    out["mesh_open"] = ({k: np.concatenate([ground[k][:4], air[k][4:]])
                         for k in ground}, [random_controls(23)], zero_r)

    # the ball into the x+ floor fillet (0-1), the goal's back net and
    # crossbar (2-3), the x+y+ corner (4-5), the ceiling fillet (6-7);
    # car 0 drives up the x+ side wall, car 1 up the x- floor fillet, car 2
    # falls upside down onto the floor, car 3 drives nose first into the
    # x-y+ corner wall (even arenas) or the back wall beside a goal post
    ov = random_overrides(31, False)
    bpos = np.array([[3972, 0, 124], [3972, 700, 124],
                     [150, 5850, 300], [-40, 5060, 700],
                     [3850, 4060, 400], [-3850, -4060, 250],
                     [3939, 1000, 1891], [-3939, -1200, 1891]], np.float32)
    bvel = np.array([[900, 0, -300], [900, 50, -300],
                     [0, 1500, -100], [0, 1000, 0],
                     [800, 800, 0], [-800, -800, 100],
                     [600, 0, 600], [-600, 0, 600]], np.float32)
    pos, vel, rot = (ov[f"arena.cars.{n}"].copy()
                     for n in ("pos", "vel", "rot"))
    rng = np.random.RandomState(32)
    on_wall = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
    for e in range(E):
        pos[e, 0] = (4096.0 - 17.0, rng.uniform(-2500, 2500),
                     rng.uniform(450, 900))
        vel[e, 0] = (0.0, rng.uniform(-200, 200), rng.uniform(200, 600))
        rot[e, 0] = on_wall
        pos[e, 1] = (-4096.0 + 95.0, rng.uniform(-2500, 2500), 75.0)
        vel[e, 1] = (-600.0, 0.0, 300.0)
        rot[e, 1] = _yaw_pitch(np.pi + rng.uniform(-0.2, 0.2), 0.8)
        pos[e, 2] = (rng.uniform(-1500, 1500), rng.uniform(-1500, 1500),
                     45.0)
        vel[e, 2] = (rng.uniform(-300, 300), 0.0, -300.0)
        rot[e, 2] = _rotmat(np.float32(rng.uniform(-3, 3)), np.float32(0.1),
                            np.float32(np.pi - 0.2))
        if e % 2 == 0:
            yaw = 0.75 * np.pi + rng.uniform(-0.1, 0.1)
            pos[e, 3] = (-3300.0, 4651.0, 17.0)
        else:
            yaw = -0.5 * np.pi + rng.uniform(-0.1, 0.1)
            pos[e, 3] = (-1000.0 + 60.0 * e, -5120.0 + 80.0, 17.0)
        vel[e, 3] = (1500.0 * np.cos(yaw), 1500.0 * np.sin(yaw), 0.0)
        rot[e, 3] = _yaw_pitch(yaw, 0.0)
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.ball.pos": bpos,
               "arena.ball.vel": bvel,
               "arena.ball.ang_vel": np.zeros((E, 3), np.float32)})
    ctl = still.copy()
    ctl[:, [0, 1, 3], 0] = 1.0
    out["mesh_walls"] = (ov, [ctl, ctl], zero_r)

    # dynamic wheel rays: car 0 dropped on the resting ball (0-3), car 1
    # dropped on car 0's roof (4-7)
    ov = random_overrides(51, False)
    pos, vel, rot, ang = (ov[f"arena.cars.{n}"].copy()
                          for n in ("pos", "vel", "rot", "ang_vel"))
    bpos = ov["arena.ball.pos"].copy()
    bvel = ov["arena.ball.vel"].copy()
    for e in range(E):
        x0, y0 = 700.0 + 60.0 * e, -300.0 + 90.0 * e
        if e < 4:
            bpos[e] = (x0, y0, 93.15)
            bvel[e] = 0.0
            pos[e, 0] = (x0 + 3.0 * e, y0 - 2.0 * e, 93.15 + 91.25 + 22.0)
            rot[e, 0] = np.eye(3, dtype=np.float32)
        else:
            pos[e, 0] = (x0, y0, 17.0)
            rot[e, 0] = _yaw_pitch(0.1 * e, 0.0)
            pos[e, 1] = (x0 + 8.0, y0 + 4.0, 80.0)
            rot[e, 1] = _yaw_pitch(0.1 * e + 0.3, 0.0)
            vel[e, 1] = 0.0
            ang[e, 1] = 0.0
        vel[e, 0] = 0.0
        ang[e, 0] = 0.0
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.cars.ang_vel": ang,
               "arena.ball.pos": bpos, "arena.ball.vel": bvel})
    ov["arena.ball.ang_vel"] = np.where(np.arange(E)[:, None] < 4, 0.0,
                                        ov["arena.ball.ang_vel"]
                                        ).astype(np.float32)
    out["mesh_dynamic"] = (ov, [still, still], zero_r)
    return out


ENV_SEED = 5


def default_env():
    """The port's env with the default config (full fidelity), E arenas
    of 2v2 on the CPU."""
    from reinforcement_learning_torch.envs import env as tenv
    return tenv.RocketLeagueEnv(tenv.EnvConfig(num_envs=E, team_size=2,
                                               device="cpu"))


def default_env_case():
    """One step of the default env from its kickoff: (start state, action
    indices (E, C), controls (E, C, 8))."""
    env = default_env()
    state, _, _ = env.reset(ENV_SEED)
    actions = np.random.RandomState(ENV_SEED).randint(
        0, env.num_actions, (E, CARS))
    controls = env.action_parser.parse(torch.from_numpy(actions)).numpy()
    return state, actions, controls


def flatten(obj, prefix="") -> dict:
    """Dataclass tree -> {dotted field name: numpy array}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_runner(mesh: bool):
    """(step function, default batched state) of the JAX ``ctick.step``:
    plane mode jitted, full fidelity eager."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from reinforcement_learning_tpu.ops import ctick
    from reinforcement_learning_tpu.physics import step as stepmod

    params = stepmod.ArenaParams(num_cars=CARS, use_mesh=mesh,
                                 dynamic_wheel_rays=mesh)
    k = ctick.make_consts(params, np.asarray(TEAMS))
    if mesh:
        def run(d, nc, r):
            with jax.disable_jit():
                return ctick.step(k, d, nc, r, 8, 7)
    else:
        run = jax.jit(lambda d, nc, r: ctick.step(k, d, nc, r, 8, 7))
    base = jax.vmap(lambda _: stepmod.make_physics_state(params))(
        jnp.arange(E))
    return run, base


def _run_jax(mesh: bool, name: str, ov: dict, controls, ridx) -> dict:
    """The JAX ``ctick.step`` trace of one scenario: {key: array}."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.ops import pack
    run, base = _jax_runner(mesh)

    def build(obj, leaves, prefix=""):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = prefix + f.name
            kw[f.name] = (build(v, leaves, name + ".")
                          if dataclasses.is_dataclass(v)
                          else jnp.asarray(leaves[name]))
        return type(obj)(**kw)

    data = {}
    phys = build(base, {**flatten(base), **ov})
    for n, a in flatten(phys).items():
        data[f"{name}/in/{n}"] = a
    for t, ctl in enumerate(controls):
        nc = tuple(jnp.asarray(ctl[..., c].T) for c in range(8))
        out = run(pack.to_components(phys), nc, jnp.asarray(ridx.T))
        phys = pack.from_components(out, E)
        for n, a in flatten(phys).items():
            data[f"{name}/out/{t}/{n}"] = np.asarray(a)
    print(name, "done", flush=True)
    return data


def _default_env_scenario():
    state, actions, controls = default_env_case()
    ov = {k: v.numpy() for k, v in flatten_torch(state.phys).items()}
    return ov, [controls], np.zeros((E, CARS), np.int32), actions


def flatten_torch(obj, prefix="") -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(flatten_torch(v, name + "."))
        else:
            out[name] = v
    return out


def regenerate(which=("plane", "mesh")):
    """Run the JAX ``ctick.step`` on every scenario and store the traces;
    the full-fidelity scenarios run eagerly, one process each."""
    import concurrent.futures
    import multiprocessing
    os.makedirs(DATA, exist_ok=True)
    if "plane" in which:
        data = {"reference_sha256": np.array(reference_hash())}
        for name, (ov, controls, ridx) in scenarios().items():
            data.update(_run_jax(False, name, ov, controls, ridx))
        np.savez_compressed(GOLDEN, **data)
        print("wrote", GOLDEN)
    if "mesh" in which:
        cases = dict(mesh_scenarios())
        ov, controls, ridx, actions = _default_env_scenario()
        cases["default_env"] = (ov, controls, ridx)
        data = {"reference_sha256": np.array(
            reference_hash(MESH_REFERENCE_SOURCES)),
            "default_env/actions": actions}
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                len(cases), mp_context=ctx) as pool:
            futs = [pool.submit(_run_jax, True, name, *case)
                    for name, case in cases.items()]
            for f in futs:
                data.update(f.result())
        np.savez_compressed(MESH_GOLDEN, **data)
        print("wrote", MESH_GOLDEN)


# ---------------------------------------------------------------------------
# the tests


def _params():
    return tstep.ArenaParams(num_cars=CARS, use_mesh=False,
                             dynamic_wheel_rays=False)


def _from_flat(flat: dict) -> tstep.PhysicsState:
    base = tstep.make_physics_state(_params(), batch=(E,), device="cpu")

    def build(obj, prefix=""):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = prefix + f.name
            kw[f.name] = (build(v, name + ".") if dataclasses.is_dataclass(v)
                          else torch.from_numpy(np.array(flat[name])))
        return type(obj)(**kw)
    return build(base)


def assert_state_close(got: dict, want: dict, where: str):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w.dtype.kind in "biu":
            bad = np.argwhere(g != w)
            assert bad.size == 0, f"{where} {name}: differs at {bad[:5]}"
        else:
            atol, rtol = tctick.TOLERANCES.get(name,
                                               tctick.DEFAULT_TOLERANCE)
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                       err_msg=f"{where} {name}")


def _load_golden(path, sources):
    data = np.load(path)
    assert str(data["reference_sha256"]) == reference_hash(sources), (
        "the JAX reference sources changed since the golden traces were "
        "made: regenerate them with python -m tests.test_torch_physics")
    return data


@pytest.fixture(scope="module")
def golden():
    return _load_golden(GOLDEN, REFERENCE_SOURCES)


@pytest.fixture(scope="module")
def mesh_golden():
    return _load_golden(MESH_GOLDEN, MESH_REFERENCE_SOURCES)


def _stored(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _follow_trace(data, name, ov, controls, ridx, params):
    """Step the plain version through ``arena_step`` on CPU tensors along
    the stored trace of scenario ``name``, checking every step."""
    flat = _stored(data, f"{name}/in/")
    for field, value in ov.items():    # the stored inputs are these
        np.testing.assert_array_equal(flat[field], value, err_msg=field)
    phys = _from_flat(flat)
    for t, ctl in enumerate(controls):
        phys = arena_step_mod.arena_step(
            phys, torch.from_numpy(ctl), torch.from_numpy(ridx), params,
            TEAMS)
        assert_state_close(flatten(phys), _stored(data, f"{name}/out/{t}/"),
                           f"{name} step {t}")
    return phys


@pytest.mark.parametrize("name", list(scenarios()))
def test_plain_step_matches_jax_ctick(golden, name):
    """The plain version follows the JAX ``ctick.step`` trace of the
    scenario step by step (plane mode)."""
    _follow_trace(golden, name, *scenarios()[name], _params())


@pytest.mark.parametrize("name", list(mesh_scenarios()))
def test_full_fidelity_step_matches_jax_ctick(mesh_golden, name):
    """The plain version at full fidelity (``use_mesh``,
    ``dynamic_wheel_rays``) follows the JAX ``ctick.step`` trace."""
    _follow_trace(mesh_golden, name, *mesh_scenarios()[name],
                  tstep.ArenaParams(num_cars=CARS))


def test_full_fidelity_scenarios_drive_their_contacts(mesh_golden):
    """Each scenario reaches the contact it is there for: the ball bounces
    off the fillets, corner, net and crossbar, cars touch the wall, the
    floor and the corner, wheels stand on the ball and on a car roof."""
    out = _stored(mesh_golden, "mesh_walls/out/1/")
    vin = mesh_golden["mesh_walls/in/arena.ball.vel"]
    vout = out["arena.ball.vel"]
    assert (vout[[0, 1], 2] > 0).all()                 # floor fillet
    assert (vout[[6, 7], 2] < 0).all()                 # ceiling fillet
    assert (vout[[2, 3], 1] * vin[[2, 3], 1] < 0).all()  # net, crossbar
    assert (np.sign(vout[[4, 5, 6, 7], 0])
            != np.sign(vin[[4, 5, 6, 7], 0])).all()    # corner, fillet
    wc = out["arena.cars.wheels_with_contact"]
    assert wc[:, 0].all() and wc[:, 1].all()           # wall, fillet
    contact = (_stored(mesh_golden, "mesh_walls/out/0/")[
        "arena.cars.has_world_contact"] | out["arena.cars.has_world_contact"])
    assert contact[:, 2].all() and contact[::2, 3].all()  # floor, corner
    dyn = _stored(mesh_golden, "mesh_dynamic/out/1/")
    assert dyn["arena.cars.wheels_with_contact"][:4, 0].any(-1).all()
    assert dyn["arena.cars.wheels_with_contact"][4:, 1].all()
    # the resting balls under car 0 did not move: the wheels stand on them
    assert dyn["arena.cars.pos"][:4, 0, 2].min() > 150.0


def test_default_env_steps_at_full_fidelity(mesh_golden):
    """The port's env with the default config (no arena override: the
    facet arena and dynamic wheel rays) steps on the CPU, and its physics
    after one step from the stored kickoff state equals the JAX
    ``ctick.step`` trace for the same state and controls."""
    env = default_env()
    assert env.params.use_mesh and env.params.dynamic_wheel_rays
    state, _, _ = env.reset(ENV_SEED)
    state.phys = _from_flat(_stored(mesh_golden, "default_env/in/"))
    actions = torch.from_numpy(mesh_golden["default_env/actions"])
    state, out = env.step(state, actions)
    assert not out.terminal_type.any()
    assert_state_close(flatten(state.phys),
                       _stored(mesh_golden, "default_env/out/0/"),
                       "default env step")


def test_scenarios_drive_demo_bump_and_ball_touch(golden):
    assert golden["car_car/out/0/arena.step_demo"].any()
    assert golden["car_car/out/0/arena.step_bump"].any()
    assert golden["car_car/out/0/arena.cars.is_demoed"].any()
    assert not golden["demo_respawn/out/0/arena.cars.is_demoed"][:, 0].any()
    assert golden["demo_frozen/out/0/arena.cars.is_demoed"][:, 0].all()
    assert golden["car_ball/out/1/arena.cars.ball_hit_valid"][:, 0].all()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = tctick.arena_step_reference

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(tctick, "arena_step_reference", spy)
    before = tracing.summary()["counters"].get("kernel.launches", 0)
    phys = tstep.make_physics_state(_params(), batch=(2,), device="cpu")
    out = arena_step_mod.arena_step(
        phys, torch.zeros(2, CARS, 8), torch.zeros(2, CARS,
                                                   dtype=torch.int32),
        _params(), TEAMS, tick_skip=2, action_delay=1)
    assert calls == [1]
    assert tracing.summary()["counters"].get("kernel.launches", 0) == before
    assert torch.equal(out.arena.tick_count, torch.full((2,), 2,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("kw", [dict(game_mode="hoops", use_mesh=True),
                                dict(game_mode="hoops",
                                     dynamic_wheel_rays=True),
                                dict(game_mode="hoops"),
                                dict(game_mode="rumble")])
def test_unported_configurations_raise(kw):
    params = tstep.ArenaParams(**{**dict(num_cars=CARS, use_mesh=False,
                                         dynamic_wheel_rays=False), **kw})
    phys = tstep.make_physics_state(params, batch=(1,), device="cpu")
    with pytest.raises(NotImplementedError):
        arena_step_mod.arena_step(
            phys, torch.zeros(1, CARS, 8),
            torch.zeros(1, CARS, dtype=torch.int32), params, TEAMS)


def test_wrapper_checks_shapes_and_types():
    phys = tstep.make_physics_state(_params(), batch=(2,), device="cpu")
    ridx = torch.zeros(2, CARS, dtype=torch.int32)
    with pytest.raises(ValueError):
        arena_step_mod.arena_step(phys, torch.zeros(2, CARS, 7), ridx,
                                  _params(), TEAMS)
    with pytest.raises(ValueError):
        arena_step_mod.arena_step(phys, torch.zeros(2, CARS, 8),
                                  ridx.long(), _params(), TEAMS)


def test_kernel_params_layout():
    """The packed ``Params`` struct: 4-byte fields in the kernel's order."""
    prm = arena_step_mod.pack_params(_params(), TEAMS)
    assert prm.dtype == np.float32
    sizes = dict(teams=8, dt=1, mutators=21, folded=15, boxes=5 * 3,
                 wheels=4 * 3 + 3 * 4, wheel_lengths=4 * 4, planes=15 * 4,
                 true_plane=15, corners=8 * 3, pad_locs=34 * 3, pad_big=34,
                 respawn=4 * 3, curves=12 * (1 + 6 + 6 + 5 + 5),
                 flags=2, full_folded=3, core=3 + 8 * 3,
                 facet_bands=11 * 19, facet_sides=3 * 9, game_mode=1,
                 snowday=4)
    assert prm.size == sum(sizes.values())
    # under the 4 KB of kernel arguments, with the buffer pointers
    assert prm.nbytes + 128 <= 4096
    assert list(prm[:8]) == [0, 0, 1, 1, 0, 0, 0, 0]
    assert prm[8] == np.float32(1 / 120)
    tail = sum(sizes.values()) - sum(list(sizes.values())[-7:])
    assert list(prm[tail:tail + 2]) == [0.0, 0.0]      # plane arena
    full = arena_step_mod.pack_params(tstep.ArenaParams(num_cars=CARS),
                                      TEAMS)
    assert list(full[tail:tail + 2]) == [1.0, 1.0]
    np.testing.assert_array_equal(full[tail + 2:], prm[tail + 2:])
    # the game mode, in ctick.GAME_MODES order
    assert prm[-5] == 0.0
    for i, mode in enumerate(("heatseeker", "snowday"), 1):
        gm = arena_step_mod.pack_params(tstep.ArenaParams(
            num_cars=CARS, game_mode=mode), TEAMS)
        assert gm[-5] == i


if __name__ == "__main__":
    import sys
    regenerate(tuple(sys.argv[1:]) or ("plane", "mesh"))
