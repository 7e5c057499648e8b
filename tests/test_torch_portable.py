"""The port's portable physics engine (reinforcement_learning_torch/physics:
car.py, contacts.py, step.py) against the JAX package's XLA engine.

* The car functions, the solvers, the manifold retention and the game-mode
  hooks take the same seeded numpy inputs on both sides, at most 8 arenas
  (the contacts in tests/test_torch_contacts.py).  The JAX functions run
  outside ``jit`` (``_jax_eager``; jitted, XLA:CPU fuses the mesh queries
  and moves a contact by up to 8e-3 uu).  Both sides compute in float32
  with the same operations, so the tolerances absorb last-bit
  differences: 1e-3 uu on arena-scale lengths and velocities (with 1e-5
  relative; 1e-4 where impulses pass through the 10-iteration solvers),
  1e-5 on unit vectors, angles and body-scale quantities, flags exactly.
* The tick (``arena_tick``) and the env step (``arena_step``, 8 ticks with
  the new controls from tick 7 and one respawn draw per car per tick) are
  held against golden traces of the JAX engine made eagerly
  (``jax.disable_jit``), because an eager hoops tick takes some 90 s on
  XLA:CPU the first time: ``tests/data/torch_portable_golden.npz``, soccar
  on the analytic-plane arena and at full fidelity here, hoops in
  tests/test_torch_hoops.py.  The traces are compared with
  ``ops.ctick.TOLERANCES`` (those of tests/test_ctick.py
  ``_assert_close``: pos 0.1 uu, vel 0.2 uu/s, ang_vel 0.02 rad/s, rot
  1e-4, flags equal).  The file stores a hash of the JAX sources it came
  from, and the tests fail once they change; regenerate it with

      python -m tests.test_torch_portable [scenario ...]

  (one process per scenario, in parallel; some 10-25 minutes).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch import maths as tm
from reinforcement_learning_torch.physics import car as tcar
from reinforcement_learning_torch.physics import contacts as tcontacts
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.physics import world as tworld
from tests.test_torch_physics import (CARS, E, TEAMS, _rotmat,
                                      assert_state_close, flatten,
                                      mesh_scenarios, random_controls,
                                      random_overrides, reference_hash,
                                      scenarios)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "torch_portable_golden.npz")
# the JAX modules the XLA engine runs; the golden file stores their hash
REFERENCE_SOURCES = (
    "constants.py", "maths.py", "envs/state_setters.py",
    "physics/arena_geom.py", "physics/box_box.py", "physics/box_tri.py",
    "physics/car.py", "physics/contacts.py", "physics/formulas.py",
    "physics/mesh.py", "physics/state.py", "physics/step.py",
    "physics/world.py")
TICK_SKIP, ACTION_DELAY = 8, 7

ATOL_LEN = 1e-3    # uu, uu/s: arena-scale lengths and velocities
RTOL = 1e-5
ATOL_UNIT = 1e-5   # unit vectors, angles, body-scale quantities


# ---------------------------------------------------------------------------
# the golden scenarios

def _hoops_kickoff(seed: int) -> dict:
    """Every field of the JAX hoops kickoff state of E arenas (the JAX
    package's KickoffState with per-arena keys)."""
    import jax
    import jax.numpy as jnp
    from reinforcement_learning_tpu.envs import state_setters as jsetters
    from reinforcement_learning_tpu.physics import step as jstep
    params = jstep.ArenaParams(num_cars=CARS, game_mode="hoops")
    keys = jax.random.split(jax.random.PRNGKey(seed), E)
    phys = jax.vmap(lambda k: jsetters.kickoff_state()(
        k, params, jnp.asarray(TEAMS)))(keys)
    return {k: np.asarray(v) for k, v in flatten(phys).items()}


def hoops_scenarios() -> dict:
    """Hoops scenarios: name -> (overrides, [controls per env step])."""
    ex = TC.ARENA_EXTENT_X_HOOPS
    cy = TC.HOOPS_GOAL_OFFSET_Y / TC.HOOPS_GOAL_SCALE_Y
    out = {"hoops_kickoff": (
        _hoops_kickoff(3), [random_controls(61), random_controls(62)])}
    # the ball into the +y basket (0-1: a goal), onto the rim's lip (2-3),
    # into the basket's outer wall (4-5), into a side wall and the
    # ceiling fillet (6-7); car 0 drives up the x+ side wall, car 1 sits on
    # a big pad with little boost, car 2 flies, car 3 drives into the -y
    # basket's outer wall
    ov = random_overrides(71, False)
    rng = np.random.RandomState(72)
    # (ball 2 lands mid-segment on the lip: over the seam between two lip
    # quads the pi/2 internal edge decides by its last bit, a sensitivity
    # of the reference that the tests avoid, ROADMAP Queue 3)
    bpos = np.array([[0, cy, 330], [40, cy + 30, 340],
                     [732.3, cy + 81.4, 480], [-736, cy - 20, 470],
                     [0, cy - 980, 250], [60, cy - 990, 280],
                     [ex - 200, 1000, 1500], [-(ex - 200), -500, 1600]],
                    np.float32)
    bvel = np.array([[0, 0, -900], [0, 0, -950],
                     [0, 0, -600], [0, 0, -650],
                     [0, 1500, 0], [0, 1400, 100],
                     [1500, 0, 300], [-1500, 0, 400]], np.float32)
    pos, vel, rot, boost = (ov[f"arena.cars.{n}"].copy()
                            for n in ("pos", "vel", "rot", "boost"))
    on_wall = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
    pads = TC.BOOST_LOCS_BIG_HOOPS
    for e in range(E):
        pos[e, 0] = (ex - 17.0, rng.uniform(-1500, 1500),
                     rng.uniform(450, 900))
        vel[e, 0] = (0.0, rng.uniform(-200, 200), rng.uniform(200, 600))
        rot[e, 0] = on_wall
        px, py, _ = pads[e % len(pads)]
        pos[e, 1] = (px + rng.uniform(-30, 30), py + rng.uniform(-30, 30),
                     17.0)
        vel[e, 1] = 0.0
        boost[e, 1] = 10.0
        pos[e, 2] = (rng.uniform(-1500, 1500), rng.uniform(-1000, 1000),
                     rng.uniform(300, 900))
        vel[e, 2] = rng.uniform(-600, 600, 3)
        rot[e, 2] = _rotmat(np.float32(rng.uniform(-3, 3)),
                            np.float32(rng.uniform(-1, 1)),
                            np.float32(rng.uniform(-3, 3)))
        pos[e, 3] = (rng.uniform(-300, 300), -cy + 900.0, 17.0)
        vel[e, 3] = (0.0, -1200.0, 0.0)
        rot[e, 3] = _rotmat(np.float32(-np.pi / 2 + rng.uniform(-0.2, 0.2)),
                            np.float32(0.0), np.float32(0.0))
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.cars.boost": boost,
               "arena.ball.pos": bpos, "arena.ball.vel": bvel,
               "arena.ball.ang_vel": np.zeros((E, 3), np.float32)})
    ctl = np.zeros((E, CARS, 8), np.float32)
    ctl[:, [0, 3], 0] = 1.0
    out["hoops_rim"] = (ov, [ctl, ctl])
    return out


def soccar_scenarios() -> dict:
    """Soccar scenarios: name -> (full fidelity?, overrides, [controls per
    env step]): the kernel route's scenarios (tests/test_torch_physics.py)
    on the portable engine, and a car respawning in the middle of a step
    (its per-tick draw)."""
    plane, mesh = scenarios(), mesh_scenarios()
    ov = random_overrides(11, False)
    demoed = np.zeros((E, CARS), bool)
    demoed[:, 0] = demoed[::2, 2] = True
    timer = np.zeros((E, CARS), np.float32)
    timer[:, 0] = 3.5 / 120.0
    timer[::2, 2] = 5.5 / 120.0
    ov.update({"arena.cars.is_demoed": demoed,
               "arena.cars.demo_respawn_timer": timer})
    # mesh_walls' car 3 meets the x-y+ corner wall at mid height in the
    # even arenas: driven into the corner's floor fillet, it wedges
    # between faces whose contact normals cancel, and its world contact
    # normal is the normalized rounding noise of that sum on both sides
    # (a sensitivity of the reference the tests avoid, ROADMAP Queue 3)
    walls, walls_ctl = mesh["mesh_walls"][:2]
    walls = {k: v.copy() for k, v in walls.items()}
    walls["arena.cars.pos"][::2, 3, 2] = 300.0
    out = {
        "mesh_walls": (True, walls, walls_ctl),
        "plane_ground": (False, *plane["ground"][:2]),
        "plane_airborne": (False, *plane["airborne"][:2]),
        "plane_car_car": (False, *plane["car_car"][:2]),
        "plane_car_ball": (False, *plane["car_ball"][:2]),
        "mesh_respawn": (True, ov, [random_controls(12)]),
    }
    for name in ("mesh_open", "mesh_dynamic"):
        out[name] = (True, *mesh[name][:2])
    out["mesh_car_car"] = (True, *plane["car_car"][:2])
    return out


def all_scenarios() -> dict:
    """name -> (game mode, full fidelity?, overrides, [controls])."""
    out = {n: ("soccar", *v) for n, v in soccar_scenarios().items()}
    out.update({n: ("hoops", True, *v) for n, v in hoops_scenarios().items()})
    return out


def _params(mode: str, mesh: bool, jax_side: bool = False):
    if jax_side:
        from reinforcement_learning_tpu.physics import step as jstep
        mod = jstep
    else:
        mod = tstep
    return mod.ArenaParams(num_cars=CARS, game_mode=mode, use_mesh=mesh,
                           dynamic_wheel_rays=mesh)


def tick_draws(keys):
    """The respawn draws of the JAX ``arena_step`` for per-arena ``keys``
    (E, 2): (E, tick_skip, C), the ``split`` chain of step.py:700 ->
    :216."""
    import jax
    out = []
    for key in keys:
        k, rows = key, []
        for _ in range(TICK_SKIP):
            k, sub = jax.random.split(k)
            _, krespawn = jax.random.split(sub)
            rows.append(np.asarray(jax.random.randint(
                krespawn, (CARS,), 0, TC.CAR_RESPAWN_LOCATION_AMOUNT)))
        out.append(rows)
    return np.asarray(out, np.int32)


def tick_draw(keys):
    """The respawn draw of the JAX ``arena_tick`` for per-arena keys:
    (E, C)."""
    import jax
    return np.stack([np.asarray(jax.random.randint(
        jax.random.split(k)[1], (CARS,), 0, TC.CAR_RESPAWN_LOCATION_AMOUNT))
        for k in keys]).astype(np.int32)


def _jax_build(obj, leaves, prefix=""):
    import jax.numpy as jnp
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        kw[f.name] = (_jax_build(v, leaves, name + ".")
                      if dataclasses.is_dataclass(v)
                      else jnp.asarray(leaves[name]))
    return type(obj)(**kw)


def run_jax(name: str) -> dict:
    """The eager JAX trace of scenario ``name``: its inputs, one tick with
    the first step's controls, and each env step with its draws."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from reinforcement_learning_tpu.physics import step as jstep
    mode, mesh, ov, controls = all_scenarios()[name]
    params = _params(mode, mesh, jax_side=True)
    teams = jnp.asarray(TEAMS)
    base = jax.vmap(lambda _: jstep.make_physics_state(params))(
        jnp.arange(E))
    phys = _jax_build(base, {**flatten(base), **ov})
    seed = sorted(all_scenarios()).index(name) * 100
    data = {f"{name}/in/{k}": v for k, v in flatten(phys).items()}
    with jax.disable_jit():
        keys = jax.random.split(jax.random.PRNGKey(seed), E)
        ticked = dataclasses.replace(phys, arena=dataclasses.replace(
            phys.arena, cars=dataclasses.replace(
                phys.arena.cars, controls=jnp.asarray(controls[0]))))
        out = jax.vmap(lambda p, k: jstep.arena_tick(p, teams, k, params))(
            ticked, keys)
        data[f"{name}/tick_draw"] = tick_draw(keys)
        data.update({f"{name}/tick/{k}": np.asarray(v)
                     for k, v in flatten(out).items()})
        print(name, "tick done", flush=True)
        for t, ctl in enumerate(controls):
            keys = jax.random.split(jax.random.PRNGKey(seed + 1 + t), E)
            phys = jax.vmap(lambda p, c, k: jstep.arena_step(
                p, c, teams, k, params, TICK_SKIP, ACTION_DELAY))(
                    phys, jnp.asarray(ctl), keys)
            data[f"{name}/draws/{t}"] = tick_draws(keys)
            data.update({f"{name}/out/{t}/{k}": np.asarray(v)
                         for k, v in flatten(phys).items()})
            print(name, "step", t, "done", flush=True)
    return data


def regenerate(names=()):
    """Run the JAX engine on every scenario (or on ``names`` only, keeping
    the file's other traces) eagerly, one process each, and store the
    traces."""
    import concurrent.futures
    import multiprocessing
    os.makedirs(DATA, exist_ok=True)
    data = {"reference_sha256": np.array(reference_hash(REFERENCE_SOURCES))}
    if names:
        kept = dict(np.load(GOLDEN))
        assert str(kept["reference_sha256"]) == str(data[
            "reference_sha256"]), "the JAX sources changed: regenerate all"
        data.update({k: v for k, v in kept.items()
                     if k.split("/")[0] not in names})
    names = sorted(names or all_scenarios())
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            min(len(names), os.cpu_count() or 1), mp_context=ctx) as pool:
        for part in pool.map(run_jax, names):
            data.update(part)
    np.savez_compressed(GOLDEN, **data)
    print("wrote", GOLDEN)


# ---------------------------------------------------------------------------
# following the golden traces

@functools.lru_cache(maxsize=None)
def load_golden():
    data = np.load(GOLDEN)
    assert str(data["reference_sha256"]) == reference_hash(
        REFERENCE_SOURCES), (
        "the JAX reference sources changed since the golden traces were "
        "made: regenerate them with python -m tests.test_torch_portable")
    return {k: data[k] for k in data.files}


def stored(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def from_flat(flat: dict, params) -> tstep.PhysicsState:
    base = tstep.make_physics_state(params, batch=(E,), device="cpu")

    def build(obj, prefix=""):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = prefix + f.name
            kw[f.name] = (build(v, name + ".") if dataclasses.is_dataclass(v)
                          else torch.from_numpy(np.array(flat[name])))
        return type(obj)(**kw)
    return build(base)


def check_tick(name: str):
    """The port's ``arena_tick`` from the scenario's input state with its
    first controls, against the JAX tick."""
    data = load_golden()
    mode, mesh, ov, controls = all_scenarios()[name]
    params = _params(mode, mesh)
    flat = stored(data, f"{name}/in/")
    for field, value in ov.items():      # the stored inputs are these
        np.testing.assert_array_equal(flat[field], value, err_msg=field)
    phys = from_flat(flat, params)
    phys.arena.cars.controls = torch.from_numpy(controls[0])
    got = tstep.arena_tick(phys, TEAMS,
                           torch.from_numpy(data[f"{name}/tick_draw"]),
                           params)
    assert_state_close(flatten(got), stored(data, f"{name}/tick/"),
                       f"{name} tick")


def check_step(name: str):
    """The port's ``arena_step`` along the scenario's stored trace, step by
    step, with the JAX per-tick draws handed in."""
    data = load_golden()
    mode, mesh, ov, controls = all_scenarios()[name]
    params = _params(mode, mesh)
    phys = from_flat(stored(data, f"{name}/in/"), params)
    for t, ctl in enumerate(controls):
        phys = tstep.arena_step(
            phys, torch.from_numpy(ctl), TEAMS,
            torch.from_numpy(data[f"{name}/draws/{t}"]), params,
            TICK_SKIP, ACTION_DELAY)
        assert_state_close(flatten(phys), stored(data, f"{name}/out/{t}/"),
                           f"{name} step {t}")
    return phys


SOCCAR = sorted(soccar_scenarios())


@pytest.mark.parametrize("name", SOCCAR)
def test_tick_matches_jax(name):
    check_tick(name)


@pytest.mark.parametrize("name", SOCCAR)
def test_step_matches_jax(name):
    check_step(name)


def test_scenarios_drive_their_contacts():
    """The traces reach what each scenario is there for: a car respawns in
    the middle of a step at its per-tick draw, bumps and demos, the ball
    off the walls and fillets, wheels on the ball and on a roof."""
    data = load_golden()
    out = stored(data, "mesh_respawn/out/0/")
    assert not out["arena.cars.is_demoed"][:, 0].any()
    assert not out["arena.cars.is_demoed"][::2, 2].any()
    draws = data["mesh_respawn/draws/0"]
    # car 0 (blue) respawned at tick 3 from that tick's draw
    table = TC.CAR_RESPAWN_LOCATIONS_SOCCAR
    first = table[draws[:, 3, 0]]
    np.testing.assert_allclose(out["arena.cars.pos"][:, 0, 0], first[:, 0],
                               atol=50.0)
    assert len(set(draws[:, :, 0].ravel().tolist())) > 1
    assert stored(data, "mesh_car_car/out/0/")["arena.step_demo"].any()
    assert stored(data, "plane_car_car/out/0/")["arena.step_bump"].any()
    walls = stored(data, "mesh_walls/out/1/")
    vin = data["mesh_walls/in/arena.ball.vel"]
    assert (walls["arena.ball.vel"][[0, 1], 2] > 0).all()
    assert (walls["arena.ball.vel"][[2, 3], 1] * vin[[2, 3], 1] < 0).all()
    dyn = stored(data, "mesh_dynamic/out/1/")
    assert dyn["arena.cars.wheels_with_contact"][4:, 1].all()
    assert dyn["arena.cars.pos"][:4, 0, 2].min() > 150.0
    ball = stored(data, "plane_car_ball/out/1/")
    assert ball["arena.cars.ball_hit_valid"][:, 0].all()


# ---------------------------------------------------------------------------
# the car and contact functions, live against the JAX package

def _jax_eager(fn, *args):
    """``jax.vmap(fn)(*args)`` over the arena axis, outside ``jit``: every
    operation runs on its own, unfused, except the bodies of the solvers'
    ``fori_loop``s and the retention's ``scan``, which XLA compiles."""
    import jax
    return jax.vmap(fn)(*args)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def close(got, want, atol=ATOL_LEN, rtol=RTOL, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), atol=atol,
                                   rtol=rtol, err_msg=what)


def close_tree(got, want, atol=ATOL_LEN, rtol=RTOL, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            close_tree(got[k], want[k], atol, rtol, f"{what}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close_tree(g, w, atol, rtol, f"{what}[{i}]")
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            close_tree(getattr(got, f.name), getattr(want, f.name), atol,
                       rtol, f"{what}.{f.name}")
    else:
        close(got, want, atol, rtol, what)


def car_state(seed: int, mode: str = "soccar") -> dict:
    """Field overrides of a played-looking state: the cars in every
    situation the state machines branch on (ground, air, flipping, jumping,
    demoed, boosting, handbraking), wheel drive values set."""
    rng = np.random.RandomState(seed)
    ov = random_overrides(seed, False)
    air = random_overrides(seed + 1, True)
    for k in ("pos", "vel", "ang_vel", "rot"):     # cars 2-3 in the air
        ov[f"arena.cars.{k}"][:, 2:] = air[f"arena.cars.{k}"][:, 2:]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    b = lambda p: rng.uniform(0, 1, (E, CARS)) < p  # noqa: E731
    if mode == "hoops":
        for k in ("arena.cars.pos", "arena.ball.pos"):
            ov[k][..., :2] *= np.float32(0.6)
    # the dynamic wheel-ray targets: car 1 above the resting ball (arenas
    # 0-3), car 3 above car 2's roof (arenas 4-7)
    pos, rot = ov["arena.cars.pos"], ov["arena.cars.rot"]
    for e in range(E):
        if e < 4:
            ov["arena.ball.pos"][e] = (pos[e, 1, 0], pos[e, 1, 1], 93.15)
            pos[e, 1, 2] = 93.15 + 91.25 + 22.0
            rot[e, 1] = np.eye(3, dtype=np.float32)
        else:
            pos[e, 2] = (pos[e, 1, 0] + 700.0, pos[e, 1, 1], 17.0)
            pos[e, 3] = pos[e, 2] + (8.0, 4.0, 63.0)
            rot[e, 2] = rot[e, 3] = _rotmat(np.float32(0.1 * e),
                                            np.float32(0.0),
                                            np.float32(0.0))
    ov.update({
        "arena.cars.is_on_ground": b(0.5), "arena.cars.is_jumping": b(0.3),
        "arena.cars.has_jumped": b(0.5), "arena.cars.has_flipped": b(0.3),
        "arena.cars.has_double_jumped": b(0.2),
        "arena.cars.is_flipping": b(0.3),
        "arena.cars.is_auto_flipping": b(0.1),
        "arena.cars.has_world_contact": b(0.5),
        "arena.cars.is_supersonic": b(0.2),
        "arena.cars.jump_time": f32(rng.uniform(0, 0.3, (E, CARS))),
        "arena.cars.flip_time": f32(rng.uniform(0, 0.8, (E, CARS))),
        "arena.cars.air_time": f32(rng.uniform(0, 2, (E, CARS))),
        "arena.cars.air_time_since_jump": f32(rng.uniform(0, 1.6,
                                                          (E, CARS))),
        "arena.cars.time_spent_boosting": f32(
            rng.uniform(0, 0.2, (E, CARS)) * b(0.5)),
        "arena.cars.handbrake_val": f32(rng.uniform(0, 1, (E, CARS))),
        "arena.cars.auto_flip_timer": f32(rng.uniform(0, 0.4, (E, CARS))),
        "arena.cars.auto_flip_torque_scale": f32(
            np.sign(rng.uniform(-1, 1, (E, CARS)))),
        "arena.cars.flip_rel_torque": f32(
            rng.uniform(-1, 1, (E, CARS, 3)) * [1, 1, 0]),
        "arena.cars.world_contact_normal": f32(
            tm.normalize(torch.from_numpy(f32(rng.normal(
                size=(E, CARS, 3)) + [0, 0, 2]))).numpy()),
        "arena.cars.controls": random_controls(seed + 1),
        "arena.cars.last_controls": random_controls(seed + 2),
        "wheels.steer_angle": f32(rng.uniform(-0.5, 0.5, (E, CARS))),
        "wheels.engine_force": f32(rng.uniform(-60, 60, (E, CARS))
                                   * b(0.6)),
        "wheels.brake": f32(rng.uniform(0, 3, (E, CARS)) * b(0.5)),
        "wheels.lat_friction": f32(rng.uniform(0, 1, (E, CARS, 4))),
        "wheels.long_friction": f32(rng.uniform(0, 1, (E, CARS, 4))),
    })
    return ov


def both_states(ov: dict, mode: str, mesh: bool):
    """(JAX PhysicsState, port PhysicsState) of E arenas with ``ov``."""
    import jax
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import step as jstep
    jp = _params(mode, mesh, jax_side=True)
    base = jax.vmap(lambda _: jstep.make_physics_state(jp))(jnp.arange(E))
    flat = {**flatten(base), **ov}
    return _jax_build(base, flat), from_flat(flat, _params(mode, mesh))


CAR_CASES = [("soccar", True, 81), ("soccar", False, 82), ("hoops", True, 83)]


@pytest.mark.parametrize("mode,mesh,seed", CAR_CASES)
def test_car_functions_match_jax(mode, mesh, seed):
    """Every function of physics/car.py in the order the tick calls them,
    each from the same inputs: the raycasts (with the mesh and the dynamic
    ball and car targets at full fidelity), the friction impulses and
    their application, the suspension, the drive update and the state
    machines."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import car as jcar
    from reinforcement_learning_tpu.physics import world as jworld
    jphys, tphys = both_states(car_state(seed, mode), mode, mesh)
    jp, tp = _params(mode, mesh, True), _params(mode, mesh)
    cfg, mut, dt = tp.car_config, tp.mutators, tp.dt
    jcfg, jmut = jp.car_config, jp.mutators
    jc, tc = jphys.arena.cars, tphys.arena.cars
    jball, tball = jphys.arena.ball, tphys.arena.ball
    jwc, twc = jphys.wheels, tphys.wheels
    alive_np = ~np.asarray(jc.is_demoed)

    inv_l = tcar.car_tables(cfg, mut.car_mass, torch.device("cpu"))[
        "inv_i_local"]
    close(inv_l, jcar.box_inv_inertia_local(jmut.car_mass, jcfg.hitbox_size),
          0.0, 1e-7, "inv_i_local")
    j_iw = _jax_eager(lambda r: jcar.inv_inertia_world(
        r, jcar.box_inv_inertia_local(jmut.car_mass, jcfg.hitbox_size)),
        jc.rot)
    t_iw = tcar.inv_inertia_world(tc.rot, inv_l)
    close(t_iw, j_iw, 1e-6, 1e-6, "inv_inertia_world")

    imp = np.asarray(jc.vel)[..., None, :] * np.float32(0.02)
    rel = np.asarray(jc.pos)[..., None, :] * np.float32(1e-3)
    close_tree(tcar.apply_impulse_bt(
        tc.vel, tc.ang_vel, torch.from_numpy(imp[..., 0, :]),
        torch.from_numpy(rel[..., 0, :]), 1 / mut.car_mass, t_iw),
        _jax_eager(lambda v, w, i, r, iw: jcar.apply_impulse_bt(
            v, w, i, r, 1 / jmut.car_mass, iw), jc.vel, jc.ang_vel,
            imp[..., 0, :], rel[..., 0, :], j_iw), what="apply_impulse_bt")

    jgrid = jworld.get_grid(mode) if mesh else None
    tgrid = tworld.get_grid(mode, "cpu") if mesh else None
    jrc = _jax_eager(lambda c, iw, b, al: jcar.wheel_raycasts(
        c, jcfg, jmut, dt, iw, mode, grid=jgrid, ball=b if mesh else None,
        alive=al), jc, j_iw, jball, jnp.asarray(alive_np))
    trc = tcar.wheel_raycasts(tc, cfg, mut, dt, t_iw, mode, grid=tgrid,
                              ball=tball if mesh else None,
                              alive=torch.from_numpy(alive_np))
    close_tree(trc, jrc, what="wheel_raycasts")
    assert np.asarray(jrc.is_in_contact).any()
    if mesh:
        assert (np.asarray(jrc.ground_idx) != -1).any() or mode == "hoops"

    jimp = _jax_eager(lambda c, r, w, iw, b: jcar.calc_friction_impulses(
        c, r, w, jmut, dt, iw, ball=b if mesh else None),
        jc, jrc, jwc, j_iw, jball)
    timp = tcar.calc_friction_impulses(tc, trc, twc, mut, dt, t_iw,
                                       ball=tball if mesh else None)
    close(timp, jimp, 1e-4, 1e-4, "calc_friction_impulses")
    close_tree(tcar.apply_friction_impulses(tc, trc, timp, dt, mut, t_iw),
               _jax_eager(lambda c, r, i, iw: jcar.apply_friction_impulses(
                   c, r, i, dt, jmut, iw), jc, jrc, jimp, j_iw),
               what="apply_friction_impulses")
    close_tree(tcar.apply_suspension(tc, trc, cfg, mut, dt, t_iw),
               _jax_eager(lambda c, r, iw: jcar.apply_suspension(
                   c, r, jcfg, jmut, dt, iw), jc, jrc, j_iw),
               what="apply_suspension")

    jctl, tctl = jc.controls, tc.controls
    jfwd = _jax_eager(lambda c: jnp.sum(c.vel * c.forward, -1), jc)
    tfwd = tm.dot(tc.vel, tc.forward)
    close_tree(tcar.update_wheels(tc, trc, twc, tctl, tfwd, dt),
               _jax_eager(lambda c, r, w, u, f: jcar.update_wheels(
                   c, r, w, u, f, dt), jc, jrc, jwc, jctl, jfwd),
               1e-4, 1e-5, "update_wheels")
    nc = trc.is_in_contact.sum(-1)
    jnc = jnp.asarray(nc.numpy())
    close_tree(tcar.update_air_torque(tc, tctl, nc < 3, nc == 0, dt),
               _jax_eager(lambda c, u, a, z: jcar.update_air_torque(
                   c, u, a, z, dt), jc, jctl, jnc < 3, jnc == 0),
               what="update_air_torque")
    pressed = torch.from_numpy(random_controls(seed + 5)[..., 5] > 0)
    jpressed = jnp.asarray(pressed.numpy())
    close_tree(tcar.update_jump(tc, tctl, pressed, mut, dt),
               _jax_eager(lambda c, u, p: jcar.update_jump(c, u, p, jmut, dt),
                          jc, jctl, jpressed), what="update_jump")
    close_tree(tcar.update_auto_flip(tc, tctl, pressed, dt),
               _jax_eager(lambda c, u, p: jcar.update_auto_flip(c, u, p, dt),
                          jc, jctl, jpressed), what="update_auto_flip")
    close_tree(tcar.update_double_jump_or_flip(
        tc, tctl, pressed, tfwd, cfg, mut, dt, tc.is_jumping, tc.has_jumped,
        tc.jump_time, tc.is_flipping),
        _jax_eager(lambda c, u, p, f: jcar.update_double_jump_or_flip(
            c, u, p, f, jcfg, jmut, dt, c.is_jumping, c.has_jumped,
            c.jump_time, c.is_flipping), jc, jctl, jpressed, jfwd),
        what="update_double_jump_or_flip")
    close_tree(tcar.update_auto_roll(tc, trc, tctl, nc),
               _jax_eager(lambda c, r, u, n: jcar.update_auto_roll(
                   c, r, u, n), jc, jrc, jctl, jnc),
               ATOL_UNIT, 1e-5, "update_auto_roll")
    close_tree(tcar.update_boost(tc, tctl, mut, dt),
               _jax_eager(lambda c, u: jcar.update_boost(c, u, jmut, dt),
                          jc, jctl), what="update_boost")


def _rows(seed: int, R: int = 4):
    """Random contact rows of E bodies: velocities, lever arms, normals,
    actives, distances, inverse inertias (BT units)."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    n = rng.normal(size=(E, R, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rot = _rotmat(rng.uniform(-3, 3, E), rng.uniform(-1, 1, E),
                  rng.uniform(-3, 3, E))
    inv_l = np.float32([0.55, 0.32, 0.28])
    iw = np.einsum('eij,j,ekj->eik', rot, inv_l, rot)
    return dict(v=f32(rng.uniform(-30, 30, (E, 3))),
                w=f32(rng.uniform(-4, 4, (E, 3))),
                r=f32(rng.uniform(-1.5, 1.5, (E, R, 3))), n=f32(n),
                act=rng.uniform(0, 1, (E, R)) < 0.75,
                dist=f32(rng.uniform(-0.2, 0.05, (E, R))), iw=f32(iw),
                vpre=f32(rng.uniform(-30, 30, (E, 3))))


def test_pgs_solvers_match_jax():
    """The three sequential-impulse solvers, row for row: one body
    against the static world (``pgs_rows_vs_static``), two bodies
    (``pgs_rows_two_body``) and the single merged contact
    (``_contact_impulse_vs_static``)."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import contacts as jcon
    a, b = _rows(91), _rows(92)
    T = lambda x: torch.from_numpy(x)  # noqa: E731
    J = lambda x: jnp.asarray(x)  # noqa: E731
    dt = 1.0 / 120.0
    want = _jax_eager(
        lambda v, w, r, n, act, iw, d, vp: jcon.pgs_rows_vs_static(
            v, w, r, n, act, 1 / 3.0, iw, 0.3, 0.35, d, dt, vel_pre_bt=vp),
        *(J(a[k]) for k in ("v", "w", "r", "n", "act", "iw", "dist",
                            "vpre")))
    got = tcontacts.pgs_rows_vs_static(
        *(T(a[k]) for k in ("v", "w", "r", "n", "act")), 1 / 3.0, T(a["iw"]),
        0.3, 0.35, T(a["dist"]), dt, vel_pre_bt=T(a["vpre"]))
    close_tree(got, want, 1e-4, 1e-4, "pgs_rows_vs_static")
    assert np.asarray(want[4]).max() > 0
    want = _jax_eager(
        lambda v0, w0, v1, w1, r0, r1, n, act, i0, i1, d, p0, p1:
        jcon.pgs_rows_two_body(v0, w0, v1, w1, r0, r1, n, act, 1 / 3.0,
                               1 / 3.0, i0, i1, 0.1, 0.09, d, dt, p0, p1),
        *(J(x) for x in (a["v"], a["w"], b["v"], b["w"], a["r"], b["r"],
                         a["n"], a["act"], a["iw"], b["iw"], a["dist"],
                         a["vpre"], b["vpre"])))
    got = tcontacts.pgs_rows_two_body(
        *(T(x) for x in (a["v"], a["w"], b["v"], b["w"], a["r"], b["r"],
                         a["n"], a["act"])), 1 / 3.0, 1 / 3.0, T(a["iw"]),
        T(b["iw"]), 0.1, 0.09, T(a["dist"]), dt, T(a["vpre"]),
        T(b["vpre"]))
    close_tree(got, want, 1e-4, 1e-4, "pgs_rows_two_body")
    want = _jax_eager(lambda v, w, r, n, iw, vp:
                      jcon._contact_impulse_vs_static(
                          v, w, r, n, 1 / 3.0, iw, 0.6, 0.35, vel_pre_bt=vp,
                          iterations=10),
                      *(J(x) for x in (a["v"], a["w"], a["r"][:, 0],
                                       a["n"][:, 0], a["iw"], a["vpre"])))
    got = tcontacts._contact_impulse_vs_static(
        *(T(x) for x in (a["v"], a["w"], a["r"][:, 0], a["n"][:, 0])),
        1 / 3.0, T(a["iw"]), 0.6, 0.35, vel_pre_bt=T(a["vpre"]),
        iterations=10)
    close_tree(got, want, 1e-4, 1e-4, "_contact_impulse_vs_static")
    for fn in ("_restitution_rhs", "_plane_space_dir"):
        x = a["n"][..., 0] * 5 if fn == "_restitution_rhs" else a["n"]
        args = (x, 0.6) if fn == "_restitution_rhs" else (x,)
        close(getattr(tcontacts, fn)(T(args[0]), *args[1:]),
              getattr(jcon, fn)(J(args[0]), *args[1:]), ATOL_UNIT, 0.0, fn)


def test_manifold_insert_matches_jax():
    """bullet's 4-slot retention over K candidates, including depth ties
    and zero-area candidates (the argmin/argmax ties pick the first
    slot on both sides)."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import contacts as jcon
    rng = np.random.RandomState(93)
    K = 12
    la = rng.uniform(-60, 60, (E, K, 3)).astype(np.float32)
    la[:2, 6:] = la[:2, :1]                  # repeated points: zero areas
    d = rng.uniform(-3, 1, (E, K)).astype(np.float32)
    d[2:4, 5:] = d[2:4, :1]                  # depth ties
    act = rng.uniform(0, 1, (E, K)) < 0.7
    want = _jax_eager(jcon.manifold_insert, jnp.asarray(la), jnp.asarray(d),
                      jnp.asarray(act))
    got = tcontacts.manifold_insert(torch.from_numpy(la),
                                    torch.from_numpy(d),
                                    torch.from_numpy(act))
    close(got, want, what="manifold_insert")
    assert (np.asarray(want) >= 0).all(-1).any()


def test_game_mode_hooks_match_jax():
    """The XLA-form heatseeker hooks and the UE3 angle rounding on point
    batches: steering, the per-car hit fold, the back-wall bounce."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import step as jstep
    rng = np.random.RandomState(95)
    ov = {"arena.ball.pos": np.float32(np.c_[rng.uniform(-3000, 3000, E),
                                             rng.uniform(-5000, 5000, E),
                                             rng.uniform(100, 1800, E)]),
          "arena.ball.vel": rng.uniform(-2000, 2000, (E, 3)).astype(
              np.float32),
          "arena.ball.hs_y_target_dir": np.float32([1, -1, 0, 1, -1, 1, -1,
                                                    0]),
          "arena.ball.hs_target_speed": rng.uniform(2900, 4600, E).astype(
              np.float32),
          "arena.ball.hs_time_since_hit": rng.uniform(0, 1.5, E).astype(
              np.float32)}
    ov["arena.ball.pos"][:4, 1] = np.float32([5050, -5050, 5050, 5080])
    jphys, tphys = both_states(ov, "heatseeker", False)
    jb, tb = jphys.arena.ball, tphys.arena.ball
    dt = 1.0 / 120.0
    ang = rng.uniform(-7, 7, 64).astype(np.float32)
    close(tstep._round_angle_ue3(torch.from_numpy(ang)),
          jstep._round_angle_ue3(jnp.asarray(ang)), 0.0, 0.0, "round_angle")
    close(tstep._wrap(torch.from_numpy(ang), np.pi),
          jstep._wrap(jnp.asarray(ang), jnp.pi), 1e-6, 0.0, "wrap")
    close_tree(tstep._heatseeker_steer(tb, dt),
               _jax_eager(lambda b: jstep._heatseeker_steer(b, dt), jb),
               what="heatseeker_steer")
    touched = rng.uniform(0, 1, (E, CARS)) < 0.5
    close_tree(tstep._heatseeker_on_hit(tb, torch.from_numpy(touched),
                                        np.asarray(TEAMS), dt),
               _jax_eager(lambda b, t: jstep._heatseeker_on_hit(
                   b, t, jnp.asarray(TEAMS), dt), jb, touched),
               what="heatseeker_on_hit")
    n = np.float32([[0, -1, 0], [0, 1, 0], [0, -1, 0], [0, -0.8, 0.6]] * 2)
    touch = np.ones(E, bool)
    close_tree(tstep._heatseeker_wall_bounce(tb, torch.from_numpy(touch),
                                             torch.from_numpy(n)),
               _jax_eager(lambda b, t, nn: jstep._heatseeker_wall_bounce(
                   b, t, nn), jb, touch, n), what="heatseeker_wall_bounce")


if __name__ == "__main__":
    import sys
    regenerate(tuple(sys.argv[1:]))
