"""The port's plain physics step (reinforcement_learning_torch/ops/ctick)
against the JAX megakernel body ``ops/ctick.step`` in plane mode.

``ctick.step`` jitted on XLA:CPU takes several minutes to compile (the
whole plane tick in one graph), far beyond a unit test's budget, so its
outputs for fixed scenarios are stored in ``tests/data/
torch_physics_golden.npz``.  The scenarios are the ones of
``tests/test_ctick.py`` (ground, airborne, multi-step, demo/respawn) plus
two cars overlapping (car-car bump and demo) and a car driving into the
ball, with inputs made by numpy from fixed seeds.  Regenerate the file with

    python -m tests.test_torch_physics

which runs the JAX side (one compile, E=8 arenas x 4 cars).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from reinforcement_learning_torch.ops import arena_step as arena_step_mod
from reinforcement_learning_torch.ops import ctick as tctick
from reinforcement_learning_torch.physics import step as tstep

E, CARS = 8, 4
TEAMS = (0, 0, 1, 1)
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_physics_golden.npz")
# The JAX modules ``ctick.step`` runs in plane mode; the golden file stores
# their hash, so a change to the reference fails the test until the file is
# regenerated.
REFERENCE_SOURCES = (
    "constants.py", "maths.py", "ops/ctick.py", "ops/cvec.py", "ops/pack.py",
    "physics/arena_geom.py", "physics/box_box.py", "physics/car.py",
    "physics/formulas.py", "physics/state.py", "physics/step.py")


def reference_hash() -> str:
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reinforcement_learning_tpu")
    h = hashlib.sha256()
    for rel in REFERENCE_SOURCES:
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


def regenerate():
    """Run the JAX ``ctick.step`` on every scenario and store the traces."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from reinforcement_learning_tpu.ops import ctick, pack
    from reinforcement_learning_tpu.physics import step as stepmod

    params = stepmod.ArenaParams(num_cars=CARS, use_mesh=False,
                                 dynamic_wheel_rays=False)
    k = ctick.make_consts(params, np.asarray(TEAMS))
    run = jax.jit(lambda d, nc, r: ctick.step(k, d, nc, r, 8, 7))
    base = jax.vmap(lambda _: stepmod.make_physics_state(params))(
        jnp.arange(E))

    def build(obj, leaves, prefix=""):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = prefix + f.name
            kw[f.name] = (build(v, leaves, name + ".")
                          if dataclasses.is_dataclass(v)
                          else jnp.asarray(leaves[name]))
        return type(obj)(**kw)

    data = {"reference_sha256": np.array(reference_hash())}
    for name, (ov, controls, ridx) in scenarios().items():
        phys = build(base, {**flatten(base), **ov})
        for n, a in flatten(phys).items():
            data[f"{name}/in/{n}"] = a
        for t, ctl in enumerate(controls):
            nc = tuple(jnp.asarray(ctl[..., c].T) for c in range(8))
            out = run(pack.to_components(phys), nc, jnp.asarray(ridx.T))
            phys = pack.from_components(out, E)
            for n, a in flatten(phys).items():
                data[f"{name}/out/{t}/{n}"] = a
        print(name, "done", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **data)
    print("wrote", GOLDEN)


# ---------------------------------------------------------------------------
# the tests

torch.set_num_threads(1)


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


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    assert str(data["reference_sha256"]) == reference_hash(), (
        "the JAX reference sources changed since the golden traces were "
        "made: regenerate them with python -m tests.test_torch_physics")
    return data


@pytest.mark.parametrize("name", list(scenarios()))
def test_plain_step_matches_jax_ctick(golden, name):
    """The plain version, through ``arena_step`` on CPU tensors, follows
    the JAX ``ctick.step`` trace of the scenario step by step."""
    ov, controls, ridx = scenarios()[name]
    flat = {k[len(name) + 4:]: golden[k] for k in golden.files
            if k.startswith(f"{name}/in/")}
    for field, value in ov.items():    # the stored inputs are these
        np.testing.assert_array_equal(flat[field], value, err_msg=field)
    phys = _from_flat(flat)
    for t, ctl in enumerate(controls):
        phys = arena_step_mod.arena_step(
            phys, torch.from_numpy(ctl), torch.from_numpy(ridx), _params(),
            TEAMS)
        prefix = f"{name}/out/{t}/"
        want = {k[len(prefix):]: golden[k] for k in golden.files
                if k.startswith(prefix)}
        assert_state_close(flatten(phys), want, f"{name} step {t}")


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
    before = arena_step_mod.arena_step.launches
    phys = tstep.make_physics_state(_params(), batch=(2,), device="cpu")
    out = arena_step_mod.arena_step(
        phys, torch.zeros(2, CARS, 8), torch.zeros(2, CARS,
                                                   dtype=torch.int32),
        _params(), TEAMS, tick_skip=2, action_delay=1)
    assert calls == [1]
    assert arena_step_mod.arena_step.launches == before
    assert torch.equal(out.arena.tick_count, torch.full((2,), 2,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("kw", [dict(use_mesh=True),
                                dict(dynamic_wheel_rays=True),
                                dict(game_mode="heatseeker"),
                                dict(game_mode="snowday")])
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
                 respawn=4 * 3, curves=12 * (1 + 6 + 6 + 5 + 5))
    assert prm.size == sum(sizes.values())
    assert list(prm[:8]) == [0, 0, 1, 1, 0, 0, 0, 0]
    assert prm[8] == np.float32(1 / 120)


if __name__ == "__main__":
    regenerate()
