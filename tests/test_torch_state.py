"""The PyTorch port's state, constants and layouts against the JAX package.

Also holds the helpers the other ``test_torch_*`` files use to carry JAX
trees across to the port (through numpy, field by field).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch import maths as tmaths
from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import AdvancedObs
from reinforcement_learning_torch.ops import arena_step as tarena
from reinforcement_learning_torch.ops import pack as tpack
from reinforcement_learning_torch.physics import arena_geom as tgeom
from reinforcement_learning_torch.physics import formulas as tformulas
from reinforcement_learning_torch.physics import state as tstate
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_tpu import constants as JC
from reinforcement_learning_tpu import maths as jmaths
from reinforcement_learning_tpu.physics import arena_geom as jgeom
from reinforcement_learning_tpu.physics import formulas as jformulas
from reinforcement_learning_tpu.physics import step as jstep

torch.set_num_threads(1)

E, CARS = 8, 4


# ---------------------------------------------------------------------------
# helpers shared by the test_torch_* files

def flatten(obj, prefix="") -> dict:
    """Dataclass tree (JAX or port) -> {dotted field name: numpy array}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, name + "."))
        elif isinstance(v, dict):
            for k, x in v.items():
                out[f"{name}.{k}"] = np.asarray(x)
        else:
            out[name] = np.asarray(v)
    return out


def jax_to_torch(src, like):
    """Copy the JAX tree ``src`` into the structure of the port tree
    ``like``, field by field by name, through numpy."""
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: jax_to_torch(getattr(src, f.name),
                                                  getattr(like, f.name))
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: jax_to_torch(src[k], v) for k, v in like.items()}
    return torch.from_numpy(np.array(src)).to(like.dtype)


def plane_params_jax(num_cars=CARS):
    return jstep.ArenaParams(num_cars=num_cars, use_mesh=False,
                             dynamic_wheel_rays=False)


def plane_params_torch(num_cars=CARS):
    return tstep.ArenaParams(num_cars=num_cars, use_mesh=False,
                             dynamic_wheel_rays=False)


def random_phys_torch(seed: int) -> tstep.PhysicsState:
    """A batched port state with random values in every field."""
    rng = np.random.RandomState(seed)
    phys = tstep.make_physics_state(plane_params_torch(), batch=(E,),
                                    device="cpu")

    def fill(t):
        if t.dtype == torch.bool:
            return torch.from_numpy(rng.uniform(size=t.shape) > 0.5)
        if t.dtype == torch.int32:
            return torch.from_numpy(
                rng.randint(-50, 50, size=t.shape).astype(np.int32))
        return torch.from_numpy(
            rng.uniform(-100, 100, size=t.shape).astype(np.float32))
    return tree_map(fill, phys)


# ---------------------------------------------------------------------------

def _const_items(mod):
    for name in dir(mod):
        if name.startswith("_"):
            continue
        v = getattr(mod, name)
        if isinstance(v, type):
            for sub in dir(v):
                if not sub.startswith("_"):
                    yield f"{name}.{sub}", getattr(v, sub)
        elif not callable(v) and not hasattr(v, "__file__"):
            yield name, v


def test_constants_equal_by_name():
    jax_items = dict(_const_items(JC))
    port_items = dict(_const_items(TC))
    assert set(jax_items) == set(port_items)
    for name, v in jax_items.items():
        w = port_items[name]
        if isinstance(v, tuple) and v and isinstance(v[0], (list, tuple)):
            v, w = [np.asarray(x) for x in v], [np.asarray(x) for x in w]
            assert all(np.array_equal(a, b) for a, b in zip(v, w)), name
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w),
                                          err_msg=name)
    assert TC.kph_to_vel(110) == JC.kph_to_vel(110)


def test_formulas_and_plane_table_equal():
    size = np.asarray(JC.HITBOX_SIZES[JC.OCTANE], np.float64)
    np.testing.assert_array_equal(
        tformulas.box_inv_inertia_diag_bt(JC.CAR_MASS_BT, size),
        jformulas.box_inv_inertia_diag_bt(JC.CAR_MASS_BT, size))
    np.testing.assert_array_equal(
        tformulas.box_effective_half_extents_bt(size),
        jformulas.box_effective_half_extents_bt(size))
    assert (tformulas.sphere_inertia_bt(30.0, 91.25)
            == jformulas.sphere_inertia_bt(30.0, 91.25))
    np.testing.assert_array_equal(tgeom._PLANES, jgeom._PLANES)
    np.testing.assert_array_equal(tgeom._TRUE_PLANE, jgeom._TRUE_PLANE)
    for name in ("FLOOR", "WALL_YN", "WALL_YP", "GOAL_XN", "GOAL_XP",
                 "GOAL_CEIL", "NET_YN", "NET_YP", "NUM_PLANES"):
        assert getattr(tgeom, name) == getattr(jgeom, name), name


def test_euler_to_rotmat_matches():
    rng = np.random.RandomState(0)
    ypr = rng.uniform(-3, 3, (3, 16)).astype(np.float32)
    want = np.asarray(jmaths.euler_to_rotmat(*map(jnp.asarray, ypr)))
    got = tmaths.euler_to_rotmat(*map(torch.from_numpy, ypr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_make_physics_state_equal_field_by_field():
    want = flatten(jax.vmap(lambda _: jstep.make_physics_state(
        plane_params_jax()))(jnp.arange(E)))
    got = flatten(tstep.make_physics_state(plane_params_torch(),
                                           batch=(E,), device="cpu"))
    assert set(want) == set(got)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_jax_state_carried_across_round_trips():
    jphys = jax.vmap(lambda _: jstep.make_physics_state(
        plane_params_jax()))(jnp.arange(E))
    jphys = jax.tree.map(lambda x: x + jnp.ones_like(x) if x.dtype
                         == jnp.float32 else x, jphys)
    like = tstep.make_physics_state(plane_params_torch(), batch=(E,),
                                    device="cpu")
    back = flatten(jax_to_torch(jphys, like))
    for name, w in flatten(jphys).items():
        np.testing.assert_array_equal(back[name], w, err_msg=name)


def test_pack_components_round_trip():
    phys = random_phys_torch(1)
    back = tpack.from_components(tpack.to_components(phys))
    want, got = flatten(phys), flatten(back)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_kernel_buffers_round_trip():
    """The kernel's struct-of-arrays buffers hold every field of the state
    (the kernel itself clears the per-step latches and goal flag)."""
    phys = random_phys_torch(2)
    f, i, u = tarena._pack(phys)
    assert f.shape == (tarena.CAR_F * CARS + tarena.BALL_F + tarena.NPADS, E)
    assert i.shape == (tarena.CAR_I * CARS + 1 + tarena.NPADS, E)
    assert u.shape == (tarena.CAR_U * CARS + 1 + tarena.NPADS, E)
    assert (f.dtype, i.dtype, u.dtype) == (torch.float32, torch.int32,
                                           torch.uint8)
    want, got = flatten(phys), flatten(tarena._unpack(f, i, u, E, CARS))
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("row", [0, 5, 17, 40, 71])
def test_kernel_buffer_rows_follow_field_order(row):
    """Row ``r*C + c`` of the f32 buffer is field r of car c, in the order
    the kernel's ``CarF`` enum lists them."""
    phys = random_phys_torch(3)
    f, _, _ = tarena._pack(phys)
    cars, wc = phys.arena.cars, phys.wheels
    fields = ([getattr(cars, n) for n in tarena.CAR_SCALARS_F32]
              + [getattr(cars, n)[..., k] for n in tarena.CAR_VECS
                 for k in range(3)]
              + [cars.rot[..., a, b] for a in range(3) for b in range(3)]
              + [cars.last_controls[..., k] for k in range(8)]
              + [cars.controls[..., k] for k in range(8)]
              + [wc.steer_angle, wc.engine_force, wc.brake]
              + [wc.lat_friction[..., k] for k in range(4)]
              + [wc.long_friction[..., k] for k in range(4)])
    assert len(fields) == tarena.CAR_F
    for c in range(CARS):
        torch.testing.assert_close(f[row * CARS + c], fields[row][:, c],
                                   rtol=0, atol=0)


def test_clamp_controls_matches():
    rng = np.random.RandomState(4)
    ctl = rng.uniform(-2, 2, (E, CARS, 8)).astype(np.float32)
    want = np.asarray(jstep.clamp_controls(jnp.asarray(ctl)))
    got = tstep.clamp_controls(torch.from_numpy(ctl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make, probe", [
    (lambda: tstep.make_physics_state(plane_params_torch()),
     lambda made: made.arena.cars.pos),
    (lambda: tstate.make_arena_state(CARS), lambda made: made.cars.pos),
    (lambda: AdvancedObs(CARS, np.array([0, 0, 1, 1])),
     lambda made: made.order),
    (lambda: DefaultAction(), lambda made: made.table),
], ids=["make_physics_state", "make_arena_state", "AdvancedObs",
        "DefaultAction"])
def test_constructors_default_to_cuda(make, probe):
    """Without a device they build on the card, and raise where there is
    none: nothing lands on the CPU unasked."""
    if torch.cuda.is_available():
        assert probe(make()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
