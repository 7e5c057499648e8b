"""The port's closed-form facet arena (reinforcement_learning_torch/physics/
facet_arena.py) and the full-fidelity helpers of its plain tick held live
against the JAX package's, on batches of points chosen near every kind of
surface: the walls and their fillets, the corners, the goal mouth and box,
the ceiling, the floor grid's seams, and a random volume.

The JAX functions run eagerly on the CPU.  Both sides compute in float32
with the same operations in the same order, so the tolerances only absorb
last-bit differences: 1e-3 uu for distances and points, 1e-5 for unit
normals; live flags must agree exactly.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.ops import ctick as tctick
from reinforcement_learning_torch.physics import facet_arena as tfa
from reinforcement_learning_tpu import constants as JC
from reinforcement_learning_tpu.ops import ctick as jctick
from reinforcement_learning_tpu.physics import facet_arena as jfa
from reinforcement_learning_tpu.physics import mesh as jmesh

torch.set_num_threads(1)

ATOL_LEN = 1e-3     # uu
ATOL_UNIT = 1e-5
HE = (59.00368, 42.099705, 18.079536)     # Octane hitbox half extents
OFF = (13.87566, 0.0, 20.75499)
BALL_R = 91.25


def _rotmats(rng, n):
    """Random proper rotations (float32), via QR of a normal matrix."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _surface_points(rng) -> np.ndarray:
    """(N, 3) float32: on and near the walls, fillets, corners, goal mouth
    and box, ceiling, floor seams and exact folds, plus a random volume."""
    ex, ey, h = JC.ARENA_EXTENT_X, JC.ARENA_EXTENT_Y, JC.ARENA_HEIGHT
    gw, gh, gd = JC.GOAL_HALF_WIDTH, JC.GOAL_HEIGHT, JC.GOAL_DEPTH
    u = rng.uniform
    pts = [
        # side walls, their fillets and the ceiling fillet
        np.stack([u(ex - 260, ex + 5, 40), u(-3000, 3000, 40),
                  u(0, h, 40)], -1),
        np.stack([u(ex - 200, ex, 30), u(-3000, 3000, 30),
                  u(0, 200, 30)], -1),
        np.stack([u(ex - 300, ex, 20), u(-3000, 3000, 20),
                  u(h - 300, h, 20)], -1),
        # corner walls (x + y = 8064) and where they meet the side walls
        np.stack([u(3000, 3900, 30), np.zeros(30), u(0, h, 30)], -1),
        np.stack([u(ex - 300, ex, 20), u(3700, 4100, 20),
                  u(0, 600, 20)], -1),
        # back wall, goal mouth, posts, crossbar, inside the goal box
        np.stack([u(-3000, 3000, 30), u(ey - 300, ey + 5, 30),
                  u(0, h, 30)], -1),
        np.stack([u(-gw - 150, gw + 150, 40), u(ey - 150, ey + 100, 40),
                  u(0, gh + 150, 40)], -1),
        np.stack([u(-gw + 10, gw - 10, 30), u(ey, ey + gd + 5, 30),
                  u(0, gh + 5, 30)], -1),
        # floor and ceiling grid seams (cell 1024), the folds x = 0, y = 0
        np.stack([1024.0 * rng.randint(-3, 4, 20) + u(-60, 60, 20),
                  u(-4000, 4000, 20), u(0, 200, 20)], -1),
        np.stack([np.zeros(10), u(-4000, 4000, 10), u(0, 300, 10)], -1),
        np.stack([u(-3000, 3000, 10), np.zeros(10), u(h - 300, h, 10)],
                 -1),
        # a random volume of the whole arena
        np.stack([u(-4300, 4300, 60), u(-6100, 6100, 60), u(0, h, 60)],
                 -1),
    ]
    p = np.concatenate(pts).astype(np.float32)
    # mirror a third of them into the other quadrants
    sgn = rng.choice([-1.0, 1.0], size=(len(p), 2)).astype(np.float32)
    p[:, :2] *= np.where(rng.uniform(size=(len(p), 1)) < 0.66, sgn, 1.0)
    return p


@pytest.fixture(scope="module")
def points():
    rng = np.random.RandomState(0)
    p = _surface_points(rng)
    return p, _rotmats(rng, len(p))


def _close(got, want, atol, name):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if w.dtype == bool:
            bad = np.argwhere(g != w)
            assert bad.size == 0, f"{name}[{i}] differs at {bad[:5]}"
        else:
            np.testing.assert_allclose(g, w, atol=atol[i], rtol=0,
                                       err_msg=f"{name}[{i}]")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot_tuple(R, lib):
    conv = _t if lib == "torch" else jnp.asarray
    return tuple(tuple(conv(R[:, i, j]) for j in range(3)) for i in range(3))


def test_tables_equal_the_jax_tables_exactly():
    want = jfa.build_tables()
    got = tfa.build_tables()
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    bands = tfa.band_table(got)
    for side in range(tfa.N_SIDES):
        for k, w in jfa._band_stack(want, side).items():
            # the port keeps the back wall's cut flags; sides 0, 1 have none
            g = bands[k] if (k != "has_cut" or side == 2) else 0 * bands[k]
            np.testing.assert_array_equal(g, w, err_msg=f"{side} {k}")


def test_mesh_geometry_constants_match():
    from reinforcement_learning_torch.physics import arena_geom
    assert arena_geom.FLOOR_FILLET_RADIUS == jmesh.FLOOR_FILLET_RADIUS
    assert arena_geom.CEILING_FILLET_RADIUS == jmesh.CEILING_FILLET_RADIUS
    np.testing.assert_array_equal(arena_geom.octagon_planes(),
                                  jmesh._octagon_planes())
    np.testing.assert_array_equal(
        arena_geom.z_samples(2048.0, 152.0, 256.0, 8),
        jmesh._z_samples(2048.0, 152.0, 256.0, 8))


def test_sphere_contacts_match(points):
    p, _ = points
    brk = JC.CONTACT_BREAK_FRAC * (BALL_R + JC.SPHERE_BOUND_EXTRA)
    want = jfa.sphere_contacts(*(jnp.asarray(p[:, i]) for i in range(3)),
                               BALL_R, brk)
    got = tfa.sphere_contacts(*(_t(p[:, i]) for i in range(3)), BALL_R, brk)
    assert got[0].shape == (tfa.SPHERE_ROWS, len(p))
    _close(got, want, [ATOL_UNIT] * 3 + [ATOL_LEN, None], "sphere")
    assert np.asarray(want[4]).any()


def test_box_contacts_match(points):
    p, R = points
    brk = TC.CONTACT_BREAK_FRAC * (float(np.linalg.norm(HE))
                                   + float(np.linalg.norm(OFF)))
    want = jfa.box_contacts(*(jnp.asarray(p[:, i]) for i in range(3)),
                            _rot_tuple(R, "jax"), HE, brk)
    got = tfa.box_contacts(*(_t(p[:, i]) for i in range(3)),
                           _rot_tuple(R, "torch"), HE, brk)
    assert got[0].shape == (tfa.BOX_ROWS, len(p))
    _close(got, want, [ATOL_UNIT] * 3 + [ATOL_LEN] * 4 + [None], "box")
    assert np.asarray(want[7]).any()


@pytest.mark.parametrize("sheet", ["floor", "ceiling"])
def test_sheet_contacts_match(points, sheet):
    p, R = points
    z0, up, inset = ((0.0, 1.0, 152.0) if sheet == "floor"
                     else (JC.ARENA_HEIGHT, -1.0, 256.0))
    p = p.copy()
    p[:, 2] = z0 + up * np.random.RandomState(4).uniform(-5, 80, len(p))
    dist_m = min(JC.MESH_COLLISION_MARGIN, 0.1 * min(HE))
    brk = JC.CONTACT_BREAK_FRAC * (float(np.linalg.norm(HE))
                                   + float(np.linalg.norm(OFF)))
    want = jfa.sheet_box_contacts(
        *(jnp.asarray(p[:, i]) for i in range(3)), _rot_tuple(R, "jax"),
        HE, OFF, z0, up, JC.MESH_COLLISION_MARGIN, dist_m, brk)
    got = tfa.sheet_box_contacts(
        *(_t(p[:, i]) for i in range(3)), _rot_tuple(R, "torch"), HE, OFF,
        z0, up, TC.MESH_COLLISION_MARGIN, dist_m, brk)
    for r, (g, w) in enumerate(zip(got, want)):
        _close(g, w, [ATOL_UNIT] * 3 + [ATOL_LEN] * 4 + [None],
               f"sheet box row {r}")
        _close([tfa.sheet_clip_ok(tfa.tables(), g[3], g[4], inset)],
               [jfa.sheet_clip_ok(jfa.tables(), w[3], w[4], inset)],
               [None], f"sheet clip row {r}")
    bg = JC.CONTACT_BREAK_FRAC * (BALL_R + JC.SPHERE_BOUND_EXTRA)
    want = jfa.sheet_sphere_contacts(
        *(jnp.asarray(p[:, i]) for i in range(3)), BALL_R, bg, z0, up)
    got = tfa.sheet_sphere_contacts(*(_t(p[:, i]) for i in range(3)),
                                    BALL_R, bg, z0, up)
    for r, (g, w) in enumerate(zip(got, want)):
        _close(g, w, [ATOL_UNIT] * 3 + [ATOL_LEN] * 3 + [None],
               f"sheet sphere row {r}")


def test_raycasts_match(points):
    p, R = points
    # the wheel rays: along each box's -up, plus random directions
    d = -R[:, :, 2]
    rng = np.random.RandomState(5)
    d2 = rng.normal(size=d.shape)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d = np.concatenate([d, d2.astype(np.float32)])
    o = np.concatenate([p, p])
    want = jfa.raycasts(*(jnp.asarray(o[:, i]) for i in range(3)),
                        *(jnp.asarray(d[:, i]) for i in range(3)), 120.0)
    got = tfa.raycasts(*(_t(o[:, i]) for i in range(3)),
                       *(_t(d[:, i]) for i in range(3)), 120.0)
    _close(got, want, [ATOL_LEN] + [ATOL_UNIT] * 3 + [None], "raycasts")
    assert np.asarray(want[4]).sum() > 20


def test_ray_sphere_and_obb_match():
    rng = np.random.RandomState(6)
    n = 400
    o = rng.uniform(-150, 150, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    # aim half the rays at the origin, where the bodies sit
    aim = -o / np.linalg.norm(o, axis=0)
    d[:, ::2] = aim[:, ::2].astype(np.float32)
    d[:, 1::7] = np.array([[0.0], [0.0], [-1.0]], np.float32)  # axis rays
    c = rng.uniform(-10, 10, (3, n)).astype(np.float32)
    R = _rotmats(rng, n)
    R[::5] = np.eye(3, dtype=np.float32)
    jv = lambda a: tuple(jnp.asarray(x) for x in a)  # noqa: E731
    tv = lambda a: tuple(_t(x) for x in a)  # noqa: E731
    want = jctick._ray_sphere_k(jv(o), jv(d), 200.0, jv(c), BALL_R)
    got = tctick._ray_sphere(tv(o), tv(d), 200.0, tv(c), BALL_R)
    _close(got, want, [None, ATOL_LEN], "ray_sphere")
    assert np.asarray(want[0]).sum() > 50
    hit, t, nrm = jctick._ray_obb_k(jv(o), jv(d), 200.0, jv(c),
                                    _rot_tuple(R, "jax"), HE)
    ghit, gt, gn = tctick._ray_obb(tv(o), tv(d), 200.0, tv(c),
                                   _rot_tuple(R, "torch"), HE)
    _close([ghit, gt, *gn], [hit, t, *nrm], [None, ATOL_LEN] + [ATOL_UNIT] * 3,
           "ray_obb")
    assert np.asarray(hit).sum() > 50


@pytest.mark.parametrize("case", ["ties", "many_live", "few_live", "none"])
def test_keep_diverse4_matches(case):
    rng = np.random.RandomState({"ties": 1, "many_live": 2, "few_live": 3,
                                 "none": 4}[case])
    K, n = 24, 64
    d = rng.uniform(-5, 5, (K, n)).astype(np.float32)
    pts = rng.uniform(-50, 50, (3, K, n)).astype(np.float32)
    live = rng.uniform(size=(K, n)) < {"ties": 0.7, "many_live": 0.8,
                                       "few_live": 0.12, "none": 0.0}[case]
    if case == "ties":
        # equal depths and duplicated points: ties go to the lowest index
        d = np.round(d).astype(np.float32)
        pts[:, K // 2:] = pts[:, :K // 2]
        d[K // 2:] = d[:K // 2]
    d = np.where(live, d, np.float32(1e30))
    pays = [rng.uniform(-1, 1, (K, n)).astype(np.float32) for _ in range(2)]
    pays.append(d)
    want = jctick._keep_diverse4_stacked(
        jnp.asarray(d), [jnp.asarray(a) for a in pays],
        *(jnp.asarray(x) for x in pts))
    got = tctick.keep_diverse4(_t(d), [_t(a) for a in pays],
                               *(_t(x) for x in pts))
    for s in range(4):
        np.testing.assert_array_equal(np.asarray(got[1][s]),
                                      np.asarray(want[1][s]))
        np.testing.assert_array_equal(np.asarray(got[0][s]),
                                      np.asarray(want[0][s]))
        for g, w in zip(got[2][s], want[2][s]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if case in ("ties", "many_live"):
        assert np.asarray(want[1][3]).all()
