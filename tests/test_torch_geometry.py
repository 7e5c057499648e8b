"""The port's arena geometry held against the JAX package's: the maths
helpers, the exact box-box detector (physics/box_box.py), the box-triangle
narrowphase (physics/box_tri.py), the mesh I/O, procedural arenas, bake and
queries (physics/mesh.py), the analytic planes (physics/arena_geom.py) and
the world registry (physics/world.py).

The tests of tests/test_box_box.py, test_box_tri.py and test_mesh.py are
mirrored on the port, and beside them every function takes the same seeded
numpy inputs on both sides, the JAX one on the CPU (jitted, or eagerly
where XLA's fusion moves the result beyond the last bits).  Both
compute in float32 with the same operations, so the tolerances absorb only
last-bit differences: 1e-3 uu on distances and points at arena scale,
1e-5 on unit vectors and body-scale lengths; flags agree exactly except
where the depth itself is within that tolerance of 0.  The host-side bakes
(procedural meshes, internal-edge info, BVH order, the grid) run the same
numpy code, and their arrays are bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch import maths as tm
from reinforcement_learning_torch.physics import arena_geom as tgeom
from reinforcement_learning_torch.physics import box_box as tbb
from reinforcement_learning_torch.physics import box_tri as tbt
from reinforcement_learning_torch.physics import mesh as tmesh
from reinforcement_learning_torch.physics import world as tworld
from reinforcement_learning_tpu import maths as jm
from reinforcement_learning_tpu.physics import arena_geom as jgeom
from reinforcement_learning_tpu.physics import box_box as jbb
from reinforcement_learning_tpu.physics import box_tri as jbt
from reinforcement_learning_tpu.physics import mesh as jmesh

torch.set_num_threads(1)

ATOL_LEN = 1e-3    # uu, arena-scale lengths
ATOL_UNIT = 1e-5   # unit vectors, body-scale lengths
I3 = torch.eye(3)
HE = torch.tensor([1.2, 0.85, 0.38])


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _rand_rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _rand_rots(rng, n):
    return np.stack([_rand_rot(rng) for _ in range(n)]).astype(np.float32)


# ---------------------------------------------------------------------------
# maths

def _maths_inputs(rng, n=64):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(a=f(n, 3) * 3, b=f(n, 3) * 3, R=_rand_rots(rng, n),
                w=f(n, 3) * 4, x=rng.uniform(-500, 2800, n).astype(
                    np.float32))


MATHS = {
    "cross": lambda M, d: M.cross(d["a"], d["b"]),
    "clamp_norm": lambda M, d: M.clamp_norm(d["a"], 2.5),
    "rotmat_forward": lambda M, d: M.rotmat_forward(d["R"]),
    "rotmat_right": lambda M, d: M.rotmat_right(d["R"]),
    "rotmat_up": lambda M, d: M.rotmat_up(d["R"]),
    "rotmat_to_euler": lambda M, d: M.rotmat_to_euler(d["R"]),
    "rotate": lambda M, d: M.rotate(d["R"], d["a"]),
    "inv_rotate": lambda M, d: M.inv_rotate(d["R"], d["a"]),
    "curve": lambda M, d: M.curve(TC.STEER_ANGLE_FROM_SPEED_CURVE, d["x"]),
    "orthonormalize": lambda M, d: M.orthonormalize(d["R"] + 0.05 * d["R"]
                                                    @ d["R"]),
    "integrate_rotation": lambda M, d: M.integrate_rotation(
        d["R"], d["w"], 1.0 / 120.0),
}


@pytest.mark.parametrize("name", sorted(MATHS))
def test_maths_matches_jax(name):
    """Each of the 11 functions on the same inputs, to 1e-5 (the curve's
    table values to 1e-6 relative)."""
    d = _maths_inputs(np.random.default_rng(0))
    got = MATHS[name](tm, {k: t(v) for k, v in d.items()})
    want = MATHS[name](jm, {k: j(v) for k, v in d.items()})
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, ATOL_UNIT, 1e-6)


# ---------------------------------------------------------------------------
# box_box: test_box_box.py mirrored, and the exact detector against JAX's

def test_face_overlap_four_corners():
    """Axis-aligned face overlap: 4 points on the incident face with the
    shared depth, normal along +x (box1 -> box2)."""
    mf = tbb.box_box_manifold(torch.zeros(1, 3), I3[None], HE,
                              torch.tensor([[2.3, 0.0, 0.0]]), I3[None], HE)
    assert bool(mf["overlap"][0])
    close(mf["normal"][0], [1, 0, 0], 1e-6)
    assert bool(mf["active"][0].all())
    close(mf["depth"][0], np.full(4, 0.1), 1e-5)
    close(mf["points"][0][:, 0], np.full(4, 1.1), 1e-5)


def test_separated():
    mf = tbb.box_box_manifold(torch.zeros(1, 3), I3[None], HE,
                              torch.tensor([[2.5, 0.0, 0.0]]), I3[None], HE)
    assert not bool(mf["overlap"][0])
    assert not bool(mf["active"][0].any())


def test_edge_case_single_point():
    """Edge-edge contacts (code > 6) give exactly one point, with a unit
    normal; at least 5 such cases in 300 random placements."""
    rng = np.random.default_rng(3)
    n = 300
    he = torch.tensor([0.4, 0.4, 0.4])
    p2 = t(rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32))
    R1, R2 = t(_rand_rots(rng, n)), t(_rand_rots(rng, n))
    mf = tbb.box_box_manifold(torch.zeros(n, 3), R1, he, p2, R2, he)
    edge = mf["overlap"] & (mf["code"] > 6)
    assert int(edge.sum()) >= 5, int(edge.sum())
    act = mf["active"][edge]
    assert bool(act[:, 0].all()) and not bool(act[:, 1:].any())
    close(torch.linalg.norm(mf["normal"][edge], dim=-1), 1.0, 1e-5)


def test_depth_convention_positionA():
    """positionWorldOnA = point + normal * depth lies on box1's reference
    face for face codes <= 3."""
    mf = tbb.box_box_manifold(torch.zeros(1, 3), I3[None], HE,
                              torch.tensor([[2.3, 0.1, 0.05]]), I3[None], HE)
    posA = mf["points"][0] + mf["normal"][0][None] * mf["depth"][0][:, None]
    close(posA[mf["active"][0]][:, 0], 1.2, 1e-5)


def test_clamped_components_matches_exact():
    """The kernel route's clamped variant agrees with the exact detector
    on overlap and normal, and on the largest depth for shallow contacts
    (< 0.15), over 120 random placements."""
    rng = np.random.default_rng(7)
    he = (1.2, 0.85, 0.38)
    draws = []
    for _ in range(120):    # the JAX test's draws, in its order
        a = rng.uniform(-1, 1, 3)
        draws.append((a, a + rng.uniform(-2.2, 2.2, 3), _rand_rot(rng),
                      _rand_rot(rng)))
    p1, p2, R1, R2 = (np.stack(x).astype(np.float32) for x in zip(*draws))
    mf = tbb.box_box_manifold(t(p1), t(R1), torch.tensor(he), t(p2), t(R2),
                              torch.tensor(he))
    vec = lambda p: tuple(t(p[:, k]) for k in range(3))
    mat = lambda R: tuple(tuple(t(R[:, r, c]) for c in range(3))
                          for r in range(3))
    mfc = tbb.box_box_clamped_components(vec(p1), mat(R1), he, vec(p2),
                                         mat(R2), he)
    assert torch.equal(mf["overlap"], mfc["overlap"])
    ov = mf["overlap"]
    assert int(ov.sum()) > 30
    close(mf["normal"][ov], torch.stack(mfc["normal"], -1)[ov], 1e-5)
    d1 = torch.where(mf["active"], mf["depth"], -torch.inf).amax(-1)
    d2 = torch.where(torch.stack(mfc["active"], -1),
                     torch.stack(mfc["depth"], -1), -torch.inf).amax(-1)
    shallow = ov & (d1 < 0.15)
    close(d1[shallow], d2[shallow], 1e-5)


def _one_tick(phys, controls, teams, params):
    from reinforcement_learning_torch.ops import arena_step as A
    n = phys.arena.cars.pos.shape[1]
    return A.arena_step(phys, controls, torch.zeros(1, n, dtype=torch.int32),
                        params, teams, tick_skip=1, action_delay=0)


def test_bump_angular_response():
    """A head-on bump through the port's plain tick (plane arena, the
    kernel route's box-box) gives the bumper the reference's pitch
    response (oracle car_bump: about -0.67 rad/s; the JAX test asks for
    more than 0.2)."""
    from reinforcement_learning_torch.physics.step import (ArenaParams,
                                                           make_physics_state)
    params = ArenaParams(num_cars=2, use_mesh=False,
                         dynamic_wheel_rays=False)
    phys = make_physics_state(params, batch=(1,), device="cpu")
    cars = phys.arena.cars
    cars.pos = torch.tensor([[[0.0, 0.0, 17.01], [500.0, 0.0, 17.01]]])
    cars.vel = torch.tensor([[[1600.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    cars.rot = torch.stack([torch.eye(3),
                            torch.diag(torch.tensor([-1.0, -1.0, 1.0]))])[None]
    controls = torch.zeros(1, 2, 8)
    controls[..., 0] = 1.0
    hit_ang = None
    for _ in range(40):
        phys = _one_tick(phys, controls, (0, 1), params)
        if float(phys.arena.cars.vel[0, 1, 0]) > 100.0 and hit_ang is None:
            hit_ang = phys.arena.cars.ang_vel[0].clone()
    assert hit_ang is not None, "cars never collided"
    assert abs(float(hit_ang[0, 1])) > 0.2, hit_ang


def test_pad_lock_hysteresis():
    """A car parked on a pad: the pickup locks the pad, and the reference's
    AABB quirk (BoostPad.cpp:62-86: the pad's volume starts above a
    grounded car's hitbox) makes the lock oscillate tick by tick, through
    the port's plain tick."""
    from reinforcement_learning_torch.physics.step import (ArenaParams,
                                                           make_physics_state)
    params = ArenaParams(num_cars=1, use_mesh=False,
                         dynamic_wheel_rays=False)
    phys = make_physics_state(params, batch=(1,), device="cpu")
    pad = TC.BOOST_PAD_LOCS_SOCCAR[0]
    phys.arena.cars.pos = torch.tensor([[[pad[0], pad[1], 17.01]]],
                                       dtype=torch.float32)
    phys.arena.cars.boost = torch.zeros(1, 1)
    controls = torch.zeros(1, 1, 8)
    phys = _one_tick(phys, controls, (0,), params)
    assert int(phys.arena.pads.prev_locked[0, 0]) == 1
    assert float(phys.arena.cars.boost[0, 0]) > 0.0
    assert not bool(phys.arena.pads.is_active[0, 0])
    phys = _one_tick(phys, controls, (0,), params)
    assert int(phys.arena.pads.prev_locked[0, 0]) == 0
    phys = _one_tick(phys, controls, (0,), params)
    assert int(phys.arena.pads.prev_locked[0, 0]) == 1


def test_box_box_manifold_matches_jax():
    """512 random placements of two car-sized boxes (body scale, bt units),
    three in four overlapping: every output against the JAX detector;
    codes and slots exactly, points, depths and normals to 1e-5."""
    rng = np.random.default_rng(11)
    n = 512
    he1 = rng.uniform(0.3, 1.3, (n, 3)).astype(np.float32)
    he2 = rng.uniform(0.3, 1.3, (n, 3)).astype(np.float32)
    p1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p2 = (p1 + rng.uniform(-2.0, 2.0, (n, 3))).astype(np.float32)
    R1, R2 = _rand_rots(rng, n), _rand_rots(rng, n)
    got = tbb.box_box_manifold(t(p1), t(R1), t(he1), t(p2), t(R2), t(he2))
    want = jax.jit(jbb.box_box_manifold)(j(p1), j(R1), j(he1), j(p2), j(R2),
                                         j(he2))
    for k in ("code", "active", "overlap"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["overlap"].sum()) > n // 2
    act = got["active"].numpy()
    close(got["normal"], want["normal"], ATOL_UNIT)
    close(got["depth"].numpy()[act], np.asarray(want["depth"])[act],
          ATOL_UNIT)
    close(got["points"].numpy()[act], np.asarray(want["points"])[act],
          ATOL_UNIT)
    # more than 4 clipped points were culled somewhere
    assert int((got["code"] <= 6).sum()) > 0


# ---------------------------------------------------------------------------
# box_tri: test_box_tri.py mirrored, and against JAX

def _sample_tri(tv, n=60):
    u = np.linspace(0, 1, n)
    uu, vv = np.meshgrid(u, u)
    mask = uu + vv <= 1
    uu, vv = uu[mask], vv[mask]
    return tv[0] + np.outer(uu, tv[1] - tv[0]) + np.outer(vv, tv[2] - tv[0])


def _box_tri_inputs(rng, n=64):
    he = rng.uniform(0.3, 2.0, (n, 3)).astype(np.float32)
    tv = rng.uniform(-4, 4, (n, 3, 3)).astype(np.float32)
    return he, tv


def test_closest_pair_and_sat_vs_bruteforce():
    """The closest pair lower-bounds a dense sampling of the triangle, and
    the separating-axis push separates it."""
    he, tv = _box_tri_inputs(np.random.default_rng(0))
    v0, v1, v2 = (t(tv[:, i]) for i in range(3))
    pb, pt, dist = tbt.closest_pair_box_triangle(t(he), v0, v1, v2)
    ov, mtv, pen = tbt.sat_box_triangle(t(he), v0, v1, v2)
    pb, dist, ov, mtv, pen = (x.numpy() for x in (pb, dist, ov, mtv, pen))
    for i in range(len(he)):
        pts = _sample_tri(tv[i])
        h = he[i]
        d_sampled = np.linalg.norm(pts - np.clip(pts, -h, h), axis=1).min()
        if ov[i]:
            shifted = pts - mtv[i] * (pen[i] + 1e-4)
            assert not np.all(np.abs(shifted) <= h + 1e-6, axis=1).any()
        else:
            assert dist[i] <= d_sampled + 1e-5
            assert dist[i] >= d_sampled - 0.15
            assert np.all(np.abs(pb[i]) <= h + 1e-4)


def test_contact_on_flat_floor_matches_bullet_probe():
    """An unrotated box over a floor triangle: bullet's measured distances
    (core = he - 0.04, less the 0.03616 safe margin), to 2e-3."""
    he = torch.tensor([1.1801, 0.8420, 0.3616])
    tri = (torch.tensor([0.0, -10.0, 0.0]), torch.tensor([20.48, -10.0, 0.0]),
           torch.tensor([20.48, 10.48, 0.0]))
    for z, want in [(0.45, 0.092240), (0.40, 0.042240), (0.3616, 0.003840),
                    (0.30, -0.057754)]:
        n, pt, dist = tbt.box_triangle_contact(
            torch.tensor([15.0, -2.0, z]), torch.eye(3), he, 0.04, 0.03616,
            *tri)
        assert abs(float(dist) - want) < 2e-3, (z, float(dist), want)
        assert float(n[2]) > 0.99


def test_box_tri_matches_jax():
    """closest_pair_box_triangle, sat_box_triangle and box_triangle_contact
    on the same 256 boxes and triangles (body scale): flags exactly, the
    rest to 1e-5 (1e-4 where a 47-way or 13-way choice is within that of a
    tie, which the flags and distances still pin)."""
    rng = np.random.default_rng(5)
    he, tv = _box_tri_inputs(rng, 256)
    v = [tv[:, i] for i in range(3)]
    got = tbt.closest_pair_box_triangle(t(he), *map(t, v))
    want = jax.jit(jbt.closest_pair_box_triangle)(j(he), *map(j, v))
    close(got[2], want[2], ATOL_UNIT)
    sep = got[2].numpy() > 1e-3
    for g, w in zip(got[:2], want[:2]):
        close(g.numpy()[sep], np.asarray(w)[sep], 1e-4)
    got = tbt.sat_box_triangle(t(he), *map(t, v))
    want = jax.jit(jbt.sat_box_triangle)(j(he), *map(j, v))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[2], want[2], ATOL_UNIT)
    close(got[1], want[1], ATOL_UNIT)

    pos = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    rot = _rand_rots(rng, 256)
    args = (0.04, 0.03616)
    got = tbt.box_triangle_contact(t(pos), t(rot), t(he), *args,
                                   *map(t, v))
    want = jax.jit(jbt.box_triangle_contact, static_argnums=(3, 4))(
        j(pos), j(rot), j(he), *args, *map(j, v))
    for g, w in zip(got, want):
        close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# mesh: test_mesh.py mirrored, the bake bit-equal, the queries against JAX

@pytest.fixture(scope="module")
def soccar():
    return tmesh.build_soccar_mesh()


@pytest.fixture(scope="module")
def grid(soccar):
    return tmesh.MeshGrid.bake(*soccar)


@pytest.fixture(scope="module")
def grids():
    """The arenas as load_arena_mesh serves them (BVH order), port and
    JAX."""
    return {mode: (tmesh.load_arena_mesh(game_mode=mode, device="cpu"),
                   jmesh.load_arena_mesh(game_mode=mode))
            for mode in ("soccar", "hoops")}


def test_cmf_roundtrip(tmp_path, soccar):
    """write_cmf/read_cmf round trip, across the two packages both ways."""
    verts, tris = soccar
    p = str(tmp_path / "mesh.cmf")
    tmesh.write_cmf(p, verts, tris)
    for read in (tmesh.read_cmf, jmesh.read_cmf):
        v2, t2 = read(p)
        assert np.array_equal(v2, verts.astype(np.float32))
        assert np.array_equal(t2, tris.astype(np.int32))
    q = str(tmp_path / "jax.cmf")
    jmesh.write_cmf(q, verts, tris)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert tmesh.cmf_hash(*tmesh.read_cmf(p)) == tmesh.cmf_hash(verts, tris)


def test_cmf_hash_known_value(soccar):
    """The hash equals the JAX package's on a tiny mesh and on the soccar
    arena, and the hash sets are the same."""
    verts = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    h = tmesh.cmf_hash(verts, tris)
    assert 0 <= h < 2**32
    assert h == jmesh.cmf_hash(verts, tris)
    assert tmesh.cmf_hash(*soccar) == jmesh.cmf_hash(*soccar)
    assert tmesh.SOCCAR_ARENA_MESH_HASHES == jmesh.SOCCAR_ARENA_MESH_HASHES
    assert tmesh.HOOPS_ARENA_MESH_HASHES == jmesh.HOOPS_ARENA_MESH_HASHES


def test_soccar_mesh_sane(soccar):
    verts, tris = soccar
    assert len(verts) > 100 and len(tris) > 200
    assert tris.min() >= 0 and tris.max() < len(verts)
    assert np.isclose(abs(verts[:, 0]).max(), TC.ARENA_EXTENT_X)
    assert np.isclose(abs(verts[:, 1]).max(),
                      TC.ARENA_EXTENT_Y + TC.GOAL_DEPTH)
    assert np.isclose(verts[:, 2].min(), 0.0)
    assert np.isclose(verts[:, 2].max(), TC.ARENA_HEIGHT)
    a = verts[tris[:, 0]]
    areas = 0.5 * np.linalg.norm(np.cross(verts[tris[:, 1]] - a,
                                          verts[tris[:, 2]] - a), axis=-1)
    assert areas.min() > 1.0


@pytest.mark.parametrize("mode", ["soccar", "hoops"])
def test_procedural_mesh_and_bake_bit_equal(mode, grids):
    """The procedural mesh, its internal-edge info, BVH order and the
    baked grid equal the JAX package's bit for bit."""
    build = {"soccar": (tmesh.build_soccar_mesh, jmesh.build_soccar_mesh),
             "hoops": (tmesh.build_hoops_mesh, jmesh.build_hoops_mesh)}[mode]
    (tv, tt), (jv, jt) = build[0](), build[1]()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tmesh.bvh_leaf_order(tv / 50.0, tt),
                                  jmesh.bvh_leaf_order(jv / 50.0, jt))
    tg, jg = grids[mode]
    assert tg.margin == jg.margin
    for name in ("tri_a", "edge_ab", "edge_ac", "normal", "cells", "origin",
                 "inv_cell", "tri_mid", "tri_half", "edge_internal",
                 "edge_angle", "edge_nb", "edge_convex"):
        got, want = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_sphere_contact_matches_planes_on_flat(grid):
    r = TC.BALL_COLLISION_RADIUS_SOCCAR
    queries = torch.tensor([
        [0, 0, r - 5.0],
        [TC.ARENA_EXTENT_X - r + 3.0, 1000, 800],
        [2500, TC.ARENA_EXTENT_Y - r + 2.0, 900],
        [-700, -1200, TC.ARENA_HEIGHT - r + 4.0],
    ])
    n_m, d_m, a_m = grid.sphere_contacts(queries, r)
    n_p, d_p, a_p = tgeom.sphere_contacts(queries, r)
    for q in range(len(queries)):
        dm = torch.where(a_m[q], d_m[q], -torch.inf)
        dp = torch.where(a_p[q], d_p[q], -torch.inf)
        im, ip = int(dm.argmax()), int(dp.argmax())
        assert float(dm[im]) > 0, f"query {q}: mesh found no contact"
        close(dm[im], dp[ip], 1e-3)
        close(n_m[q][im], n_p[q][ip], 1e-4)


def test_sphere_no_contact_midair(grid):
    _, _, act = grid.sphere_contacts(torch.tensor([0.0, 0.0, 500.0]), 92.0)
    assert not bool(act.any())


def test_fillet_is_curved(grid):
    """In the floor->wall fillet the mesh's contact normal is slanted."""
    x = TC.ARENA_EXTENT_X - tgeom.FLOOR_FILLET_RADIUS * 0.3
    n, d, act = grid.sphere_contacts(torch.tensor([x, 0.0, 40.0]), 60.0)
    assert bool(act.any())
    nk = n[int(torch.where(act, d, -torch.inf).argmax())]
    assert 0.05 < abs(float(nk[0])) and 0.05 < abs(float(nk[2]))


def test_raycast_down_matches_planes(grid):
    starts = torch.tensor([[0, 0, 80.0], [1500, -2000, 50.0]])
    dirs = torch.tensor([0.0, 0.0, -1.0]).expand(2, 3)
    hit, dist, n = grid.raycast(starts, dirs, 120.0)
    hit_p, dist_p, n_p = tgeom.raycast_down_dir(starts, dirs, 120.0)
    assert torch.equal(hit, hit_p)
    close(dist, dist_p, 1e-3)
    close(n, n_p, 1e-4)


def test_raycast_miss(grid):
    hit, dist, _ = grid.raycast(torch.tensor([0.0, 0.0, 1000.0]),
                                torch.tensor([0.0, 0.0, -1.0]), 100.0)
    assert not bool(hit)
    close(dist, 100.0, 0.0)


def test_box_contacts_on_floor(grid):
    pos = torch.tensor([[100.0, 200.0, 15.0]])
    rot = torch.eye(3).expand(1, 3, 3)
    he = torch.tensor([[60.0, 40.0, 18.0]])
    n, p, d, act = grid.box_contacts(pos, rot, he)
    _, _, d_p, act_p = tgeom.box_contacts(pos, rot, he)
    dm = torch.where(act[0], d[0], -torch.inf)
    dp = torch.where(act_p[0], d_p[0], -torch.inf)
    assert float(dm.max()) > 0
    close(dm.max(), dp.max(), 1e-3)
    close(n[0][int(dm.argmax())], [0, 0, 1], 1e-5)


def test_goal_opening_is_open(grid):
    """A ball in the goal mouth touches nothing; the back of the net is
    solid."""
    r = TC.BALL_COLLISION_RADIUS_SOCCAR
    mouth = torch.tensor([0.0, TC.ARENA_EXTENT_Y + 100.0, 200.0])
    assert not bool(grid.sphere_contacts(mouth, r)[2].any())
    net = torch.tensor([0.0, TC.ARENA_EXTENT_Y + TC.GOAL_DEPTH - r + 5.0,
                        200.0])
    n, d, act = grid.sphere_contacts(net, r)
    assert bool(act.any())
    close(n[int(torch.where(act, d, -torch.inf).argmax())], [0, -1, 0], 1e-4)


def test_load_arena_mesh_roundtrip(tmp_path, soccar):
    """load_arena_mesh merges a folder of .cmf files, checks their hashes
    on request, and bakes what the JAX package bakes."""
    verts, tris = soccar
    tmesh.write_cmf(str(tmp_path / "a.cmf"), verts, tris)
    g = tmesh.load_arena_mesh(str(tmp_path), device="cpu")
    assert g.tri_a.shape[0] == len(tris)
    jg = jmesh.load_arena_mesh(str(tmp_path))
    np.testing.assert_array_equal(g.cells.numpy(), np.asarray(jg.cells))
    with pytest.raises(ValueError, match="unknown arena mesh hash"):
        tmesh.load_arena_mesh(str(tmp_path), verify_hashes=True,
                              device="cpu")


def test_hoops_procedural_mesh(grids):
    """Hoops bowl and baskets: the walls and the rim are queryable."""
    verts, tris = tmesh.build_hoops_mesh()
    assert len(tris) > 500
    assert np.abs(verts[:, 2]).max() <= TC.ARENA_HEIGHT_HOOPS + 1e-3
    grid = grids["hoops"][0]
    r = TC.BALL_COLLISION_RADIUS_HOOPS
    pos = torch.tensor([TC.ARENA_EXTENT_X_HOOPS - r + 0.5, 0.0, 500.0])
    assert bool(grid.sphere_contacts(pos, r)[2].any())
    cy = TC.HOOPS_GOAL_OFFSET_Y / TC.HOOPS_GOAL_SCALE_Y
    rim_x = TC.HOOPS_GOAL_RADIUS + 20.0
    hit, dist, _ = grid.raycast(torch.tensor([rim_x, cy, 500.0]),
                                torch.tensor([0.0, 0.0, -1.0]), 400.0)
    assert bool(hit) and 100.0 < float(dist) < 160.0
    hit2, _, _ = grid.raycast(torch.tensor([0.0, 0.0, 300.0]),
                              torch.tensor([0.0, 0.0, -1.0]), 100.0)
    assert not bool(hit2)


def _near_surface(rng, g, n, spread):
    """(n, 3) float32 points within ``spread`` of random triangles of the
    baked grid ``g`` (JAX's), on both sides."""
    a = np.asarray(g.tri_a)
    k = rng.integers(0, len(a), n)
    u, v = rng.uniform(0, 1, (2, n))
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    p = (a[k] + np.asarray(g.edge_ab)[k] * u[:, None]
         + np.asarray(g.edge_ac)[k] * v[:, None]
         + np.asarray(g.normal)[k] * rng.uniform(-spread, spread, (n, 1)))
    return p.astype(np.float32)


def _agree_where_clear(got_act, want_act, depth):
    """Flags agree exactly except where |depth| is within ATOL_LEN."""
    got_act, want_act = np.asarray(got_act), np.asarray(want_act)
    clear = np.abs(np.asarray(depth)) > ATOL_LEN
    np.testing.assert_array_equal(got_act[clear], want_act[clear])
    return got_act & want_act


@pytest.mark.parametrize("mode", ["soccar", "hoops"])
def test_mesh_queries_match_jax(mode, grids):
    """sphere_contacts, raycast (with and without the compaction), box
    contacts, compact_candidates and adjust_internal_edges on 512 points
    near the arena's triangles, against the JAX grid: indices exactly,
    lengths to 1e-3 uu, unit normals to 1e-5 (1e-4 after the edge
    adjustment's rotation).  The JAX grid runs eagerly here: jitted, XLA
    fuses the closest-point arithmetic and moves a sphere contact's
    (centre - point) vector by up to 8e-3 uu from its own eager result,
    which the port matches to 1e-5."""
    tg, jg = grids[mode]
    rng = np.random.default_rng(1 if mode == "soccar" else 2)
    n = 512
    pos = _near_surface(rng, jg, n, 120.0)
    r = 91.25
    got = tg.sphere_contacts(t(pos), r)
    want = jg.sphere_contacts(j(pos), r)
    act = _agree_where_clear(got[2], want[2], got[1])
    assert act.sum() > n // 4
    close(got[1].numpy()[act], np.asarray(want[1])[act], ATOL_LEN)
    # the normal is (centre - closest point) / distance: compare that
    # vector to 1e-3 uu, and the unit normal where the centre is 10 uu or
    # more from the surface (nearer, last-bit differences of the closest
    # point at arena scale turn it further)
    dist = r - got[1].numpy()
    close((got[0].numpy() * dist[..., None])[act],
          (np.asarray(want[0]) * dist[..., None])[act], ATOL_LEN)
    far = act & (dist > 10.0)
    close(got[0].numpy()[far], np.asarray(want[0])[far], ATOL_UNIT)
    idx = tg.candidates(t(pos))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jg.candidates(j(pos))))

    # wheel-length rays straight down and in random directions
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[: n // 2] = [0.0, 0.0, -1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for kc in (None, 8):
        got = tg.raycast(t(pos), t(dirs), 70.0, k_compact=kc)
        want = jg.raycast(j(pos), j(dirs), 70.0, k_compact=kc)
        hit = _agree_where_clear(got[0], want[0], got[1] - 70.0)
        assert hit.sum() > n // 8
        close(got[1], want[1], ATOL_LEN)
        close(got[2].numpy()[hit], np.asarray(want[2])[hit], ATOL_UNIT)

    rot = _rand_rots(rng, n)
    he = np.broadcast_to(np.float32([59.0, 42.1, 18.1]), (n, 3)).copy()
    got = tg.box_contacts(t(pos), t(rot), t(he))
    want = jg.box_contacts(j(pos), j(rot), j(he))
    act = _agree_where_clear(got[3], want[3], got[2])
    assert act.sum() > n // 4
    for g, w, tol in ((got[0], want[0], ATOL_UNIT),
                      (got[1], want[1], ATOL_LEN),
                      (got[2], want[2], ATOL_LEN)):
        close(g.numpy()[act], np.asarray(w)[act], tol)

    reach = np.float32([80.0, 80.0, 80.0])
    got = tg.compact_candidates(t(pos), t(pos), t(reach), 16)
    want = jg.compact_candidates(j(pos), j(pos), j(reach), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the internal-edge adjustment: a point inside each candidate triangle
    # (3 uu on average from an edge, away from vertex ties), a random unit
    # normal on the face's side and a random distance
    K = idx.shape[-1]
    safe = idx.clamp(min=0).long()
    u, v = rng.uniform(0, 1, (2, n, K, 1)).astype(np.float32)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    pos_b = (tg.tri_a[safe] + tg.edge_ab[safe] * t(u)
             + tg.edge_ac[safe] * t(v)).numpy()
    normal = rng.normal(size=(n, K, 3)).astype(np.float32) * 0.3 \
        + tg.normal[safe].numpy()
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    dist = rng.uniform(-5, 5, (n, K)).astype(np.float32)
    got = tg.adjust_internal_edges(idx, t(normal), t(pos_b), t(dist))
    want = jg.adjust_internal_edges(j(idx.numpy()), j(normal), j(pos_b),
                                    j(dist))
    live = (idx >= 0).numpy()
    moved = np.any(got[0].numpy() != normal, -1) & live
    assert moved.sum() > 10
    # A wedge of pi/2 (hoops' rim) clamps the normal into the face's own
    # plane, where the reference's ``dot(n_rot, tri_n) > 0`` is decided by
    # the last bit: such rows may take either branch, at most 1 in 1000
    tri_n = tg.normal[safe].numpy()
    off = np.abs(got[0].numpy() - np.asarray(want[0])).max(-1) > 1e-4
    in_plane = np.minimum(np.abs(np.sum(got[0].numpy() * tri_n, -1)),
                          np.abs(np.sum(np.asarray(want[0]) * tri_n, -1)))
    tie = off & live & (in_plane < 1e-5)
    assert tie.sum() <= live.sum() // 1000, tie.sum()
    ok = live & ~tie
    close(got[0].numpy()[ok], np.asarray(want[0])[ok], 1e-4)
    close(got[1].numpy()[ok], np.asarray(want[1])[ok], ATOL_LEN)


def test_compact_sel_and_hits_match_jax():
    rng = np.random.default_rng(4)
    hit = rng.uniform(size=(64, 40)) < 0.3
    idx = rng.integers(-1, 500, (64, 40)).astype(np.int32)
    for k_out in (8, 16, 64):
        gs, go = tmesh.compact_sel(t(hit), k_out)
        ws, wo = jmesh.compact_sel(j(hit), k_out)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
        np.testing.assert_array_equal(
            tmesh.compact_hits(t(idx), t(hit), k_out).numpy(),
            np.asarray(jmesh.compact_hits(j(idx), j(hit), k_out)))


# ---------------------------------------------------------------------------
# arena_geom and world

@pytest.mark.parametrize("mode", ["soccar", "hoops"])
def test_arena_geom_matches_jax(mode):
    """Every analytic-plane query on 512 points of the arena's volume and
    goal boxes, against the JAX package: flags exactly, lengths to 1e-3
    uu."""
    rng = np.random.default_rng(9)
    n = 512
    pos = np.stack([rng.uniform(-4300, 4300, n), rng.uniform(-6200, 6200, n),
                    rng.uniform(-50, 2100, n)], -1).astype(np.float32)
    rot = _rand_rots(rng, n)
    he = np.broadcast_to(np.float32([59.0, 42.1, 18.1]), (n, 3)).copy()
    for g, w in zip(tgeom.get_planes(mode, device="cpu"),
                    jgeom.get_planes(mode)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tgeom.get_true_plane_mask(mode, device="cpu").numpy(),
        np.asarray(jgeom.get_true_plane_mask(mode)))
    np.testing.assert_array_equal(tgeom.plane_validity(t(pos), mode).numpy(),
                                  np.asarray(jgeom.plane_validity(j(pos),
                                                                  mode)))
    close(tgeom.signed_distances(t(pos), mode),
          jgeom.signed_distances(j(pos), mode), ATOL_LEN)
    got = tgeom.sphere_contacts(t(pos), 91.25, mode)
    want = jgeom.sphere_contacts(j(pos), 91.25, mode)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], 0.0)
    close(got[1], want[1], ATOL_LEN)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for true_only in (False, True):
        got = tgeom.raycast_down_dir(t(pos), t(dirs), 3000.0, mode,
                                     true_only)
        want = jgeom.raycast_down_dir(j(pos), j(dirs), 3000.0, mode,
                                      true_only)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        close(got[1], want[1], ATOL_LEN, 1e-6)
        close(got[2], want[2], 0.0)
    if mode == "soccar":
        close(tgeom.box_support_radius(t(rot), t(he)),
              jgeom.box_support_radius(j(rot), j(he)), ATOL_LEN)
        got = tgeom.box_contacts(t(pos), t(rot), t(he))
        want = jgeom.box_contacts(j(pos), j(rot), j(he))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        for g, w in zip(got[:3], want[:3]):
            close(g, w, ATOL_LEN)
        np.testing.assert_array_equal(tgeom.is_ball_scored(t(pos)).numpy(),
                                      np.asarray(jgeom.is_ball_scored(
                                          j(pos))))


def test_world_serves_each_mode_per_device():
    """get_grid bakes once per (arena, device): heatseeker and snowday
    share soccar's grid, hoops gets the procedural hoops arena (the code's
    behaviour, not the reference docstring's plane fallback)."""
    tworld.init()
    assert tworld.is_procedural()
    soccar = tworld.get_grid("soccar", device="cpu")
    assert tworld.get_grid("heatseeker", device="cpu") is soccar
    assert tworld.get_grid("snowday", device="cpu") is soccar
    hoops = tworld.get_grid("hoops", device="cpu")
    assert hoops.tri_a.shape[0] == len(tmesh.build_hoops_mesh()[1])
    assert soccar.tri_a.shape[0] == len(tmesh.build_soccar_mesh()[1])
    if torch.cuda.is_available():
        assert tworld.get_grid("soccar").tri_a.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tworld.get_grid("soccar")
