"""Triangle-mesh arena collision: .cmf files, the baked lookup grid and its
queries.

The reference collides cars and balls against 16 triangle meshes loaded
from ``.cmf`` files into ``btBvhTriangleMeshShape``s (CollisionMeshFile/
CollisionMeshFile.{h,cpp}, RocketSim.cpp:102-212) and skips suspension
raycasts with a precomputed occupancy grid (Sim/SuspensionCollisionGrid/).
Here a one-time bake on the host replaces both with one uniform cell grid
of padded triangle-index lists: every query (sphere contact, short raycast,
box contact) gathers its cell's fixed-width candidate list and tests every
candidate branch-free, as batched tensor ops.

The game's meshes ship with neither the reference nor this repository, so
the module provides:

  * ``read_cmf``/``write_cmf``: the binary format (int32 triangle count,
    int32 vertex count, triangles as 3 int32, vertices as 3 float32,
    CollisionMeshFile.cpp:11-61) and ``cmf_hash``, the reference's
    ``UpdateHash`` (CollisionMeshFile.cpp:75-99), so real assets are
    verified and loaded when present;
  * ``build_soccar_mesh`` and ``build_hoops_mesh``: procedural arenas from
    the known dimensions, the default assets;
  * ``build_edge_info`` and ``bvh_leaf_order``: bullet's internal-edge
    table and BVH leaf order, baked on the host with numpy;
  * ``MeshGrid``: the baked tensors (``.to(device)``) and the queries.

The queries are exact triangle tests (Ericson closest point,
Moller-Trumbore); the procedural geometry is what stands in for the game's.
"""

from __future__ import annotations

import dataclasses
import struct as _struct

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.maths import take_along_axis
from reinforcement_learning_torch.device import resolve_device, tree_map
from reinforcement_learning_torch.physics import arena_geom as geom
from reinforcement_learning_torch.physics.arena_geom import (
    CEILING_FILLET_RADIUS, FLOOR_FILLET_RADIUS)

# ---------------------------------------------------------------------------
# .cmf file I/O (CollisionMeshFile.cpp:11-73)

_MAX_VERT_OR_TRI_COUNT = 1000 * 1000


def read_cmf(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a ``.cmf`` collision mesh: (verts (V, 3) f32, tris (T, 3)
    i32)."""
    with open(path, "rb") as f:
        data = f.read()
    num_tris, num_verts = _struct.unpack_from("<ii", data, 0)
    if (min(num_tris, num_verts) <= 0
            or max(num_tris, num_verts) > _MAX_VERT_OR_TRI_COUNT):
        raise ValueError(f"bad triangle/vertex count [{num_tris}, "
                         f"{num_verts}] in {path}")
    off = 8
    tris = np.frombuffer(data, "<i4", num_tris * 3, off).reshape(-1, 3)
    off += num_tris * 12
    verts = np.frombuffer(data, "<f4", num_verts * 3, off).reshape(-1, 3)
    if tris.min() < 0 or tris.max() >= num_verts:
        raise ValueError(f"bad triangle vertex index in {path}")
    return np.array(verts), np.array(tris)


def write_cmf(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    verts = np.asarray(verts, "<f4")
    tris = np.asarray(tris, "<i4")
    with open(path, "wb") as f:
        f.write(_struct.pack("<ii", len(tris), len(verts)))
        f.write(tris.tobytes())
        f.write(verts.tobytes())


def cmf_hash(verts: np.ndarray, tris: np.ndarray) -> int:
    """CollisionMeshFile::UpdateHash (CollisionMeshFile.cpp:75-99): each
    float coordinate goes to uint32 by a C cast (truncation; negatives wrap
    through int64 as MSVC x64 does)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)
    h = np.uint32(len(verts) + len(tris) * len(verts))
    mueller = np.uint32(0x45D9F3B)
    shift = np.uint32(0x9E3779B9)
    # coordinates in the reference's order: triangle, corner, xyz
    coords = verts[tris.reshape(-1)].reshape(-1)
    vals = (np.trunc(coords.astype(np.float64)).astype(np.int64)
            .astype(np.uint32))
    with np.errstate(over="ignore"):
        for _ in range(2):
            vals = ((vals >> np.uint32(16)) ^ vals) * mueller
        vals = (vals >> np.uint32(16)) ^ vals
        for v in vals:
            h = h ^ np.uint32(
                (int(v) + int(shift) + ((int(h) << 6) & 0xFFFFFFFF)
                 + (int(h) >> 2)) & 0xFFFFFFFF)
    return int(h)


# ---------------------------------------------------------------------------
# Procedural arenas

def _fillet_inset(z: np.ndarray, r_floor: float, r_ceil: float,
                  height: float) -> np.ndarray:
    """Inward offset of a wall at height ``z`` from the floor and ceiling
    quarter-circle fillets (0 on the straight section)."""
    z = np.asarray(z, np.float64)
    lo = np.clip(r_floor - z, 0.0, r_floor)
    hi = np.clip(r_ceil - (height - z), 0.0, r_ceil)
    inset_lo = r_floor - np.sqrt(np.maximum(r_floor**2 - lo**2, 0.0))
    inset_hi = r_ceil - np.sqrt(np.maximum(r_ceil**2 - hi**2, 0.0))
    return inset_lo + inset_hi


def _octagon_ring(z: float, planes: np.ndarray, r_floor: float,
                  r_ceil: float, height: float) -> np.ndarray:
    """(8, 2) plan-view corners of the inward-offset octagon at height z;
    ring vertex i joins plane i and plane i+1."""
    inset = _fillet_inset(np.array([z]), r_floor, r_ceil, height)[0]
    d = planes[:, 2] - inset
    pts = []
    for i in range(8):
        n1, n2 = planes[i, :2], planes[(i + 1) % 8, :2]
        d1, d2 = d[i], d[(i + 1) % 8]
        pts.append(np.linalg.solve(np.array([n1, n2]), np.array([d1, d2])))
    return np.array(pts)


class _MeshBuilder:
    def __init__(self):
        self.verts: list = []
        self.tris: list = []
        self._index: dict = {}

    def vert(self, p) -> int:
        key = (round(float(p[0]), 3), round(float(p[1]), 3),
               round(float(p[2]), 3))
        i = self._index.get(key)
        if i is None:
            i = len(self.verts)
            self._index[key] = i
            self.verts.append([float(p[0]), float(p[1]), float(p[2])])
        return i

    def tri(self, a, b, c):
        ia, ib, ic = self.vert(a), self.vert(b), self.vert(c)
        if ia != ib and ib != ic and ia != ic:
            self.tris.append([ia, ib, ic])

    def quad(self, a, b, c, d):
        """a-b-c-d in order around the quad."""
        self.tri(a, b, c)
        self.tri(a, c, d)

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.verts, np.float32),
                np.asarray(self.tris, np.int32))


def _grid_patch(mb: _MeshBuilder, corner_fn, nu: int, nv: int):
    """Tessellate a parametric patch corner_fn(u, v) -> xyz over a
    (nu x nv) grid."""
    for i in range(nu):
        for j in range(nv):
            u0, u1 = i / nu, (i + 1) / nu
            v0, v1 = j / nv, (j + 1) / nv
            mb.quad(corner_fn(u0, v0), corner_fn(u1, v0),
                    corner_fn(u1, v1), corner_fn(u0, v1))


def _clipped_sheet(mb: _MeshBuilder, planes: np.ndarray, z: float,
                   inset: float, ex: float, ey: float,
                   cell: float = 1024.0) -> None:
    """Horizontal sheet at height ``z``: a regular grid clipped to the
    inward-offset octagon (Sutherland-Hodgman against the 8 half-planes)."""
    clip = [(planes[i, :2], planes[i, 2] - inset) for i in range(8)]
    nx = int(np.ceil(ex / cell))
    ny = int(np.ceil(ey / cell))
    for i in range(-nx, nx):
        for j in range(-ny, ny):
            poly = [np.array([i * cell, j * cell]),
                    np.array([(i + 1) * cell, j * cell]),
                    np.array([(i + 1) * cell, (j + 1) * cell]),
                    np.array([i * cell, (j + 1) * cell])]
            for n2, d2 in clip:
                if not poly:
                    break
                out = []
                for k in range(len(poly)):
                    p, q = poly[k], poly[(k + 1) % len(poly)]
                    pin = p @ n2 <= d2 + 1e-9
                    qin = q @ n2 <= d2 + 1e-9
                    if pin:
                        out.append(p)
                    if pin != qin:
                        t = (d2 - p @ n2) / ((q - p) @ n2)
                        out.append(p + (q - p) * t)
                poly = out
            if len(poly) < 3:
                continue
            for k in range(1, len(poly) - 1):
                mb.tri(np.append(poly[0], z), np.append(poly[k], z),
                       np.append(poly[k + 1], z))


def _wall_strips(mb: _MeshBuilder, planes, rings, zs, n_len, goal_cut):
    """The 8 octagon sides x len(zs)-1 bands of wall quads.  Side s spans
    ring vertices s-1 .. s.  ``goal_cut``: cut the goal openings out of the
    back walls, with u-breaks at the posts so the quad-granular cut lands
    on +-GOAL_HALF_WIDTH (keyed on each band's bottom edge)."""
    gw, gh = C.GOAL_HALF_WIDTH, C.GOAL_HEIGHT
    for side in range(8):
        is_back = goal_cut and planes[side][1] != 0 and planes[side][0] == 0
        for k in range(len(zs) - 1):
            z0, z1 = zs[k], zs[k + 1]
            a0, b0 = rings[k][side - 1], rings[k][side]
            a1, b1 = rings[k + 1][side - 1], rings[k + 1][side]
            ubreaks = [j / n_len for j in range(n_len + 1)]
            if is_back and abs(b0[0] - a0[0]) > 1e-9:
                for gx in (-gw, gw):
                    u = (gx - a0[0]) / (b0[0] - a0[0])
                    if 1e-6 < u < 1 - 1e-6:
                        ubreaks.append(u)
                ubreaks = sorted(set(ubreaks))
            for u0, u1 in zip(ubreaks[:-1], ubreaks[1:]):
                p00 = np.append(a0 + (b0 - a0) * u0, z0)
                p10 = np.append(a0 + (b0 - a0) * u1, z0)
                p11 = np.append(a1 + (b1 - a1) * u1, z1)
                p01 = np.append(a1 + (b1 - a1) * u0, z1)
                if is_back:
                    cx = (p00[0] + p10[0]) / 2
                    cz = (z0 + z1) / 2
                    if abs(cx) < gw and cz < gh:
                        continue
                mb.quad(p00, p10, p11, p01)


def build_soccar_mesh(n_fillet: int = 8, n_len: int = 8,
                      n_height: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """The procedural soccar arena: the octagonal plan of ``arena_geom``'s
    planes, curved floor->wall (r=152) and wall->ceiling (r=256) fillets,
    goal openings in the back walls and sharp-edged goal boxes.  Returns
    (verts (V, 3) f32, tris (T, 3) i32); the queries are two-sided."""
    planes = geom.octagon_planes()
    H = C.ARENA_HEIGHT
    rf, rc = FLOOR_FILLET_RADIUS, CEILING_FILLET_RADIUS
    zs = geom.z_samples(H, rf, rc, n_fillet)
    rings = np.array([_octagon_ring(z, planes, rf, rc, H) for z in zs])

    mb = _MeshBuilder()
    gw, gh, gd = C.GOAL_HALF_WIDTH, C.GOAL_HEIGHT, C.GOAL_DEPTH
    ey = C.ARENA_EXTENT_Y
    _wall_strips(mb, planes, rings, zs, n_len, goal_cut=True)

    # floor and ceiling: a regular grid clipped to the octagon, which keeps
    # triangles local (a fan from the centre would pad every cell's
    # candidate list to ~128)
    for z in (0.0, H):
        inset = _fillet_inset(np.array([z]), rf, rc, H)[0]
        _clipped_sheet(mb, planes, z, inset, C.ARENA_EXTENT_X,
                       C.ARENA_EXTENT_Y)

    # goal boxes, sharp-edged
    for sy in (1.0, -1.0):
        y0, y1 = sy * ey, sy * (ey + gd)

        def P(x, y, z):
            return np.array([x, y, z])

        _grid_patch(mb, lambda u, v: P(-gw + 2 * gw * u, y0 + (y1 - y0) * v,
                                       0.0), n_len, n_height)       # floor
        _grid_patch(mb, lambda u, v: P(-gw + 2 * gw * u, y0 + (y1 - y0) * v,
                                       gh), n_len, n_height)        # ceiling
        for sx in (1.0, -1.0):                                       # sides
            _grid_patch(mb, lambda u, v: P(sx * gw, y0 + (y1 - y0) * u,
                                           gh * v), n_height, n_height)
        _grid_patch(mb, lambda u, v: P(-gw + 2 * gw * u, y1, gh * v),
                    n_len, n_height)                                 # net
    return mb.arrays()


def build_hoops_mesh(n_fillet: int = 8, n_len: int = 8,
                     n_ring: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """The procedural hoops ("Dunk House") arena: the rounded-rectangle bowl
    of ``arena_geom``'s hoops planes with the floor and ceiling fillets and
    solid walls, and a basket at each end whose rim follows the scoring
    ellipse (Arena.cpp:958-971: ellipse centre |y| = 3077.8, semi-axes
    716 x 795.6) as a lip with inner (net) and outer (pedestal) walls."""
    ex, ey = C.ARENA_EXTENT_X_HOOPS, C.ARENA_EXTENT_Y_HOOPS
    H = C.ARENA_HEIGHT_HOOPS
    rf, rc = FLOOR_FILLET_RADIUS, CEILING_FILLET_RADIUS
    s = 1.0 / np.sqrt(2.0)
    ci = float(geom.HOOPS_CORNER_INTERCEPT)
    planes = np.array([   # consecutive around the perimeter, as soccar's
        [1, 0, ex],
        [s, s, ci * s],
        [0, 1, ey],
        [-s, s, ci * s],
        [-1, 0, ex],
        [-s, -s, ci * s],
        [0, -1, ey],
        [s, -s, ci * s],
    ], np.float64)
    zs = geom.z_samples(H, rf, rc, n_fillet)
    rings = np.array([_octagon_ring(z, planes, rf, rc, H) for z in zs])

    mb = _MeshBuilder()
    _wall_strips(mb, planes, rings, zs, n_len, goal_cut=False)
    for z in (0.0, H):
        inset = _fillet_inset(np.array([z]), rf, rc, H)[0]
        _clipped_sheet(mb, planes, z, inset, ex, ey)

    a_x = C.HOOPS_GOAL_RADIUS
    b_y = C.HOOPS_GOAL_RADIUS / C.HOOPS_GOAL_SCALE_Y
    cy = C.HOOPS_GOAL_OFFSET_Y / C.HOOPS_GOAL_SCALE_Y
    rim_z, net_z, lip = 365.0, 120.0, 40.0
    for sy in (1.0, -1.0):
        th = np.linspace(0, 2 * np.pi, n_ring + 1)
        for t0, t1 in zip(th[:-1], th[1:]):
            pts = []
            for t, grow in ((t0, 0.0), (t1, 0.0), (t0, lip), (t1, lip)):
                x = (a_x + grow) * np.cos(t)
                y = sy * (cy + (b_y + grow) * np.sin(t))
                pts.append((x, y))
            (i0, i1, o0, o1) = pts
            # segments entirely behind the back wall are left out
            if min(abs(i0[1]), abs(i1[1]), abs(o0[1]), abs(o1[1])) > ey:
                continue
            mb.quad((*i0, rim_z), (*i1, rim_z), (*i1, net_z), (*i0, net_z))
            mb.quad((*i0, rim_z), (*i1, rim_z), (*o1, rim_z), (*o0, rim_z))
            mb.quad((*o0, rim_z), (*o1, rim_z), (*o1, net_z), (*o0, net_z))
    return mb.arrays()


# ---------------------------------------------------------------------------
# Internal-edge info (btGenerateInternalEdgeInfo)

def build_edge_info(verts: np.ndarray, tris: np.ndarray):
    """Per-triangle, per-edge adjacency data for the internal-edge contact
    adjustment (btInternalEdgeUtility.cpp btGenerateInternalEdgeInfo /
    btConnectivityProcessor; RocketSim builds one btTriangleInfoMap per
    arena mesh, RocketSim.cpp:168-170, and runs btAdjustInternalEdgeContacts
    on every mesh contact, Arena.cpp:275).

    Returns (internal (T, 3) bool, angle (T, 3) f32, the stored
    m_edgeVxVyAngle (0 = coplanar seam), nb_normal (T, 3, 3) f32, the
    neighbour normal as bullet's computedNormalB with the swap flag
    applied, convex (T, 3) bool).  Edge e of triangle t is
    (v[e], v[(e+1)%3])."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    T = len(tris)
    tv = verts[tris]
    n_face = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    n_face /= np.maximum(np.linalg.norm(n_face, axis=-1, keepdims=True),
                         1e-30)

    internal = np.zeros((T, 3), bool)
    angle = np.zeros((T, 3), np.float32)
    convex = np.zeros((T, 3), bool)
    nb_normal = np.zeros((T, 3, 3), np.float32)

    edge_map: dict = {}
    for t in range(T):
        for e in range(3):
            key = tuple(sorted((int(tris[t, e]), int(tris[t, (e + 1) % 3]))))
            edge_map.setdefault(key, []).append((t, e))

    def edge_vec(t, e):
        # the adjust code's runtime edge vector: v[e] - v[(e+1)%3]
        return tv[t, e] - tv[t, (e + 1) % 3]

    def rot(axis, ang, v):
        axis = axis / np.maximum(np.linalg.norm(axis), 1e-30)
        c, s = np.cos(ang), np.sin(ang)
        return (v * c + np.cross(axis, v) * s
                + axis * np.dot(axis, v) * (1 - c))

    for key, owners in edge_map.items():
        if len(owners) != 2:
            continue
        for (ta, ea), (tb, _eb) in (owners, owners[::-1]):
            # btConnectivityProcessor for triangle A's edge ea
            i0, i1 = ea, (ea + 1) % 3
            egen = tv[ta, i1] - tv[ta, i0]
            egen = egen / np.maximum(np.linalg.norm(egen), 1e-30)
            other_a = tv[ta, 3 - i0 - i1]
            na, nb = n_face[ta], n_face[tb]
            ca = np.cross(egen, na)
            ca /= np.maximum(np.linalg.norm(ca), 1e-30)
            if np.dot(ca, other_a - tv[ta, i0]) < 0:
                ca = -ca
            shared = set(key)
            other_b_idx = [j for j in range(3)
                           if int(tris[tb, j]) not in shared][0]
            cb = np.cross(egen, nb)
            cb /= np.maximum(np.linalg.norm(cb), 1e-30)
            if np.dot(cb, tv[tb, other_b_idx] - tv[ta, i0]) < 0:
                cb = -cb

            calc_edge = np.cross(ca, cb)
            len2 = np.dot(calc_edge, calc_edge)
            if len2 < 1e-4:  # m_planarEpsilon
                stored = 0.0
                is_cx = False
            else:
                calc_edge /= np.sqrt(len2)
                calc_na = np.cross(calc_edge, ca)
                calc_na /= np.maximum(np.linalg.norm(calc_na), 1e-30)
                angle2 = np.arctan2(np.dot(cb, calc_na), np.dot(cb, ca))
                ang4 = np.pi - angle2
                is_cx = np.dot(na, cb) < 0
                corrected = ang4 if is_cx else -ang4
                stored = -corrected
            internal[ta, ea] = True
            angle[ta, ea] = np.float32(stored)
            convex[ta, ea] = is_cx
            cnb = rot(edge_vec(ta, ea), stored, na)
            if np.dot(cnb, nb) < 0:
                cnb = -cnb
            nb_normal[ta, ea] = cnb.astype(np.float32)
    return internal, angle, nb_normal, convex


# ---------------------------------------------------------------------------
# Bullet's BVH leaf order (the btOptimizedBvh build)

def _bt_quantize(p, bmin, q, is_max):
    """btQuantizedBvh::quantize: float32 math, C-style uint16 casts."""
    v = ((p - bmin) * q).astype(np.float32)
    if is_max:
        return (np.trunc(v + np.float32(1.0)).astype(np.int64)
                .astype(np.uint16) | np.uint16(1))
    return (np.trunc(v).astype(np.int64).astype(np.uint16)
            & np.uint16(0xFFFE))


def bvh_leaf_order(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Triangle indices in bullet's BVH traversal order.

    The quantized build of btOptimizedBvh (btQuantizedBvh.cpp
    setQuantizationValues, the calcSplittingAxis variance split,
    sortAndCalcSplittingIndex with the balance guard), so the leaf order,
    which is the order btBvhTriangleMeshShape reports triangles and so
    bullet's manifold insertion order, comes out without bullet.  It
    matters because the reference disables contact deduplication
    (btPersistentManifold.cpp getCacheEntry returns -1) and caps manifolds
    at 4 points by the keep-deepest/max-area rule."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int64)

    # btTriangleMeshShape::recalcLocalAabb (margin 0 for concave shapes)
    amin = verts.min(0).astype(np.float32)
    amax = verts.max(0).astype(np.float32)

    # setQuantizationValues(margin=1.0) with its two conservative steps
    clamp = np.float32(1.0)
    bmin = (amin - clamp).astype(np.float32)
    bmax = (amax + clamp).astype(np.float32)
    q = (np.float32(65533.0) / (bmax - bmin)).astype(np.float32)
    v = (_bt_quantize(bmin, bmin, q, False).astype(np.float32) / q
         + bmin).astype(np.float32)
    bmin = np.minimum(bmin, v - clamp).astype(np.float32)
    q = (np.float32(65533.0) / (bmax - bmin)).astype(np.float32)
    v = (_bt_quantize(bmax, bmin, q, True).astype(np.float32) / q
         + bmin).astype(np.float32)
    bmax = np.maximum(bmax, v + clamp).astype(np.float32)
    q = (np.float32(65533.0) / (bmax - bmin)).astype(np.float32)

    # per-triangle AABBs with the zero-dimension expansion
    tv = verts[tris]
    tmin = tv.min(1).astype(np.float32)
    tmax = tv.max(1).astype(np.float32)
    thin = (tmax - tmin) < np.float32(0.002)
    tmax = np.where(thin, tmax + np.float32(0.001), tmax).astype(np.float32)
    tmin = np.where(thin, tmin - np.float32(0.001), tmin).astype(np.float32)
    qmin = _bt_quantize(tmin, bmin, q, False)
    qmax = _bt_quantize(tmax, bmin, q, True)
    # build-time centres: unquantize, then average (float32)
    umin = (qmin.astype(np.float32) / q + bmin).astype(np.float32)
    umax = (qmax.astype(np.float32) / q + bmin).astype(np.float32)
    centers = (np.float32(0.5) * (umax + umin)).astype(np.float32)

    order = np.arange(len(tris))

    def _seq_sum(rows):
        # bullet adds btVector3s one by one in float32; numpy's pairwise
        # summation rounds otherwise and flips split decisions
        acc = np.zeros(3, np.float32)
        for r in rows:
            acc = (acc + r).astype(np.float32)
        return acc

    # btBvhSubtreeInfo headers are appended bottom-up as the recursion
    # unwinds: a node whose subtree exceeds 2048 bytes (128 nodes) appends
    # one for each child that fits, and the traversal walks them in that
    # order, so a big mesh's leaf order is not pre-order
    MAX_SUBTREE_NODES = 2048 // 16
    headers: list = []

    def build(start, end):
        """This subtree's node count (leaves and internal nodes)."""
        n = end - start
        if n == 1:
            return 1
        c = centers[order[start:end]]
        means = (_seq_sum(c)
                 * (np.float32(1.0) / np.float32(n))).astype(np.float32)
        diff2 = ((c - means) * (c - means)).astype(np.float32)
        variance = _seq_sum(diff2) * (np.float32(1.0) / np.float32(n - 1))
        axis = int(np.argmax(variance))
        split_value = means[axis]
        # centres > splitValue first, with bullet's swap semantics
        split = start
        for i in range(start, end):
            if centers[order[i], axis] > split_value:
                order[i], order[split] = order[split], order[i]
                split += 1
        balanced = n // 3
        if (split <= start + balanced) or (split >= end - 1 - balanced):
            split = start + (n >> 1)
        left_nodes = build(start, split)
        right_nodes = build(split, end)
        total = 1 + left_nodes + right_nodes
        if total > MAX_SUBTREE_NODES:
            if left_nodes <= MAX_SUBTREE_NODES:
                headers.append((start, split))
            if right_nodes <= MAX_SUBTREE_NODES:
                headers.append((split, end))
        return total

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        total = build(0, len(tris))
    finally:
        sys.setrecursionlimit(old)
    if total <= MAX_SUBTREE_NODES or not headers:
        return order
    return np.concatenate([order[s:e] for s, e in headers])


# ---------------------------------------------------------------------------
# The baked uniform grid (in place of btBvhTriangleMeshShape and the
# suspension grid)

@dataclasses.dataclass
class MeshGrid:
    """The triangle soup and its uniform candidate grid as tensors.

    ``cells[i, j, k]`` lists (padded with -1) the triangles whose AABB,
    inflated by ``margin``, overlaps cell (i, j, k): a query whose reach
    stays under ``margin`` needs only its own cell's list."""
    tri_a: torch.Tensor      # (T, 3)
    edge_ab: torch.Tensor    # (T, 3)
    edge_ac: torch.Tensor    # (T, 3)
    normal: torch.Tensor     # (T, 3) unit
    cells: torch.Tensor      # (Cx, Cy, Cz, K) int32, -1 padded
    origin: torch.Tensor     # (3,)
    inv_cell: torch.Tensor   # (3,)
    tri_mid: torch.Tensor    # (T, 3) raw AABB centre (no margin)
    tri_half: torch.Tensor   # (T, 3) raw AABB half extents
    # internal-edge info (the btTriangleInfoMap), per triangle edge
    # (v[e], v[(e+1)%3])
    edge_internal: torch.Tensor  # (T, 3) bool
    edge_angle: torch.Tensor     # (T, 3) stored m_edgeAngle (0 = coplanar)
    edge_nb: torch.Tensor        # (T, 3, 3) computedNormalB, swap applied
    edge_convex: torch.Tensor    # (T, 3) bool TRI_INFO_*_CONVEX
    margin: float

    def to(self, device) -> "MeshGrid":
        return tree_map(lambda t: t.to(device), self)

    # -- bake ---------------------------------------------------------------
    @classmethod
    def bake(cls, verts: np.ndarray, tris: np.ndarray,
             cell_size: float = 512.0, margin: float = 160.0) -> "MeshGrid":
        """Bake on the host; the tensors are on the CPU (``.to(device)``
        moves them)."""
        verts = np.asarray(verts, np.float32)
        tris = np.asarray(tris, np.int64)
        a = verts[tris[:, 0]]
        b = verts[tris[:, 1]]
        c = verts[tris[:, 2]]
        tri_min = np.minimum(np.minimum(a, b), c) - margin
        tri_max = np.maximum(np.maximum(a, b), c) + margin

        lo = verts.min(0) - margin
        hi = verts.max(0) + margin
        dims = np.maximum(np.ceil((hi - lo) / cell_size).astype(int), 1)

        lo_cell = np.clip(((tri_min - lo) / cell_size).astype(int), 0,
                          dims - 1)
        hi_cell = np.clip(((tri_max - lo) / cell_size).astype(int), 0,
                          dims - 1)

        buckets: dict = {}
        for t in range(len(tris)):
            for i in range(lo_cell[t, 0], hi_cell[t, 0] + 1):
                for j in range(lo_cell[t, 1], hi_cell[t, 1] + 1):
                    for k in range(lo_cell[t, 2], hi_cell[t, 2] + 1):
                        buckets.setdefault((i, j, k), []).append(t)

        kmax = max((len(v) for v in buckets.values()), default=1)
        kmax = int(np.ceil(kmax / 8) * 8)
        cells = np.full((dims[0], dims[1], dims[2], kmax), -1, np.int32)
        for (i, j, k), lst in buckets.items():
            cells[i, j, k, :len(lst)] = lst

        n = np.cross(b - a, c - a)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        e_int, e_ang, e_nb, e_cvx = build_edge_info(verts, tris)
        raw_min = tri_min + margin
        raw_max = tri_max - margin

        def f32(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return cls(
            tri_a=f32(a), edge_ab=f32(b - a), edge_ac=f32(c - a),
            normal=f32(n), cells=torch.from_numpy(cells), origin=f32(lo),
            inv_cell=f32(1.0 / cell_size * np.ones(3)),
            tri_mid=f32((raw_min + raw_max) * 0.5),
            tri_half=f32((raw_max - raw_min) * 0.5),
            edge_internal=torch.from_numpy(e_int), edge_angle=f32(e_ang),
            edge_nb=f32(e_nb), edge_convex=torch.from_numpy(e_cvx),
            margin=float(margin))

    # -- candidate gather ---------------------------------------------------
    def candidates(self, pos: torch.Tensor) -> torch.Tensor:
        """(..., K) triangle indices (-1 padded) near ``pos`` (..., 3)."""
        cell = torch.floor((pos - self.origin) * self.inv_cell).long()
        i, j, k = (torch.clamp(cell[..., d], 0, self.cells.shape[d] - 1)
                   for d in range(3))
        return self.cells[i, j, k]

    def _gather(self, idx: torch.Tensor):
        safe = torch.clamp(idx, min=0).long()
        return (self.tri_a[safe], self.edge_ab[safe], self.edge_ac[safe],
                self.normal[safe])

    def compact_candidates(self, cell_pos: torch.Tensor,
                           aabb_mid: torch.Tensor, reach, k_out: int
                           ) -> torch.Tensor:
        """The candidates whose raw AABB overlaps the query AABB
        (``aabb_mid`` +- ``reach``), compacted to the first ``k_out`` in
        BVH order (cell lists are stored in that order, bullet's manifold
        insertion order, so compaction keeps it).  ``cell_pos`` picks the
        cell and must be within ``margin`` of the whole query box.  Returns
        (..., k_out) int32 triangle ids, -1 padded."""
        idx = self.candidates(cell_pos)
        safe = torch.clamp(idx, min=0).long()
        mid = self.tri_mid[safe]
        half = self.tri_half[safe]
        reach = torch.as_tensor(reach, dtype=torch.float32,
                                device=mid.device)
        if reach.dim() == 0:
            reach = reach[None]
        hit = torch.all(torch.abs(aabb_mid[..., None, :] - mid)
                        <= half + reach[..., None, :], dim=-1)
        hit &= idx >= 0
        return compact_hits(idx, hit, k_out)

    def adjust_internal_edges(self, idx: torch.Tensor, n: torch.Tensor,
                              pos_b: torch.Tensor, dist: torch.Tensor):
        """btAdjustInternalEdgeContacts (btInternalEdgeUtility.cpp:414-797).

        A contact within 5 uu (0.1 bt, m_edgeDistanceThreshold) of its
        triangle's nearest internal edge: on a coplanar seam the normal
        snaps to the face normal; on an angled seam it is clamped into the
        wedge between the two face normals.  The contact point is
        reprojected along the new normal from positionWorldOnA.

        idx (..., K) triangle ids; n (..., K, 3) contact normals (toward the
        body); pos_b (..., K, 3) the point on the mesh; dist (..., K).
        Returns (n', pos_b')."""
        safe = torch.clamp(idx, min=0).long()
        a = self.tri_a[safe]
        v = torch.stack([a, a + self.edge_ab[safe], a + self.edge_ac[safe]],
                        dim=-2)
        tri_n = self.normal[safe]
        e_int = self.edge_internal[safe]
        e_ang = self.edge_angle[safe]
        e_nb = self.edge_nb[safe]
        e_cvx = self.edge_convex[safe]

        # nearest point on each edge segment to the contact point
        p0 = v
        p1 = torch.roll(v, -1, dims=-2)
        seg = p1 - p0
        t = torch.sum((pos_b[..., None, :] - p0) * seg, -1) / torch.clamp(
            torch.sum(seg * seg, -1), min=1e-12)
        t = torch.clamp(t, 0.0, 1.0)
        near_pt = p0 + seg * t[..., None]
        e_dist = m.norm(pos_b[..., None, :] - near_pt)
        e_dist_m = torch.where(e_int, e_dist, torch.inf)
        best = torch.argmin(e_dist_m, dim=-1)
        best_dist = take_along_axis(e_dist_m, best[..., None], -1)[..., 0]
        near = best_dist < (0.1 * 50.0)

        def _pick(arr):
            return take_along_axis(arr, best[..., None], -1)[..., 0]

        ang = _pick(e_ang)
        cvx = _pick(e_cvx)
        nb = take_along_axis(e_nb, best[..., None, None], -2)[..., 0, :]
        edge = -take_along_axis(seg, best[..., None, None], -2)[..., 0, :]
        s = torch.where(cvx, 1.0, -1.0)[..., None]

        flat = ang == 0.0
        backfacing = (torch.sum(n * s * tri_n, -1) < 0.0) & (
            torch.sum(n * s * nb, -1) < 0.0)
        concave = flat | backfacing

        # concave: snap to the face normal unless it opposes the normal
        snap_ok = torch.sum(tri_n * n, -1) >= 0.0
        n_snap = torch.where((concave & snap_ok)[..., None], tri_n, n)

        # convex: clamp into the wedge [0, storedAngle] around the edge
        # (btClampNormal)
        ec = s * tri_n
        edge_u = edge / torch.clamp(m.norm(edge, keepdim=True), min=1e-12)
        cross_ec = m.cross(edge, ec)
        cross_ec = cross_ec / torch.clamp(m.norm(cross_ec, keepdim=True),
                                          min=1e-12)
        cur = torch.atan2(torch.sum(n * cross_ec, -1), torch.sum(n * ec, -1))
        clamped = torch.where(ang < 0, cur < ang, cur > ang)
        diff = ang - cur
        c, si = torch.cos(diff)[..., None], torch.sin(diff)[..., None]
        n_rot = (n * c + m.cross(edge_u, n) * si
                 + edge_u * torch.sum(edge_u * n, -1, keepdim=True) * (1 - c))
        apply_clamp = clamped & (torch.sum(n_rot * tri_n, -1) > 0.0)
        n_clamp = torch.where(apply_clamp[..., None], n_rot, n)

        n_new = torch.where(concave[..., None], n_snap, n_clamp)
        n_new = torch.where(near[..., None], n_new, n)
        # posB' = posA - n' d with posA = posB + n d
        pos_a = pos_b + n * dist[..., None]
        moved = near & torch.any(n_new != n, -1)
        pos_b_new = torch.where(moved[..., None],
                                pos_a - n_new * dist[..., None], pos_b)
        return n_new, pos_b_new

    # -- queries ------------------------------------------------------------
    def sphere_contacts(self, pos: torch.Tensor, radius):
        """Sphere vs mesh: pos (..., 3) -> (normals (..., K, 3), depth
        (..., K), active (..., K)); the exact closest point (Ericson RTCD
        5.1.5), two-sided."""
        idx = self.candidates(pos)
        a, ab, ac, tri_n = self._gather(idx)
        p = pos[..., None, :]
        cp = _closest_point_triangle(p, a, ab, ac)
        delta = p - cp
        dist = m.norm(delta)
        # from the surface toward the centre: +-tri_n on a face, in
        # between on an edge or vertex, as bullet's sphere-triangle
        face_side = torch.sign(torch.sum(delta * tri_n, -1, keepdim=True))
        face_side = torch.where(face_side == 0, 1.0, face_side)
        n = torch.where(dist[..., None] > 1e-6,
                        delta / torch.clamp(dist[..., None], min=1e-6),
                        tri_n * face_side)
        depth = radius - dist
        active = (idx >= 0) & (depth > 0)
        return n, depth, active

    def raycast(self, start: torch.Tensor, direction: torch.Tensor, max_len,
                k_compact: int | None = None):
        """Short raycast vs mesh (suspension rays): start/direction (..., 3)
        -> (hit (...,), dist (...,), normal (..., 3)).  A ray longer than
        ``margin`` may miss triangles binned to other cells.  ``k_compact``:
        keep only that many candidates whose AABB overlaps the ray
        segment's."""
        max_len_t = torch.as_tensor(max_len, dtype=start.dtype,
                                    device=start.device)
        if k_compact is not None:
            seg_mid = start + direction * (max_len_t[..., None] * 0.5)
            seg_half = torch.abs(direction) * (max_len_t[..., None] * 0.5) \
                + 1.0
            idx = self.compact_candidates(start, seg_mid, seg_half,
                                          k_compact)
        else:
            idx = self.candidates(start)
        a, ab, ac, tri_n = self._gather(idx)
        o = start[..., None, :]
        d = direction[..., None, :]
        t, valid = _ray_triangle(o, d, a, ab, ac)
        valid = valid & (idx >= 0) & (t >= 0)
        t = torch.where(valid, t, torch.inf)
        t_min = torch.amin(t, dim=-1)
        k = torch.argmin(t, dim=-1)
        hit = t_min <= max_len_t
        dist = torch.where(hit, t_min, max_len_t)
        n = take_along_axis(tri_n, k[..., None, None], -2)[..., 0, :]
        # two-sided: the normal faces back along the ray
        flip = torch.sign(torch.sum(n * direction, -1, keepdim=True))
        n = torch.where(flip > 0, -n, n)
        return hit, dist, n

    def box_contacts(self, pos: torch.Tensor, rot: torch.Tensor,
                     half_extents: torch.Tensor):
        """Oriented box vs mesh, one contact per candidate triangle's plane,
        as ``arena_geom.box_contacts``: the deepest support point against
        the plane, active when it penetrates and projects into the
        triangle.  pos (..., 3), rot (..., 3, 3) -> (normal (..., K, 3),
        point (..., K, 3), depth (..., K), active (..., K))."""
        idx = self.candidates(pos)
        a, ab, ac, tri_n = self._gather(idx)
        to_c = pos[..., None, :] - a
        side = torch.sign(torch.sum(to_c * tri_n, -1, keepdim=True))
        side = torch.where(side == 0, 1.0, side)
        n = tri_n * side
        proj = torch.einsum('...kc,...cj->...kj', n, rot)
        r_eff = torch.sum(torch.abs(proj) * half_extents[..., None, :], -1)
        dist = torch.sum(to_c * n, -1)
        depth = r_eff - dist
        signs = torch.sign(proj)
        offset = torch.einsum('...kj,...cj->...kc',
                              signs * half_extents[..., None, :], rot)
        point = pos[..., None, :] - offset
        # the contact must project into the triangle (barycentric,
        # scale-free)
        ap = point - a
        d00 = torch.sum(ab * ab, -1)
        d01 = torch.sum(ab * ac, -1)
        d11 = torch.sum(ac * ac, -1)
        d20 = torch.sum(ap * ab, -1)
        d21 = torch.sum(ap * ac, -1)
        den = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        eps = 1e-3
        inside = (v >= -eps) & (w >= -eps) & (v + w <= 1 + eps)
        active = (idx >= 0) & (depth > 0) & (dist > 0) & inside
        return n, point, depth, active


def compact_hits(idx: torch.Tensor, hit: torch.Tensor, k_out: int
                 ) -> torch.Tensor:
    """The first ``k_out`` entries of a padded candidate list whose ``hit``
    is set, in order; -1 padded.  When more than ``k_out`` hit, the last
    ones in BVH order are dropped."""
    K = idx.shape[-1]
    if K <= k_out:
        return torch.where(hit, idx, -1)
    sel, ok = compact_sel(hit, k_out)
    out = torch.gather(idx, -1, sel.long())
    return torch.where(ok, out, -1)


def compact_sel(hit: torch.Tensor, k_out: int):
    """Positions of the first ``k_out`` set entries of ``hit`` along the
    last axis, in order: (sel (..., k_out) int32, ok (..., k_out) bool).
    Prefix-sum ranks and a one-hot reduction, no sort."""
    K = hit.shape[-1]
    k_out = min(k_out, K)
    pos = torch.cumsum(hit.to(torch.int32), dim=-1) - 1
    oh = (pos[..., :, None] == torch.arange(k_out, device=hit.device)) \
        & hit[..., :, None]
    sel = torch.sum(oh.to(torch.int32)
                    * torch.arange(K, dtype=torch.int32,
                                   device=hit.device)[:, None], dim=-2)
    return sel.to(torch.int32), torch.any(oh, dim=-2)


def _closest_point_triangle(p, a, ab, ac):
    """Closest point on triangle (a, a+ab, a+ac) to p, branch-free (Ericson
    RTCD 5.1.5); everything broadcasts over leading axes."""
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - (a + ab)
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp_ = p - (a + ac)
    d5 = torch.sum(ab * cp_, -1)
    d6 = torch.sum(ac * cp_, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = torch.clamp(va + vb + vc, min=1e-20)
    v = vb / denom
    w = vc / denom
    # edge AC (vb <= 0): v = 0, w = clamp(d2 / (d2 - d6))
    w_ac = d2 / torch.where(torch.abs(d2 - d6) < 1e-20, 1e-20, d2 - d6)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = torch.where(in_ac, 0.0, v)
    w = torch.where(in_ac, torch.clamp(w_ac, 0.0, 1.0), w)
    # edge BC (va <= 0): t along (c - b)
    t_bc = (d4 - d3) / torch.where(
        torch.abs((d4 - d3) + (d5 - d6)) < 1e-20, 1e-20,
        (d4 - d3) + (d5 - d6))
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    t_bc = torch.clamp(t_bc, 0.0, 1.0)
    v = torch.where(in_bc, 1.0 - t_bc, v)
    w = torch.where(in_bc, t_bc, w)
    # edge AB (vc <= 0): w = 0, v = clamp(d1 / (d1 - d3))
    v_ab = d1 / torch.where(torch.abs(d1 - d3) < 1e-20, 1e-20, d1 - d3)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = torch.where(in_ab, torch.clamp(v_ab, 0.0, 1.0), v)
    w = torch.where(in_ab, 0.0, w)
    # vertex regions
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    v = torch.where(in_c, 0.0, torch.where(in_b, 1.0,
                                           torch.where(in_a, 0.0, v)))
    w = torch.where(in_c, 1.0, torch.where(in_b, 0.0,
                                           torch.where(in_a, 0.0, w)))
    return a + ab * v[..., None] + ac * w[..., None]


def _ray_triangle(o, d, a, ab, ac):
    """Moller-Trumbore, two-sided: (t, valid)."""
    pvec = m.cross(d, ac)
    det = torch.sum(ab * pvec, -1)
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / det)
    tvec = o - a
    u = torch.sum(tvec * pvec, -1) * inv_det
    qvec = m.cross(tvec, ab)
    v = torch.sum(d * qvec, -1) * inv_det
    t = torch.sum(ac * qvec, -1) * inv_det
    eps = 1e-6
    valid = ((torch.abs(det) > 1e-12) & (u >= -eps) & (v >= -eps)
             & (u + v <= 1 + eps))
    return t, valid


# ---------------------------------------------------------------------------
# Asset loading (RocketSim::Init, RocketSim.cpp:70-212)

# The real arena meshes' hashes (RocketSim.cpp:20-37)
SOCCAR_ARENA_MESH_HASHES = frozenset([
    0xA160BAF9, 0x2811EEE8, 0xB81AC8B9, 0x760358D3,
    0x73AE4940, 0x918F4A4E, 0x1F8EE550, 0x255BA8C1,
    0x14B84668, 0xEC759EBF, 0x94FB0D5C, 0xDEA07102,
    0xBD4FBEA8, 0x39A47F63, 0x3D79D25D, 0xD84C7A68,
])
HOOPS_ARENA_MESH_HASHES = frozenset([
    0x72F2359E, 0x5ED14A26, 0xFD5A0D07, 0x92AFA5B5,
    0x0E4133C7, 0x399E8B5F, 0xBB9D4FB5, 0x8C87FB93,
    0x1CFD0E16, 0xE19E1DF6, 0x9CA179DC, 0x16F3CC19,
])


def load_arena_mesh(mesh_dir: str | None = None, cell_size: float = 512.0,
                    margin: float = 160.0, verify_hashes: bool = False,
                    game_mode: str = "soccar", device=None) -> MeshGrid:
    """The arena's MeshGrid on ``device`` (default ``"cuda"``): from the
    real ``.cmf`` assets in ``mesh_dir``, all merged, as the reference adds
    every mesh to one static world; else the game mode's procedural arena
    (soccar or hoops, RocketSim.cpp GetArenaCollisionShapes)."""
    dev = resolve_device(device)
    if mesh_dir is None:
        if game_mode == "hoops":
            verts, tris = build_hoops_mesh()
        else:
            verts, tris = build_soccar_mesh()
        # bullet's BVH order, so candidate order is manifold insertion
        # order (the BVH is built from bt-unit coordinates: quantization
        # depends on the unit)
        tris = tris[bvh_leaf_order(verts / 50.0, tris)]
        return MeshGrid.bake(verts, tris, cell_size, margin).to(dev)
    import glob
    import os
    paths = sorted(glob.glob(os.path.join(mesh_dir, "*.cmf")))
    if not paths:
        raise FileNotFoundError(f"no .cmf meshes in {mesh_dir}")
    all_verts, all_tris = [], []
    base = 0
    for p in paths:
        v, t = read_cmf(p)
        if verify_hashes and cmf_hash(v, t) not in (
                SOCCAR_ARENA_MESH_HASHES | HOOPS_ARENA_MESH_HASHES):
            raise ValueError(f"unknown arena mesh hash for {p}")
        all_verts.append(v)
        all_tris.append(t + base)
        base += len(v)
    return MeshGrid.bake(np.concatenate(all_verts), np.concatenate(all_tris),
                         cell_size, margin).to(dev)
