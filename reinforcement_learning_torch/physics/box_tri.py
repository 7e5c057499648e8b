"""Exact oriented-box-vs-triangle contact: the box-vs-trimesh narrowphase.

The reference collides the car's compound box with the arena's
``btBvhTriangleMeshShape``s through bullet's convex-convex pipeline
(btConvexTriangleCallback -> btGjkPairDetector with a penetration-depth
fallback): one contact per overlapping triangle, between the margin-shrunk
box core and the triangle, both margins folded into the reported distance
(bullet btConvexConvexAlgorithm.cpp, btGjkPairDetector.cpp; RocketSim
builds the meshes in RocketSim.cpp:165-170).

For a box and a triangle the closest pair lies on one of a fixed set of
feature pairs, so it is computed here in closed form and branch-free:

  * separated: the least of 47 candidate pairs: the 3 triangle vertices
    clamped to the box, the 8 box corners projected onto the triangle and
    the 12 x 3 edge-edge closest points (exact, where GJK stops at an
    epsilon);
  * overlapping cores: the 13-axis separating-axis test (3 box faces, the
    triangle normal, 9 edge cross products) gives the minimum translation
    (bullet samples directions here; on the floor and wall slams that reach
    this path both agree on the face normal).

Every function broadcasts over leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.maths import take_along_axis
from reinforcement_learning_torch.physics.mesh import _closest_point_triangle

# box corner signs (8, 3) and the 12 edges as corner index pairs
_CORNER_SIGNS = np.array([[sx, sy, sz]
                          for sx in (-1.0, 1.0)
                          for sy in (-1.0, 1.0)
                          for sz in (-1.0, 1.0)], np.float32)
_EDGES = np.array([(i, i + stride) for i in range(8)
                   for axis, stride in ((0, 4), (1, 2), (2, 1))
                   if i + stride < 8 and _CORNER_SIGNS[i, axis] < 0
                   and (_CORNER_SIGNS[i] * _CORNER_SIGNS[i + stride]).sum()
                   == 1.0], np.int64)
assert _EDGES.shape == (12, 2)


def _seg_seg_closest(p1, q1, p2, q2, eps=1e-9):
    """Closest points (c1, c2) of segments [p1, q1] and [p2, q2] (Ericson
    RTCD 5.1.9, branch-free)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    c = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = torch.where(denom > eps,
                    torch.clamp((b * f - c * e)
                                / torch.where(denom > eps, denom, 1.0),
                                0.0, 1.0), 0.0)
    t_raw = (b * s + f) / torch.clamp(e, min=eps)
    t = torch.clamp(t_raw, 0.0, 1.0)
    # s again where t was clamped
    s_re = torch.clamp((b * t - c) / torch.clamp(a, min=eps), 0.0, 1.0)
    s = torch.where(t_raw != t, s_re, s)
    return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


@functools.lru_cache(maxsize=None)
def _tables(device):
    """The corner signs and edges on ``device``, copied there once."""
    return (torch.as_tensor(_CORNER_SIGNS, device=device),
            torch.as_tensor(_EDGES, device=device))


def closest_pair_box_triangle(he, v0, v1, v2):
    """Closest pair of an origin-centred AABB with half extents ``he`` and
    the triangle (v0, v1, v2), all in the box's frame.  Returns (p_box
    (..., 3), p_tri (..., 3), dist (...,)); exact for disjoint sets, dist 0
    (and the points meaningless) when they overlap: test that with
    :func:`sat_box_triangle` first."""
    he = torch.as_tensor(he, dtype=v0.dtype, device=v0.device)
    he = he.expand(torch.broadcast_shapes(he.shape, v0.shape))
    tv = torch.stack(torch.broadcast_tensors(v0, v1, v2), dim=-2)
    signs, edges = _tables(v0.device)

    # (a) the triangle's vertices clamped to the box: 3 pairs
    clamped = torch.clamp(tv, -he[..., None, :], he[..., None, :])
    # (b) the box's corners projected onto the triangle: 8 pairs
    corners = he[..., None, :] * signs
    proj = _closest_point_triangle(corners, v0[..., None, :],
                                   (v1 - v0)[..., None, :],
                                   (v2 - v0)[..., None, :])
    # (c) box edges x triangle edges: 36 pairs
    be0 = corners[..., edges[:, 0], :]
    be1 = corners[..., edges[:, 1], :]
    te1 = torch.roll(tv, -1, dims=-2)
    c1, c2 = _seg_seg_closest(be0[..., :, None, :], be1[..., :, None, :],
                              tv[..., None, :, :], te1[..., None, :, :])
    pc_box = c1.reshape(c1.shape[:-3] + (36, 3))
    pc_tri = c2.reshape(c2.shape[:-3] + (36, 3))

    batch = torch.broadcast_shapes(clamped.shape[:-2], corners.shape[:-2],
                                   proj.shape[:-2], pc_box.shape[:-2])

    def cat(*parts):
        return torch.cat([x.expand(batch + x.shape[-2:]) for x in parts],
                         dim=-2)
    p_box = cat(clamped, corners, pc_box)
    p_tri = cat(tv, proj, pc_tri)
    d2_all = torch.sum((p_box - p_tri) ** 2, -1)
    k = torch.argmin(d2_all, dim=-1)
    best_box = take_along_axis(p_box, k[..., None, None], -2)[..., 0, :]
    best_tri = take_along_axis(p_tri, k[..., None, None], -2)[..., 0, :]
    dist = torch.sqrt(take_along_axis(d2_all, k[..., None], -1))[..., 0]
    return best_box, best_tri, dist


def sat_box_triangle(he, v0, v1, v2):
    """The 13-axis separating-axis test of an origin-centred AABB and a
    triangle (box frame).  Returns (overlap (...,) bool, mtv_axis (..., 3)
    unit, the direction to push the box out, pen (...,) >= 0 the depth
    along it); the axis and depth mean something only where they
    overlap."""
    v0, v1, v2 = torch.broadcast_tensors(v0, v1, v2)
    tv = torch.stack([v0, v1, v2], dim=-2)
    e = torch.roll(tv, -1, dims=-2) - tv
    n_tri = m.cross(v1 - v0, v2 - v0)

    axes_box = torch.eye(3, dtype=v0.dtype, device=v0.device).expand(
        v0.shape[:-1] + (3, 3))
    # cross(box axis i, triangle edge j)
    crosses = m.cross(axes_box[..., :, None, :], e[..., None, :, :])
    crosses = crosses.reshape(v0.shape[:-1] + (9, 3))
    axes = torch.cat([axes_box, n_tri[..., None, :], crosses], dim=-2)
    alen = m.norm(axes, keepdim=True)
    ok = alen[..., 0] > 1e-8
    axes = axes / torch.clamp(alen, min=1e-8)

    he_b = torch.as_tensor(he, dtype=v0.dtype, device=v0.device).expand(
        v0.shape)
    r = torch.sum(torch.abs(axes) * he_b[..., None, :], -1)
    t = torch.sum(tv[..., None, :, :] * axes[..., :, None, :], dim=-1)
    tmin = torch.amin(t, dim=-1)
    tmax = torch.amax(t, dim=-1)
    overlap_a = torch.minimum(r, tmax) - torch.maximum(-r, tmin)
    overlap_a = torch.where(ok, overlap_a, torch.inf)
    overlap = torch.all(overlap_a >= 0, dim=-1)

    # the box's interval [-r, r] against the triangle's [tmin, tmax]:
    # moving the box by +d separates at d = tmax + r, by -d at d = r - tmin
    pen_pos = tmax + r
    pen_neg = r - tmin
    pen_axis = torch.where(ok, torch.minimum(pen_pos, pen_neg), torch.inf)
    k = torch.argmin(pen_axis, dim=-1)
    pen = take_along_axis(pen_axis, k[..., None], -1)[..., 0]
    axis = take_along_axis(axes, k[..., None, None], -2)[..., 0, :]
    push_pos = take_along_axis(pen_pos, k[..., None], -1)[..., 0]
    push_neg = take_along_axis(pen_neg, k[..., None], -1)[..., 0]
    sign = torch.where(push_pos <= push_neg, 1.0, -1.0)
    return overlap, axis * sign[..., None], pen


def box_triangle_contact(pos, rot, he_full, core_margin, dist_margin,
                         v0, v1, v2):
    """One bullet-style contact of an oriented box and a triangle.

    ``pos``/``rot``: the box's centre and rotation (columns = local axes in
    the world); ``he_full``: its half extents as constructed (btBoxShape's
    convention); the GJK core is ``he_full - core_margin``.  The triangle
    (v0, v1, v2) is in the world frame.

    Calibrated against the reference's pipeline: the core is shrunk by the
    plain convex margin (``core_margin`` = 0.04 bt = 2 uu) while the
    reported distance subtracts only the box's safe margin
    (``dist_margin`` = min(0.04, 0.1 * least half extent),
    btConvexInternalShape::setSafeMargin); the triangle has no margin.

    Returns (normal (..., 3) from the triangle toward the box, point
    (..., 3) on the triangle (bullet's positionWorldOnB), dist (...,), < 0
    where they penetrate).  Callers gate on ``dist < breaking
    threshold``."""
    he_core = torch.as_tensor(he_full, dtype=torch.float32,
                              device=pos.device) - core_margin
    lv0 = m.inv_rotate(rot, v0 - pos)
    lv1 = m.inv_rotate(rot, v1 - pos)
    lv2 = m.inv_rotate(rot, v2 - pos)

    p_box, p_tri, dist_core = closest_pair_box_triangle(he_core, lv0, lv1,
                                                        lv2)
    overlap, mtv, pen = sat_box_triangle(he_core, lv0, lv1, lv2)

    # separated: from the triangle's witness to the box's
    n_sep = (p_box - p_tri) / torch.clamp(dist_core, min=1e-9)[..., None]
    # overlapping: the minimum translation pushes the box out; the point is
    # the deepest box support along -mtv clamped to the triangle.  On a
    # tie bullet's btFsels support (dir >= +-0 -> +he with dir = -mtv)
    # picks the +he corner where an axis is exactly perpendicular, which
    # decides which end of a landing edge the witness takes.
    sup = torch.where(mtv <= 0, he_core, -he_core)
    sup_tri = _closest_point_triangle(sup, lv0, lv1 - lv0, lv2 - lv0)

    n_local = torch.where(overlap[..., None], mtv, n_sep)
    pt_local = torch.where(overlap[..., None], sup_tri, p_tri)
    dist = torch.where(overlap, -pen, dist_core) - dist_margin
    return m.rotate(rot, n_local), pos + m.rotate(rot, pt_local), dist
