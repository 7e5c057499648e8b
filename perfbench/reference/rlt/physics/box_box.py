"""Box-box narrowphase: the ODE dBoxBox detector bullet dispatches for
box-box pairs (bullet3-3.24 btBoxBoxDetector.cpp:267-728 ``dBoxBox2``;
btBoxBoxCollisionAlgorithm feeds it ``2*getHalfExtentsWithMargin()`` and
``maxc=4``), in two forms:

* ``box_box_manifold``: the exact detector on batched tensors (trailing
  xyz): the 15-axis separating-axis test with the 1.05 fudge favouring
  face axes, then the reference/incident face clip (intersectRectQuad2)
  and the angle-spread point cull (cullPoints2), up to 4 points;
* ``box_box_clamped_components``: the kernel route's component form
  (ops/cvec conventions) with one documented approximation: the
  incident-face polygon clip and cull are replaced by clamping the four
  incident-face corners into the reference rect.  The separating-axis
  test (order, fudge, strict ``>`` tie-breaks), the edge-edge single
  contact, depths and the point/normal conventions are exact.

Conventions as the source's: ``normal`` points from box1 toward box2; the
points are the positions bullet passes to ``addContactPoint`` (on box2's
incident face for face codes <= 3, shifted by the depth for codes >= 4, so
positionWorldOnA = point + normal * depth in every case); depths are >= 0
where active.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.rlt import maths as m
from perfbench.reference.rlt.maths import take_along_axis
from perfbench.reference.rlt.ops.cvec import (mcol, vadd, vcross, vdot,
                                                   vneg, vnorm, vscale, vsub,
                                                   vwhere, vzero)

SIMD_EPSILON = 1.19209290e-07
FUDGE_FACTOR = 1.05
FUDGE2 = 1.0e-5


def _sel_axis(axes, idx, zero):
    out = vzero(zero)
    for k in range(3):
        out = vwhere(idx == k, axes[k], out)
    return out


def _sel_s(vals, idx, zero):
    out = zero
    for k in range(3):
        out = torch.where(idx == k, vals[k], out)
    return out


def box_box_clamped_components(p1, R1, he1, p2, R2, he2):
    """p1/p2: Vec centres; R1/R2: Mats; he1/he2: tuples of 3 floats (same
    units as the positions).  Returns dict(points=[4 Vecs], depth=[4],
    normal=Vec (box1 -> box2), active=[4 bools], overlap=bool, code)."""
    return _manifold(_separating_axis(p1, R1, he1, p2, R2, he2), p1, he1,
                     p2, he2)


def _separating_axis(p1, R1, he1, p2, R2, he2):
    """The 15-axis test: the axis of least penetration, its code (1-6
    face, 7-15 edge pair), and whether any axis separates the boxes."""
    d = vsub(p2, p1)
    ax1 = [mcol(R1, i) for i in range(3)]
    ax2 = [mcol(R2, j) for j in range(3)]
    pp = [vdot(a, d) for a in ax1]
    qq = [vdot(a, d) for a in ax2]
    Rr = [[vdot(ax1[i], ax2[j]) for j in range(3)] for i in range(3)]
    Q = [[torch.abs(Rr[i][j]) for j in range(3)] for i in range(3)]

    zero = torch.zeros_like(pp[0])
    s = zero - float('inf')
    code = torch.zeros_like(pp[0], dtype=torch.int32)
    invert = torch.zeros_like(pp[0], dtype=torch.bool)
    separated = torch.zeros_like(invert)
    axis = vzero(zero)

    def upd(take, cc, inv_new, ax_new, s2):
        nonlocal s, code, invert, axis
        s = torch.where(take, s2, s)
        code = torch.where(take, torch.full_like(code, cc), code)
        invert = torch.where(take, inv_new, invert)
        axis = vwhere(take, ax_new, axis)

    for i in range(3):
        e2 = he1[i] + (he2[0] * Q[i][0] + he2[1] * Q[i][1]
                       + he2[2] * Q[i][2])
        s2 = torch.abs(pp[i]) - e2
        separated = separated | (s2 > 0)
        upd(s2 > s, i + 1, pp[i] < 0, ax1[i], s2)
    for j in range(3):
        e2 = (he1[0] * Q[0][j] + he1[1] * Q[1][j] + he1[2] * Q[2][j]) + he2[j]
        s2 = torch.abs(qq[j]) - e2
        separated = separated | (s2 > 0)
        upd(s2 > s, j + 4, qq[j] < 0, ax2[j], s2)
    Qf = [[Q[i][j] + FUDGE2 for j in range(3)] for i in range(3)]
    for i in range(3):
        i1, i2 = [k for k in range(3) if k != i]
        for j in range(3):
            j1, j2 = [k for k in range(3) if k != j]
            expr1 = pp[i2] * Rr[i1][j] - pp[i1] * Rr[i2][j]
            e2 = (he1[i1] * Qf[i2][j] + he1[i2] * Qf[i1][j]
                  + he2[j1] * Qf[i][j2] + he2[j2] * Qf[i][j1])
            s2 = torch.abs(expr1) - e2
            separated = separated | (s2 > SIMD_EPSILON)
            axv = vcross(ax1[i], ax2[j])
            length = vnorm(axv)
            ok = length > SIMD_EPSILON
            s2n = s2 / torch.clamp(length, min=SIMD_EPSILON)
            axn = vscale(axv, 1.0 / torch.clamp(length, min=SIMD_EPSILON))
            upd(ok & (s2n * FUDGE_FACTOR > s), 7 + 3 * i + j, expr1 < 0, axn,
                s2n)

    return dict(ax1=ax1, ax2=ax2, normal=vwhere(invert, vneg(axis), axis),
                code=code, depth_axis=-s, separated=separated)


def _manifold(sat, p1, he1, p2, he2):
    """The contact points of the boxes along the axis ``sat`` chose: the
    edge-edge point, or the incident face's corners clamped into the
    reference face; none where an axis separates them."""
    ax1, ax2, normal = sat["ax1"], sat["ax2"], sat["normal"]
    code, depth_axis, separated = (sat["code"], sat["depth_axis"],
                                   sat["separated"])
    zero = torch.zeros_like(depth_axis)
    is_edge = code > 6

    # edge-edge single contact
    pa_e = p1
    for k in range(3):
        sg = torch.where(vdot(normal, ax1[k]) > 0, 1.0, -1.0)
        pa_e = vadd(pa_e, vscale(ax1[k], sg * he1[k]))
    pb_e = p2
    for k in range(3):
        sg = torch.where(vdot(normal, ax2[k]) > 0, -1.0, 1.0)
        pb_e = vadd(pb_e, vscale(ax2[k], sg * he2[k]))
    ecode = torch.clamp(code - 7, min=0)
    ua = _sel_axis(ax1, ecode // 3, zero)
    ub = _sel_axis(ax2, ecode % 3, zero)
    pd = vsub(pb_e, pa_e)
    uaub = vdot(ua, ub)
    q1 = vdot(ua, pd)
    q2 = -vdot(ub, pd)
    dd = 1.0 - uaub * uaub
    good = dd > 1e-4
    ddi = 1.0 / torch.where(good, dd, 1.0)
    beta = torch.where(good, (uaub * q1 + q2) * ddi, 0.0)
    edge_pt = vadd(pb_e, vscale(ub, beta))

    def face_branch(axa, pa, Sa, axb, pb, Sb, normal2, base):
        nr = [vdot(a, normal2) for a in axb]
        anr = [torch.abs(x) for x in nr]
        one = torch.ones_like(code)
        lanr = torch.where(anr[1] > anr[0],
                           torch.where(anr[1] > anr[2], one, 2 * one),
                           torch.where(anr[0] > anr[2], 0 * one, 2 * one))
        a1 = torch.where(lanr == 0, one, 0 * one)
        a2 = torch.where(lanr == 2, one, 2 * one)
        Sbz = [Sb[k] + zero for k in range(3)]
        Saz = [Sa[k] + zero for k in range(3)]
        nr_l = _sel_s(nr, lanr, zero)
        Sb_l = _sel_s(Sbz, lanr, zero)
        Rb_l = _sel_axis(axb, lanr, zero)
        center = vadd(vsub(pb, pa),
                      vscale(Rb_l, torch.where(nr_l < 0, Sb_l, -Sb_l)))
        codeN = code - base
        code1 = torch.where(codeN == 0, one, 0 * one)
        code2 = torch.where(codeN == 2, one, 2 * one)
        Ra1 = _sel_axis(axa, code1, zero)
        Ra2 = _sel_axis(axa, code2, zero)
        Rba1 = _sel_axis(axb, a1, zero)
        Rba2 = _sel_axis(axb, a2, zero)
        Sba1 = _sel_s(Sbz, a1, zero)
        Sba2 = _sel_s(Sbz, a2, zero)
        c1 = vdot(center, Ra1)
        c2 = vdot(center, Ra2)
        m11 = vdot(Ra1, Rba1)
        m12 = vdot(Ra1, Rba2)
        m21 = vdot(Ra2, Rba1)
        m22 = vdot(Ra2, Rba2)
        k1 = m11 * Sba1
        k2 = m21 * Sba1
        k3 = m12 * Sba2
        k4 = m22 * Sba2
        corners = [(c1 - k1 - k3, c2 - k2 - k4),
                   (c1 - k1 + k3, c2 - k2 + k4),
                   (c1 + k1 + k3, c2 + k2 + k4),
                   (c1 + k1 - k3, c2 + k2 - k4)]
        r1v = _sel_s(Saz, code1, zero)
        r2v = _sel_s(Saz, code2, zero)
        SaN = _sel_s(Saz, codeN, zero)
        det = m11 * m22 - m12 * m21
        deti = 1.0 / torch.where(torch.abs(det) > 0, det, 1.0)
        pts, deps = [], []
        for (qx, qy) in corners:
            qx = torch.clamp(qx, -r1v, r1v)
            qy = torch.clamp(qy, -r2v, r2v)
            kk1 = (m22 * (qx - c1) - m12 * (qy - c2)) * deti
            kk2 = (-m21 * (qx - c1) + m11 * (qy - c2)) * deti
            kk1 = torch.clamp(kk1, -Sba1, Sba1)
            kk2 = torch.clamp(kk2, -Sba2, Sba2)
            pt = vadd(center, vscale(Rba1, kk1), vscale(Rba2, kk2))
            deps.append(SaN - vdot(normal2, pt))
            pts.append(vadd(pt, pa))
        return pts, deps

    pts_a, deps_a = face_branch(ax1, p1, he1, ax2, p2, he2, normal, 1)
    pts_b, deps_b = face_branch(ax2, p2, he2, ax1, p1, he1, vneg(normal), 4)
    ref_is_1 = code <= 3
    points, depth, active = [], [], []
    for k in range(4):
        pb_shift = vsub(pts_b[k], vscale(normal, deps_b[k]))
        pt = vwhere(ref_is_1, pts_a[k], pb_shift)
        dp = torch.where(ref_is_1, deps_a[k], deps_b[k])
        if k == 0:
            pt = vwhere(is_edge, edge_pt, pt)
            dp = torch.where(is_edge, depth_axis, dp)
            act = is_edge | (~is_edge & (dp >= 0))
        else:
            act = (~is_edge) & (dp >= 0)
        act = act & ~separated & (code > 0)
        points.append(pt)
        depth.append(dp)
        active.append(act)
    overlap = active[0] | active[1] | active[2] | active[3]
    return dict(points=points, depth=depth, normal=normal, active=active,
                overlap=overlap, code=code)


# ---------------------------------------------------------------------------
# The exact detector on batched tensors

def _compact(cands, valid, out_slots):
    """Stable compaction: the valid candidates in slot order, packed to
    the front of ``out_slots`` slots.  cands (..., K, D), valid (..., K) ->
    (out (..., J, D), out_valid (..., J))."""
    tgt = torch.cumsum(valid.to(torch.int32), dim=-1) - 1
    tgt = torch.where(valid, tgt, -1)
    j = torch.arange(out_slots, device=valid.device)
    onehot = (tgt[..., :, None] == j).to(cands.dtype)
    out = torch.sum(cands[..., :, None, :] * onehot[..., None], dim=-3)
    return out, torch.any(tgt[..., :, None] == j, dim=-2)


def _clip_rect_quad(h, quad):
    """intersectRectQuad2 (btBoxBoxDetector.cpp:117-175): the incident quad
    chopped against the reference rect's four edges, in bullet's emission
    order (each surviving vertex, then the crossing after it).  h (..., 2),
    quad (..., 4, 2) -> (pts (..., 8, 2), valid (..., 8))."""
    batch = quad.shape[:-2]
    pts = torch.cat([quad, quad.new_zeros(batch + (4, 2))], dim=-2)
    valid = torch.cat([torch.ones(batch + (4,), dtype=torch.bool,
                                  device=quad.device),
                       torch.zeros(batch + (4,), dtype=torch.bool,
                                   device=quad.device)], dim=-1)
    # the source stops (goto done) once the 8th point is written, skipping
    # the remaining chop lines; ``frozen`` keeps that
    frozen = torch.zeros(batch, dtype=torch.bool, device=quad.device)
    idx = torch.arange(8, device=quad.device)
    for d in (0, 1):
        for sign in (-1.0, 1.0):
            n_val = torch.sum(valid.to(torch.int32), -1)
            # the next point in the prefix-dense list: (i+1) % n
            nxt = (idx + 1) % torch.clamp(n_val[..., None], min=1)
            p = pts
            pn = take_along_axis(p, nxt[..., None], -2)
            hd = h[..., d][..., None]
            inside = sign * p[..., d] < hd
            inside_n = sign * pn[..., d] < hd
            denom = pn[..., d] - p[..., d]
            t = (sign * hd - p[..., d]) / torch.where(
                torch.abs(denom) > 0, denom, 1.0)
            cross_other = p[..., 1 - d] + (pn[..., 1 - d]
                                           - p[..., 1 - d]) * t
            edge = (sign * hd).expand_as(cross_other)
            cross = torch.stack([edge, cross_other] if d == 0
                                else [cross_other, edge], dim=-1)
            emit_pt = valid & inside
            emit_cross = valid & (inside ^ inside_n)
            # [pt_i, cross_i] in slots 2i, 2i+1, then compacted to 8
            cands = torch.stack([p, cross], dim=-2)
            cands = cands.reshape(cands.shape[:-3] + (16, 2))
            vv = torch.stack([emit_pt, emit_cross], dim=-1)
            vv = vv.reshape(vv.shape[:-2] + (16,))
            new_pts, new_valid = _compact(cands, vv, 8)
            pts = torch.where(frozen[..., None, None], pts, new_pts)
            valid = torch.where(frozen[..., None], valid, new_valid)
            frozen = frozen | (torch.sum(valid.to(torch.int32), -1) >= 8)
    return pts, valid


def _cull_points(p2d, valid, i0):
    """cullPoints2 (btBoxBoxDetector.cpp:183-266) for m=4: the deepest point
    ``i0`` and the 3 points whose polar angles about the (shoelace)
    centroid are nearest A[i0] + j*pi/2.  p2d (..., 8, 2), valid (..., 8),
    i0 (...,) -> sel (..., 4) slot indices."""
    n = torch.sum(valid.to(torch.int32), -1)
    x, y = p2d[..., 0], p2d[..., 1]
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    # the first n points form the polygon: pairs (i, i+1) for i < n-1 here,
    # the wrap pair (n-1, 0) explicitly below, as the source does
    idx = torch.arange(x.shape[-1], device=x.device)
    interior = valid & (idx < (n - 1)[..., None])
    q = x * yn - xn * y
    a = torch.sum(torch.where(interior, q, 0.0), -1)
    cx = torch.sum(torch.where(interior, q * (x + xn), 0.0), -1)
    cy = torch.sum(torch.where(interior, q * (y + yn), 0.0), -1)
    last = torch.clamp(n - 1, min=0)
    xl = take_along_axis(x, last[..., None], -1)[..., 0]
    yl = take_along_axis(y, last[..., None], -1)[..., 0]
    qw = xl * y[..., 0] - x[..., 0] * yl
    denom = 3.0 * (a + qw)
    scale = torch.where(torch.abs(a + qw) > SIMD_EPSILON,
                        1.0 / torch.where(denom != 0, denom, 1.0), 3.4e38)
    cx = scale * (cx + qw * (xl + x[..., 0]))
    cy = scale * (cy + qw * (yl + y[..., 0]))
    # the n == 1 and n == 2 centroids
    cx = torch.where(n == 1, x[..., 0],
                     torch.where(n == 2, 0.5 * (x[..., 0] + x[..., 1]), cx))
    cy = torch.where(n == 1, y[..., 0],
                     torch.where(n == 2, 0.5 * (y[..., 0] + y[..., 1]), cy))

    ang = torch.atan2(y - cy[..., None], x - cx[..., None])
    a0 = take_along_axis(ang, i0[..., None], -1)[..., 0]
    avail = valid & (idx != i0[..., None])
    sel = [i0]
    pi = math.pi
    for j in range(1, 4):
        target = j * (2 * pi / 4) + a0
        target = torch.where(target > pi, target - 2 * pi, target)
        diff = torch.abs(ang - target[..., None])
        diff = torch.where(diff > pi, 2 * pi - diff, diff)
        diff = torch.where(avail, diff, torch.inf)
        pick = torch.argmin(diff, -1)
        avail = avail & (idx != pick[..., None])
        sel.append(pick)
    return torch.stack(sel, dim=-1)


def box_box_manifold(p1, R1, he1, p2, R2, he2):
    """dBoxBox2, batched, in consistent units.

    p1/p2 (..., 3) box centres; R1/R2 (..., 3, 3) rotations (columns =
    local axes in the world); he1/he2 (..., 3) half extents including
    bullet's margin adjustment (``formulas.box_effective_half_extents_bt``).

    Returns a dict: ``points`` (..., 4, 3), bullet's addContactPoint
    positions; ``depth`` (..., 4), >= 0 where active; ``normal`` (..., 3)
    from box1 toward box2; ``active`` (..., 4); ``overlap`` (...,), any
    contact; ``code`` (...,) the separating-axis code (1-6 face, 7-15 edge
    pair)."""
    f32 = torch.promote_types(p1.dtype, torch.float32)
    p = p2 - p1
    pp = m.inv_rotate(R1, p)
    A = torch.as_tensor(he1, dtype=f32, device=p1.device).expand(p1.shape)
    B = torch.as_tensor(he2, dtype=f32, device=p1.device).expand(p2.shape)

    # relative rotation R_ij = col_i(R1) . col_j(R2)
    Rrel = torch.sum(R1[..., :, :, None] * R2[..., :, None, :], dim=-3)
    Q = torch.abs(Rrel)

    batch = p.shape[:-1]
    s = torch.full(batch, -torch.inf, dtype=f32, device=p.device)
    code = torch.zeros(batch, dtype=torch.int32, device=p.device)
    invert = torch.zeros(batch, dtype=torch.bool, device=p.device)
    norm_face = p.new_zeros(batch + (3,))   # face-axis normal (world)
    norm_edge = p.new_zeros(batch + (3,))   # edge normal (box1 frame)
    separated = torch.zeros(batch, dtype=torch.bool, device=p.device)

    def upd_face(expr1, expr2, axis_world, cc):
        nonlocal s, code, invert, norm_face, separated
        s2 = torch.abs(expr1) - expr2
        separated = separated | (s2 > 0)
        take = s2 > s
        s = torch.where(take, s2, s)
        code = torch.where(take, cc, code)
        invert = torch.where(take, expr1 < 0, invert)
        norm_face = torch.where(take[..., None], axis_world, norm_face)

    # face axes of box1 (codes 1-3) and box2 (codes 4-6)
    for i in range(3):
        expr2 = A[..., i] + (B[..., 0] * Q[..., i, 0]
                             + B[..., 1] * Q[..., i, 1]
                             + B[..., 2] * Q[..., i, 2])
        upd_face(pp[..., i], expr2, R1[..., :, i], i + 1)
    p_in_2 = m.inv_rotate(R2, p)
    for i in range(3):
        expr2 = (A[..., 0] * Q[..., 0, i] + A[..., 1] * Q[..., 1, i]
                 + A[..., 2] * Q[..., 2, i] + B[..., i])
        upd_face(p_in_2[..., i], expr2, R2[..., :, i], i + 4)

    # edge-edge axes (codes 7-15): u_i x v_j in box1's frame
    Qf = Q + FUDGE2
    for i in range(3):
        for j in range(3):
            i1, i2 = [k for k in range(3) if k != i]
            expr1 = (pp[..., i2] * Rrel[..., i1, j]
                     - pp[..., i1] * Rrel[..., i2, j])
            j1, j2 = [k for k in range(3) if k != j]
            expr2 = (A[..., i1] * Qf[..., i2, j]
                     + A[..., i2] * Qf[..., i1, j]
                     + B[..., j1] * Qf[..., i, j2]
                     + B[..., j2] * Qf[..., i, j1])
            c = Rrel[..., :, j]
            e = torch.zeros(3, dtype=f32, device=p.device)
            e[i] = 1.0
            nC = m.cross(e.expand(c.shape), c)
            s2 = torch.abs(expr1) - expr2
            separated = separated | (s2 > SIMD_EPSILON)
            length = m.norm(nC)
            ok = length > SIMD_EPSILON
            s2n = s2 / torch.clamp(length, min=SIMD_EPSILON)
            take = ok & (s2n * FUDGE_FACTOR > s)
            s = torch.where(take, s2n, s)
            code = torch.where(take, 7 + 3 * i + j, code)
            invert = torch.where(take, expr1 < 0, invert)
            norm_edge = torch.where(
                take[..., None],
                nC / torch.clamp(length[..., None], min=SIMD_EPSILON),
                norm_edge)

    is_edge = code > 6
    normal = torch.where(is_edge[..., None], m.rotate(R1, norm_edge),
                         norm_face)
    normal = torch.where(invert[..., None], -normal, normal)
    depth_axis = -s

    # ---- the edge-edge single contact (btBoxBoxDetector.cpp:429-478)
    sign_a = torch.where(m.inv_rotate(R1, normal) > 0,
                         1.0, -1.0)
    pa = p1 + m.rotate(R1, sign_a * A)
    sign_b = torch.where(m.inv_rotate(R2, normal) > 0,
                         -1.0, 1.0)
    pb = p2 + m.rotate(R2, sign_b * B)
    ecode = torch.clamp(code - 7, min=0)
    ua = take_along_axis(R1, (ecode // 3)[..., None, None], -1)[..., 0]
    ub = take_along_axis(R2, (ecode % 3)[..., None, None], -1)[..., 0]
    pdiff = pb - pa
    uaub = m.dot(ua, ub)
    q1 = m.dot(ua, pdiff)
    q2 = -m.dot(ub, pdiff)
    dd = 1.0 - uaub * uaub
    good = dd > 1e-4
    ddi = 1.0 / torch.where(good, dd, 1.0)
    beta = torch.where(good, (uaub * q1 + q2) * ddi, 0.0)
    pb_edge = pb + ub * beta[..., None]

    # ---- the face-face clip (btBoxBoxDetector.cpp:480-727)
    ref_is_1 = code <= 3
    r1 = ref_is_1[..., None, None]
    r1v = ref_is_1[..., None]
    Ra = torch.where(r1, R1, R2)
    Rb = torch.where(r1, R2, R1)
    pa_f = torch.where(r1v, p1, p2)
    pb_f = torch.where(r1v, p2, p1)
    Sa = torch.where(r1v, A, B)
    Sb = torch.where(r1v, B, A)
    normal2 = torch.where(r1v, normal, -normal)

    nr = m.inv_rotate(Rb, normal2)
    anr = torch.abs(nr)
    # the largest |component|, with the source's strict comparisons
    # (ties go to z)
    lanr = torch.where(
        anr[..., 1] > anr[..., 0],
        torch.where(anr[..., 1] > anr[..., 2], 1, 2),
        torch.where(anr[..., 0] > anr[..., 2], 0, 2))
    a1 = torch.where(lanr == 0, 1, 0)
    a2 = torch.where(lanr == 2, 1, 2)

    def col(R, k):
        return take_along_axis(R, k[..., None, None], -1)[..., 0]

    def comp(v, k):
        return take_along_axis(v, k[..., None], -1)[..., 0]

    nr_l = comp(nr, lanr)
    Sb_l = comp(Sb, lanr)
    Rb_l = col(Rb, lanr)
    center = (pb_f - pa_f
              + torch.where((nr_l < 0)[..., None], Sb_l[..., None] * Rb_l,
                            -Sb_l[..., None] * Rb_l))

    codeN = torch.where(ref_is_1, code - 1, code - 4)
    code1 = torch.where(codeN == 0, 1, 0)
    code2 = torch.where(codeN == 2, 1, 2)

    Ra_1, Ra_2 = col(Ra, code1), col(Ra, code2)
    Rb_a1, Rb_a2 = col(Rb, a1), col(Rb, a2)
    Sb_a1, Sb_a2 = comp(Sb, a1), comp(Sb, a2)

    c1 = m.dot(center, Ra_1)
    c2 = m.dot(center, Ra_2)
    m11 = m.dot(Ra_1, Rb_a1)
    m12 = m.dot(Ra_1, Rb_a2)
    m21 = m.dot(Ra_2, Rb_a1)
    m22 = m.dot(Ra_2, Rb_a2)
    k1 = m11 * Sb_a1
    k2 = m21 * Sb_a1
    k3 = m12 * Sb_a2
    k4 = m22 * Sb_a2
    quad = torch.stack([
        torch.stack([c1 - k1 - k3, c2 - k2 - k4], -1),
        torch.stack([c1 - k1 + k3, c2 - k2 + k4], -1),
        torch.stack([c1 + k1 + k3, c2 + k2 + k4], -1),
        torch.stack([c1 + k1 - k3, c2 + k2 - k4], -1)], dim=-2)
    rect = torch.stack([comp(Sa, code1), comp(Sa, code2)], dim=-1)

    ret, ret_valid = _clip_rect_quad(rect, quad)

    det = m11 * m22 - m12 * m21
    det1 = 1.0 / torch.where(torch.abs(det) > 0, det, 1.0)
    n11, n12, n21, n22 = m11 * det1, m12 * det1, m21 * det1, m22 * det1
    kk1 = (n22[..., None] * (ret[..., 0] - c1[..., None])
           - n12[..., None] * (ret[..., 1] - c2[..., None]))
    kk2 = (-n21[..., None] * (ret[..., 0] - c1[..., None])
           + n11[..., None] * (ret[..., 1] - c2[..., None]))
    point = (center[..., None, :]
             + kk1[..., None] * Rb_a1[..., None, :]
             + kk2[..., None] * Rb_a2[..., None, :])
    Sa_N = take_along_axis(Sa, codeN[..., None], -1)
    dep = Sa_N - torch.sum(normal2[..., None, :] * point, dim=-1)
    pen_valid = ret_valid & (dep >= 0)

    # the penetrating points, compacted in order (the source's in-place
    # cnum++ pass)
    packed, packed_valid = _compact(
        torch.cat([point, dep[..., None], ret], dim=-1), pen_valid, 8)
    point8 = packed[..., :3]
    dep8 = packed[..., 3]
    ret8 = packed[..., 4:6]
    cnum = torch.sum(packed_valid.to(torch.int32), -1)

    # the deepest point (the first maximum, as the source's > scan)
    i1 = torch.argmax(torch.where(packed_valid, dep8, -torch.inf), -1)

    sel = _cull_points(ret8, packed_valid, i1)
    # cnum <= 4: every point, in the source's order
    sel = torch.where((cnum <= 4)[..., None],
                      torch.arange(4, device=sel.device).expand(sel.shape),
                      sel)
    pts4 = take_along_axis(point8, sel[..., None], -2)
    dep4 = take_along_axis(dep8, sel, -1)
    act4 = take_along_axis(packed_valid, sel, -1)

    # world positions: + pa; box2-reference codes also shift by -normal*dep
    pts4 = pts4 + pa_f[..., None, :]
    pts4 = torch.where(r1, pts4,
                       pts4 - normal[..., None, :] * dep4[..., None])

    # ---- the face and edge cases merged
    slot0 = torch.arange(4, device=p.device) == 0
    points = torch.where(is_edge[..., None, None],
                         torch.where(slot0[:, None], pb_edge[..., None, :],
                                     torch.zeros_like(pts4)), pts4)
    depth = torch.where(is_edge[..., None],
                        torch.where(slot0, depth_axis[..., None], 0.0), dep4)
    active = torch.where(is_edge[..., None], slot0, act4)
    active = active & ~separated[..., None] & (code > 0)[..., None]
    return dict(points=points, depth=depth, normal=normal, active=active,
                overlap=torch.any(active, -1), code=code)
