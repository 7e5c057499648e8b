"""Car-car box manifold: dBoxBox with clamped incident corners.

Component form (ops/cvec conventions).  One documented approximation of
btBoxBoxDetector: the incident-face polygon clip (intersectRectQuad2 +
cullPoints2) is replaced by clamping the four incident-face corners into
the reference rect.  The 15-axis SAT (order, 1.05 edge fudge, strict ``>``
tie-breaks), the edge-edge single contact, depths and the point/normal
conventions are exact (btBoxBoxDetector.cpp:267-728).
"""

from __future__ import annotations

import torch

from reinforcement_learning_torch.ops.cvec import (mcol, vadd, vcross, vdot,
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
