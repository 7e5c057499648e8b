"""Closed-form facet arena: the procedural soccar mesh as analytic queries.

The full-fidelity arena is the procedural soccar mesh (RocketSim.cpp:
102-212: an octagonal plan whose 8 walls sweep one vertical profile of a
floor fillet arc, a straight section and a ceiling fillet arc, with a goal
opening cut in the back walls and sharp goal boxes) plus the 4 true static
planes.  Its surfaces are generated from closed-form geometry, so they are
queried here per profile band, octagon side and goal-box rectangle instead
of per triangle: the same formulas the arena-step kernel evaluates per
thread (``csrc/arena_step.cu``).

Everything is mirror-symmetric in x and y, so a query folds into the first
quadrant and evaluates 3 sides (x+ wall, x+y+ corner wall, y+ back wall).
Queries take component tensors of any shape S and return stacked
``(F,) + S`` rows, in a fixed order the kernel enumerates alike:

* ``sphere_contacts``: per side, 4 row kinds x 19 bands (face or clamp,
  lateral seam duplicate, fan-partner triangle, its mirror), then 2 rows
  for each of the 4 goal rectangles: 236 rows;
* ``box_contacts``: per side, 4 row kinds x 19 bands (face, lateral seam
  duplicate, top band seam, bottom band seam), then the 4 goal
  rectangles: 232 rows;
* ``sheet_box_contacts`` / ``sheet_sphere_contacts``: the floor or ceiling
  grid's 4 triangle regions around the body;
* ``raycasts``: the nearest facet hit of a ray.

Known behaviour of the reference that is kept: the floor and ceiling grid
triangles are not omitted, as its docstring says, but come in through the
sheet rows.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.physics.arena_geom import (
    CEILING_FILLET_RADIUS, FLOOR_FILLET_RADIUS, octagon_planes, z_samples)

N_PROFILE_BANDS = 19     # 8 floor-arc + 3 straight + 8 ceiling-arc
N_SIDES = 3              # folded: x+ wall, x+y+ corner, y+ back wall
N_GOAL_FACETS = 4        # goal floor, ceiling, side wall (|x|), back wall
N_LEN = 8                # lateral quads per wall strip
SPHERE_ROWS = N_SIDES * 4 * N_PROFILE_BANDS + 2 * N_GOAL_FACETS   # 236
BOX_ROWS = N_SIDES * 4 * N_PROFILE_BANDS + N_GOAL_FACETS          # 232
SHEET_ROWS = 4
SHEET_CELL = 1024.0
INV_SQRT2 = 0.7071067811865476


@dataclasses.dataclass(frozen=True)
class FacetTables:
    """Static arena tables as tuples of Python floats.

    Profile bands (N_PROFILE_BANDS): a segment from (w0, z0) with unit
    tangent (tw, tz), length ``length`` and unit normal (nw, nz), nw <= 0
    (into the arena); w is the signed distance outside the wall plane.
    Folded sides (N_SIDES): outward xy plane normal, offset, lateral
    direction, and lateral strip bounds affine in w: t_lo(w) = lo0 - loS*w,
    t_hi(w) = hi0 - hiS*w.  Goal-opening cut of the back wall per band:
    cut where |t| < cut_t0 - cut_ts*w (cut_t0 <= 0: no cut)."""
    z0: tuple
    w0: tuple
    tw: tuple
    tz: tuple
    length: tuple
    nw: tuple
    nz: tuple
    side_nx: tuple
    side_ny: tuple
    side_d: tuple
    side_ux: tuple
    side_uy: tuple
    lo0: tuple
    loS: tuple
    hi0: tuple
    hiS: tuple
    cut_t0: tuple
    cut_ts: tuple


def build_tables() -> FacetTables:
    """Derive the tables from the mesh's profile and plan."""
    H = C.ARENA_HEIGHT
    rf, rc = FLOOR_FILLET_RADIUS, CEILING_FILLET_RADIUS
    zs = z_samples(H, rf, rc, 8)
    assert len(zs) == N_PROFILE_BANDS + 1, len(zs)

    def inset(z):
        lo = np.clip(rf - z, 0.0, rf)
        hi = np.clip(rc - (H - z), 0.0, rc)
        return (rf - np.sqrt(max(rf**2 - lo**2, 0.0))
                + rc - np.sqrt(max(rc**2 - hi**2, 0.0)))

    z0l, w0l, twl, tzl, Ll, nwl, nzl = [], [], [], [], [], [], []
    for b in range(N_PROFILE_BANDS):
        za, zb = float(zs[b]), float(zs[b + 1])
        wa, wb = -inset(za), -inset(zb)
        dw, dz = wb - wa, zb - za
        L = float(np.hypot(dw, dz))
        z0l.append(za)
        w0l.append(wa)
        twl.append(dw / L)
        tzl.append(dz / L)
        Ll.append(L)
        nwl.append(-dz / L)      # perpendicular, into the arena
        nzl.append(dw / L)

    planes = octagon_planes()

    def ring(i, s):
        """Ring corner between (offset) sides i and i+1 at inset s."""
        n1, n2 = planes[i % 8], planes[(i + 1) % 8]
        A = np.array([[n1[0], n1[1]], [n2[0], n2[1]]])
        return np.linalg.solve(A, [n1[2] - s, n2[2] - s])

    s_nx, s_ny, s_d, s_ux, s_uy = [], [], [], [], []
    lo0l, loSl, hi0l, hiSl = [], [], [], []
    for i in (0, 1, 2):
        nx, ny, d = planes[i]
        s_nx.append(float(nx))
        s_ny.append(float(ny))
        s_d.append(float(d))
        u = np.array([-ny, nx])
        s_ux.append(float(u[0]))
        s_uy.append(float(u[1]))
        lo_0, lo_1 = float(u @ ring(i - 1, 0.0)), float(u @ ring(i - 1, 1.0))
        hi_0, hi_1 = float(u @ ring(i, 0.0)), float(u @ ring(i, 1.0))
        if lo_0 > hi_0:
            lo_0, lo_1, hi_0, hi_1 = hi_0, hi_1, lo_0, lo_1
        lo0l.append(lo_0)
        loSl.append(lo_1 - lo_0)
        hi0l.append(hi_0)
        hiSl.append(hi_1 - hi_0)

    # goal-opening cut of the back wall (folded side 2): |x| < gw at each
    # band's bottom edge, widening with the corner slope up the band
    gw, gh = C.GOAL_HALF_WIDTH, C.GOAL_HEIGHT
    cut_t0, cut_ts = [], []
    c0_back, cs_back = hi0l[2], hiSl[2]
    for b in range(N_PROFILE_BANDS):
        if (float(zs[b]) + float(zs[b + 1])) / 2.0 < gh:
            scale = gw / (c0_back - cs_back * w0l[b])
            cut_t0.append(scale * c0_back)
            cut_ts.append(scale * cs_back)
        else:
            cut_t0.append(-1.0)
            cut_ts.append(0.0)

    return FacetTables(
        z0=tuple(z0l), w0=tuple(w0l), tw=tuple(twl), tz=tuple(tzl),
        length=tuple(Ll), nw=tuple(nwl), nz=tuple(nzl),
        side_nx=tuple(s_nx), side_ny=tuple(s_ny), side_d=tuple(s_d),
        side_ux=tuple(s_ux), side_uy=tuple(s_uy),
        lo0=tuple(lo0l), loS=tuple(loSl), hi0=tuple(hi0l), hiS=tuple(hiSl),
        cut_t0=tuple(cut_t0), cut_ts=tuple(cut_ts))


@functools.lru_cache(maxsize=None)
def tables() -> FacetTables:
    return build_tables()


@functools.lru_cache(maxsize=None)
def band_table(t: FacetTables) -> dict:
    """Per-band constants (N_PROFILE_BANDS,) as float32 arrays: the profile,
    whether the seam below (``lo_flat``) / above (``hi_flat``) joins a
    coplanar band, and the back wall's goal cut."""
    B = N_PROFILE_BANDS
    f = lambda v: np.asarray(v, np.float32)  # noqa: E731

    def flat(b2, b):
        return (0 <= b2 < B and abs(t.nw[b2] - t.nw[b]) < 1e-9
                and abs(t.nz[b2] - t.nz[b]) < 1e-9)

    return dict(
        z0=f(t.z0), w0=f(t.w0), tw=f(t.tw), tz=f(t.tz), L=f(t.length),
        nw=f(t.nw), nz=f(t.nz),
        lo_flat=f([1.0 if flat(b - 1, b) else 0.0 for b in range(B)]),
        hi_flat=f([1.0 if flat(b + 1, b) else 0.0 for b in range(B)]),
        cut_t0=f(t.cut_t0), cut_ts=f(t.cut_ts),
        has_cut=f([1.0 if t.cut_t0[b] > 0 else 0.0 for b in range(B)]))


_BAND_TENSORS = {}


def _bands(t: FacetTables, side: int, like: torch.Tensor) -> dict:
    """The band constants as ``(B,) + (1,) * like.dim()`` tensors on
    ``like``'s device (cached)."""
    key = (t, side, like.device, like.dim())
    got = _BAND_TENSORS.get(key)
    if got is None:
        sh = (N_PROFILE_BANDS,) + (1,) * like.dim()
        got = {k: torch.as_tensor(v, device=like.device).reshape(sh)
               for k, v in band_table(t).items()}
        if side != 2:
            got["has_cut"] = torch.zeros_like(got["has_cut"])
        got = {k: (v > 0 if k in ("lo_flat", "hi_flat", "has_cut") else v)
               for k, v in got.items()}
        _BAND_TENSORS[key] = got
    return got


# ---------------------------------------------------------------------------
# Shared pieces

def _fold_sign(p):
    """Quadrant fold: sign(p), with 0 (either sign) folding to +1."""
    s = torch.sign(p)
    return torch.where(s == 0, 1.0, s)


def _clip(x, lo, hi):
    """min(max(x, lo), hi) for float or tensor bounds (jnp.clip)."""
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else \
        torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else \
        torch.clamp(x, max=hi)


def _side_coords(t: FacetTables, side: int, px, py):
    w_q = t.side_nx[side] * px + t.side_ny[side] * py - t.side_d[side]
    t_q = t.side_ux[side] * px + t.side_uy[side] * py
    return w_q, t_q


def _unfold_normal(t: FacetTables, side, n_w, n_t, n_z, sx, sy):
    """Side-frame normal components -> world, unfolded by quadrant signs."""
    nx = t.side_nx[side] * n_w + t.side_ux[side] * n_t
    ny = t.side_ny[side] * n_w + t.side_uy[side] * n_t
    return nx * sx, ny * sy, n_z


def _sq(x):
    return x * x


def goal_rects():
    """Goal-box rectangles in folded coordinates (x >= 0, y >= 0):
    (plane_axis, plane_value, inward_normal_sign, (u_axis, u_lo, u_hi),
    (v_axis, v_lo, v_hi), mouth_axis); the mouth axis marks the boundary
    at the goal mouth (the convex rim).  Axes: 0 = x (folded |x|), 1 = y,
    2 = z."""
    gw, gh, gd = C.GOAL_HALF_WIDTH, C.GOAL_HEIGHT, C.GOAL_DEPTH
    ey = C.ARENA_EXTENT_Y
    return (
        (2, 0.0, +1.0, (0, 0.0, gw), (1, ey, ey + gd), None),   # floor
        (2, gh, -1.0, (0, 0.0, gw), (1, ey, ey + gd), 1),       # ceiling
        (0, gw, -1.0, (1, ey, ey + gd), (2, 0.0, gh), 1),       # side wall
        (1, ey + gd, -1.0, (0, 0.0, gw), (2, 0.0, gh), None),   # back wall
    )


def goal_seams():
    """Tessellation seam (origin, spacing) of the goal patches per folded
    axis: |x| seams start at 0, y and z seams at the rectangle's bound."""
    gw, gh, gd = C.GOAL_HALF_WIDTH, C.GOAL_HEIGHT, C.GOAL_DEPTH
    return {0: (0.0, 2 * gw / 8), 1: (C.ARENA_EXTENT_Y, gd / 2),
            2: (0.0, gh / 2)}


# ---------------------------------------------------------------------------
# Sphere

def sphere_contacts(px, py, pz, radius, break_gap, tab: FacetTables = None):
    """Sphere vs every wall and goal facet.  Returns stacked (nx, ny, nz,
    gap, active), each (SPHERE_ROWS,) + S: the contact normal toward the
    sphere, the surface gap (distance - radius) and gap < break_gap,
    including the tessellation-seam duplicate contacts of the mesh's
    per-triangle manifold."""
    t = tab or tables()
    sx, sy = _fold_sign(px), _fold_sign(py)
    ax, ay = px * sx, py * sy
    NX, NY, NZ, GAP = [], [], [], []

    def emit(nx, ny, nz, gap):
        NX.append(torch.broadcast_to(nx, gap.shape))
        NY.append(torch.broadcast_to(ny, gap.shape))
        NZ.append(torch.broadcast_to(nz, gap.shape))
        GAP.append(gap)

    for side in range(N_SIDES):
        b = _bands(t, side, px)
        z0, w0, tw, tz, L, nw, nzb = (b[k] for k in (
            "z0", "w0", "tw", "tz", "L", "nw", "nz"))
        w_q, t_q = _side_coords(t, side, ax, ay)

        # closest point on each band (clamped profile + lateral bounds)
        ell_raw = (w_q - w0) * tw + (pz - z0) * tz
        ell = _clip(ell_raw, 0.0, L)
        w_c = w0 + tw * ell
        z_c = z0 + tz * ell
        t_lo = t.lo0[side] - t.loS[side] * w_c
        t_hi = t.hi0[side] - t.hiS[side] * w_c
        t_c = _clip(t_q, t_lo, t_hi)
        clamped_prof = (ell_raw < 0.0) | (ell_raw > L)
        clamped_lat = (t_q < t_lo) | (t_q > t_hi)
        # goal-opening cut (back side): snap to the rim
        cut = b["cut_t0"] - b["cut_ts"] * w_c
        in_cut = b["has_cut"] & (torch.abs(t_c) < cut)
        t_rim = torch.sign(t_q) * cut
        t_rim = torch.where(t_rim == 0.0, cut, t_rim)
        t_c = torch.where(in_cut, t_rim, t_c)

        dw = w_q - w_c
        dt_ = t_q - t_c
        dz = pz - z_c
        dist = torch.sqrt(dw * dw + dt_ * dt_ + dz * dz)
        s_d = (w_q - w0) * nw + (pz - z0) * nzb
        sgn = torch.where(s_d >= 0, 1.0, -1.0)
        fn_w, fn_z = nw * sgn, nzb * sgn
        # a clamp at a coplanar profile seam snaps to the face normal;
        # angled seams keep the raw interpolated edge normal
        ell_lo = ell <= 0.0
        raw_prof = clamped_prof & ~((ell_lo & b["lo_flat"])
                                    | (~ell_lo & b["hi_flat"]))
        use_raw = (raw_prof | clamped_lat | in_cut) & (dist > 1e-6)
        inv = 1.0 / torch.clamp(dist, min=1e-6)
        zeros = torch.zeros_like(dist)
        n_w = torch.where(use_raw, dw * inv, fn_w)
        n_t = torch.where(use_raw, dt_ * inv, zeros)
        n_z = torch.where(use_raw, dz * inv, fn_z)
        emit(*_unfold_normal(t, side, n_w, n_t, n_z, sx, sy), dist - radius)

        # lateral u-break duplicate (coplanar seam: face normal)
        face_ok = ~(clamped_prof | clamped_lat | in_cut)
        fnx, fny, fnz = _unfold_normal(t, side, fn_w, zeros, fn_z, sx, sy)
        span = t_hi - t_lo
        u_frac = (t_c - t_lo) / span
        perp2 = s_d * s_d
        t_s = t_lo + span * (torch.round(u_frac * N_LEN) / N_LEN)
        d_lat = torch.abs(t_c - t_s)
        if side == 2:
            # the back wall has extra u-breaks at the goal posts
            d_post = torch.abs(torch.abs(t_c) - C.GOAL_HALF_WIDTH)
            d_lat = torch.minimum(d_lat, d_post)
        big = torch.full_like(dist, 1e9)
        gap_lat = torch.where(
            face_ok, torch.sqrt(perp2 + d_lat * d_lat) - radius, big)
        emit(fnx, fny, fnz, gap_lat)

        # fan-partner triangle of the containing quad: clamp onto its
        # boundary; a profile-edge witness keeps the raw band-seam normal
        j0 = torch.clamp(torch.floor(u_frac * N_LEN), 0, N_LEN - 1)
        t_a = t_lo + span * (j0 / N_LEN)
        dgt = span / N_LEN
        t_b = t_a + dgt
        below = ell * dgt <= (t_c - t_a) * L

        def seg2(axp, ayp, bxp, byp):
            dx_, dy_ = bxp - axp, byp - ayp
            ss = torch.clamp(((t_c - axp) * dx_ + (ell - ayp) * dy_)
                             / torch.clamp(dx_ * dx_ + dy_ * dy_, min=1e-12),
                             0.0, 1.0)
            wx_, wy_ = axp + dx_ * ss, ayp + dy_ * ss
            return _sq(t_c - wx_) + _sq(ell - wy_), wx_, wy_

        d2_dg, wt_dg, wl_dg = seg2(t_a, zeros, t_b, L + zeros)
        prof_l = torch.where(below, L, 0.0)
        d2_pr, wt_pr, wl_pr = seg2(t_a, prof_l, t_b, prof_l)
        lat_t = torch.where(below, t_a, t_b)
        d2_la, wt_la, wl_la = seg2(lat_t, zeros, lat_t, L + zeros)
        prof_best = (d2_pr <= d2_dg) & (d2_pr <= d2_la)
        d2_p = torch.minimum(d2_dg, torch.minimum(d2_pr, d2_la))
        dg_la = d2_dg <= d2_la
        t_w = torch.where(prof_best, wt_pr, torch.where(dg_la, wt_dg, wt_la))
        ell_w = torch.where(prof_best, wl_pr,
                            torch.where(dg_la, wl_dg, wl_la))
        dist_p = torch.sqrt(perp2 + d2_p)
        pdw = w_q - (w0 + tw * ell_w)
        pdt = t_q - t_w
        pdz = pz - (z0 + tz * ell_w)
        pinv = 1.0 / torch.clamp(dist_p, min=1e-6)
        # seam flatness: witness at ell=L -> seam with band b+1, else b-1
        not_flat = (below & ~b["hi_flat"]) | (~below & ~b["lo_flat"])
        p_raw = prof_best & not_flat & (dist_p > 1e-6)
        pn_w = torch.where(p_raw, pdw * pinv, fn_w)
        pn_t = torch.where(p_raw, pdt * pinv, zeros)
        pn_z = torch.where(p_raw, pdz * pinv, fn_z)
        pn = _unfold_normal(t, side, pn_w, pn_t, pn_z, sx, sy)
        gap_p = torch.where(face_ok, dist_p - radius, big)
        emit(*pn, gap_p)
        # the mirrored quad across the nearest lateral seam carries an
        # almost-identical partner contact
        emit(*pn, torch.where(gap_lat < break_gap, gap_p, big))

    tail = GAP[0].shape[1:]
    for nx, ny, nz, gap in _goal_sphere(ax, ay, pz, sx, sy, radius):
        NX.append(torch.broadcast_to(nx, tail)[None])
        NY.append(torch.broadcast_to(ny, tail)[None])
        NZ.append(torch.broadcast_to(nz, tail)[None])
        GAP.append(torch.broadcast_to(gap, tail)[None])
    gap = torch.cat(GAP)
    return (torch.cat(NX), torch.cat(NY), torch.cat(NZ), gap,
            gap < break_gap)


def _goal_sphere(ax, ay, pz, sx, sy, radius):
    """Per goal rectangle: the closest-point row and the nearest
    tessellation-seam duplicate (face normal)."""
    seam = goal_seams()
    coords = (ax, ay, pz)
    out = []
    for axis, value, nsign, (ua, ulo, uhi), (va, vlo, vhi), mouth in \
            goal_rects():
        w_q = coords[axis] - value
        u_q, v_q = coords[ua], coords[va]
        du = u_q - torch.clamp(u_q, ulo, uhi)
        dv = v_q - torch.clamp(v_q, vlo, vhi)
        dist = torch.sqrt(w_q * w_q + du * du + dv * dv)
        sgn = torch.where(w_q * nsign >= 0, nsign, -nsign)
        zeros = torch.zeros_like(dist)
        if mouth is not None:
            # convex rim: clamped onto the goal-mouth edge
            at_mouth = (u_q < ulo) if ua == mouth else (v_q < vlo)
            inv = 1.0 / torch.clamp(dist, min=1e-6)
            use_delta = at_mouth & (dist > 1e-6)
            comp = {axis: torch.where(use_delta, w_q * inv, sgn),
                    ua: torch.where(use_delta, du * inv, 0.0),
                    va: torch.where(use_delta, dv * inv, 0.0)}
        else:
            comp = {axis: sgn, ua: zeros, va: zeros}
        out.append((comp[0] * sx, comp[1] * sy, comp[2], dist - radius))

        # nearest u/v seam of the patch: a coplanar duplicate contact; the
        # folded |x| axis starts at the mirror seam, not a boundary
        in_u = (u_q < uhi) if ua == 0 else ((u_q > ulo) & (u_q < uhi))
        in_v = (v_q < vhi) if va == 0 else ((v_q > vlo) & (v_q < vhi))
        fcomp = {axis: sgn, ua: zeros, va: zeros}
        d_seam = torch.full_like(dist, 1e9)
        for aid in (ua, va):
            o, s = seam[aid]
            q = coords[aid]
            d_seam = torch.minimum(
                d_seam, torch.abs(q - (o + s * torch.round((q - o) / s))))
        gap_s = torch.where(in_u & in_v,
                            torch.sqrt(w_q * w_q + d_seam * d_seam) - radius,
                            torch.full_like(dist, 1e9))
        out.append((fcomp[0] * sx, fcomp[1] * sy, fcomp[2], gap_s))
    return out


# ---------------------------------------------------------------------------
# Box

# Box corner sign patterns (bullet's support tie-break order) and the 12
# edges between corners that differ in one axis.
CORNER_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                for sz in (-1.0, 1.0)]
SHEET_EDGES = []
for _i in range(8):
    for _axis, _stride in ((0, 4), (1, 2), (2, 1)):
        _j = _i + _stride
        if _j < 8 and CORNER_SIGNS[_i][_axis] < 0 and sum(
                a * b for a, b in zip(CORNER_SIGNS[_i],
                                      CORNER_SIGNS[_j])) == 1.0:
            SHEET_EDGES.append((_i, _j))
assert len(SHEET_EDGES) == 12


def _corner(px, py, pz, rot, lx):
    return (px + rot[0][0] * lx[0] + rot[0][1] * lx[1] + rot[0][2] * lx[2],
            py + rot[1][0] * lx[0] + rot[1][1] * lx[1] + rot[1][2] * lx[2],
            pz + rot[2][0] * lx[0] + rot[2][1] * lx[1] + rot[2][2] * lx[2])


def box_dist_margin(he) -> float:
    return min(C.MESH_COLLISION_MARGIN, 0.1 * float(np.min(np.asarray(he))))


def box_contacts(px, py, pz, rot, he, brk, tab: FacetTables = None,
                 bounds_eps: float = 1.0):
    """Oriented box (center px/py/pz, rotation ``rot`` as nested 3x3 row
    tuples, half extents ``he``) vs every facet.  Returns stacked (nx, ny,
    nz, pa_x, pa_y, pa_z, dist, active), each (BOX_ROWS,) + S: ``pa`` the
    lever-arm point on the box, ``dist`` the margin-law contact distance
    (core support height minus the safe margin; negative = penetrating).
    The seam rows carry the raw interpolated edge normals bullet keeps on
    angled internal edges."""
    t = tab or tables()
    sx, sy = _fold_sign(px), _fold_sign(py)
    ax, ay = px * sx, py * sy
    dist_m = box_dist_margin(he)
    hc = tuple(float(he[i]) - C.MESH_COLLISION_MARGIN for i in range(3))
    corners = [_corner(px, py, pz, rot,
                       tuple(0.0 + sg[i] * hc[i] for i in range(3)))
               for sg in CORNER_SIGNS]
    rows = []

    def emit(*r):
        shape = r[6].shape
        rows.append(tuple(torch.broadcast_to(a, shape) for a in r))

    for side in range(N_SIDES):
        b = _bands(t, side, px)
        z0, w0, tw, tz, L, nw, nzb = (b[k] for k in (
            "z0", "w0", "tw", "tz", "L", "nw", "nz"))
        snx, sny, sd_ = t.side_nx[side], t.side_ny[side], t.side_d[side]
        sux, suy = t.side_ux[side], t.side_uy[side]
        w_q, _ = _side_coords(t, side, ax, ay)
        s_d = (w_q - w0) * nw + (pz - z0) * nzb
        sgn = torch.where(s_d >= 0, 1.0, -1.0)
        fnw, fnz = nw * sgn, nzb * sgn
        nx, ny, nz = _unfold_normal(t, side, fnw, 0.0, fnz, sx, sy)

        def to_world(w_s, t_s2, z_s):
            axw = snx * (w_s + sd_) + sux * t_s2
            ayw = sny * (w_s + sd_) + suy * t_s2
            return axw * sx, ayw * sy, z_s

        # per-corner band coordinates, with running arg-mins
        hs = []
        for i, (cwx, cwy, cwz) in enumerate(corners):
            caw, ct_ = _side_coords(t, side, cwx * sx, cwy * sy)
            h_i = sgn * ((caw - w0) * nw + (cwz - z0) * nzb)
            ell_i = (caw - w0) * tw + (cwz - z0) * tz
            d_top_i = torch.sqrt(_sq(ell_i - L) + h_i * h_i)
            d_bot_i = torch.sqrt(ell_i * ell_i + h_i * h_i)
            ct_ = torch.broadcast_to(ct_, h_i.shape)
            if i == 0:
                h_sup, t_sup, ell_sup = h_i, ct_, ell_i
                cx_s, cy_s, cz_s = (torch.broadcast_to(c, h_i.shape)
                                    for c in (cwx, cwy, cwz))
                d_top, t_top, htop, elltop = d_top_i, ct_, h_i, ell_i
                d_bot, t_bot, hbot, ellbot = d_bot_i, ct_, h_i, ell_i
            else:
                better = h_i < h_sup
                t_sup = torch.where(better, ct_, t_sup)
                ell_sup = torch.where(better, ell_i, ell_sup)
                cx_s = torch.where(better, cwx, cx_s)
                cy_s = torch.where(better, cwy, cy_s)
                cz_s = torch.where(better, cwz, cz_s)
                h_sup = torch.minimum(h_i, h_sup)
                bt_ = d_top_i < d_top
                t_top = torch.where(bt_, ct_, t_top)
                htop = torch.where(bt_, h_i, htop)
                elltop = torch.where(bt_, ell_i, elltop)
                d_top = torch.minimum(d_top_i, d_top)
                bb_ = d_bot_i < d_bot
                t_bot = torch.where(bb_, ct_, t_bot)
                hbot = torch.where(bb_, h_i, hbot)
                ellbot = torch.where(bb_, ell_i, ellbot)
                d_bot = torch.minimum(d_bot_i, d_bot)
            hs.append((h_i, ct_, ell_i))

        # face row: core support height - safe margin; witness = the
        # support corner pulled in by the margin
        dist_f = h_sup - dist_m
        w_c = w0 + tw * _clip(ell_sup, 0.0, L)
        t_lo = t.lo0[side] - t.loS[side] * w_c
        t_hi = t.hi0[side] - t.hiS[side] * w_c
        in_prof = (ell_sup >= -bounds_eps) & (ell_sup <= L + bounds_eps)
        in_lat = (t_sup >= t_lo - bounds_eps) & (t_sup <= t_hi + bounds_eps)
        cut = b["cut_t0"] - b["cut_ts"] * w_c
        act_f = ((dist_f < brk) & in_prof & in_lat
                 & ~(b["has_cut"] & (torch.abs(t_sup) < cut - bounds_eps)))
        emit(nx, ny, nz, cx_s - nx * dist_m, cy_s - ny * dist_m,
             cz_s - nz * dist_m, dist_f, act_f)

        # lateral u-break duplicate: the second witness the mesh produces
        # when the box spans two lateral quads
        span = t_hi - t_lo
        u_frac = torch.clamp((t_sup - t_lo) / span, 0.0, 1.0)
        t_s = t_lo + span * (torch.round(u_frac * N_LEN) / N_LEN)
        if side == 2:
            d_post = torch.abs(torch.abs(t_sup) - C.GOAL_HALF_WIDTH)
            t_post = torch.sign(t_sup) * C.GOAL_HALF_WIDTH
            t_s = torch.where(d_post < torch.abs(t_sup - t_s), t_post, t_s)
        side_of = t_sup >= t_s
        dmin_R = torch.full_like(h_sup, 1e9)
        t_R, ell_R = t_sup, ell_sup
        d_seam = torch.full_like(h_sup, 1e9)
        ell_sm = ell_sup
        for h_i, ct_, ell_i in hs:
            hh = torch.where((ct_ >= t_s) != side_of, h_i, 1e9)
            better = hh < dmin_R
            t_R = torch.where(better, ct_, t_R)
            ell_R = torch.where(better, ell_i, ell_R)
            dmin_R = torch.minimum(hh, dmin_R)
            ds_i = torch.sqrt(_sq(ct_ - t_s) + h_i * h_i)
            ell_sm = torch.where(ds_i < d_seam, ell_i, ell_sm)
            d_seam = torch.minimum(ds_i, d_seam)
        overlap_R = dmin_R < 0.0
        use_corner = dmin_R < d_seam
        dist_l = torch.where(overlap_R, h_sup,
                             torch.minimum(dmin_R, d_seam)) - dist_m
        t_wit = torch.where(overlap_R, t_s,
                            torch.where(use_corner, t_R, t_s))
        ell_wit = _clip(torch.where(overlap_R, ell_sup,
                                    torch.where(use_corner, ell_R, ell_sm)),
                        0.0, L)
        wwx, wwy, wwz = to_world(w0 + tw * ell_wit, t_wit, z0 + tz * ell_wit)
        act_l = (dist_l < brk) & in_prof & act_f
        emit(nx, ny, nz, wwx + nx * dist_l, wwy + ny * dist_l,
             wwz + nz * dist_l, dist_l, act_l)

        # profile band-seam rows, one per seam (top, bottom): box edge vs
        # seam with the raw interpolated normal
        for d_sm, t_sm, h_sm, dl_raw, ell_pos, flat in (
                (d_top, t_top, htop, elltop - L, L, b["hi_flat"]),
                (d_bot, t_bot, hbot, ellbot, torch.zeros_like(L),
                 b["lo_flat"])):
            dist_s = d_sm - dist_m
            wx2, wy2, wz2 = to_world(w0 + tw * ell_pos,
                                     _clip(t_sm, t_lo, t_hi),
                                     z0 + tz * ell_pos)
            inv = 1.0 / torch.clamp(d_sm, min=1e-6)
            dl = dl_raw * inv
            dh = h_sm * inv
            rnx, rny, rnz = _unfold_normal(t, side, tw * dl + fnw * dh,
                                           torch.zeros_like(dl),
                                           tz * dl + fnz * dh, sx, sy)
            act_s = ((dist_s < brk) & ~flat & (h_sm > 0.0)
                     & (t_sm >= t_lo - bounds_eps)
                     & (t_sm <= t_hi + bounds_eps))
            emit(rnx, rny, rnz, wx2 + rnx * dist_s, wy2 + rny * dist_s,
                 wz2 + rnz * dist_s, torch.where(act_s, dist_s, 1e9), act_s)

    coords = (ax, ay, pz)
    tail = rows[0][6].shape[1:]
    for axis, value, nsign, (ua, ulo, uhi), (va, vlo, vhi), _ in \
            goal_rects():
        w_q = coords[axis] - value
        sgn = torch.where(w_q * nsign >= 0, nsign, -nsign)
        comp = {axis: sgn, ua: 0.0, va: 0.0}
        ones = torch.ones_like(pz)
        nx = comp[0] * sx * ones
        ny = comp[1] * sy * ones
        nz = comp[2] * ones
        sup_x, sup_y, sup_z, r_eff = _box_support(px, py, pz, rot, he,
                                                  nx, ny, nz)
        dist = torch.abs(w_q) - r_eff
        sup = (sup_x * sx, sup_y * sy, sup_z)
        in_u = (sup[ua] >= ulo - bounds_eps) & (sup[ua] <= uhi + bounds_eps)
        in_v = (sup[va] >= vlo - bounds_eps) & (sup[va] <= vhi + bounds_eps)
        act = (dist < brk) & in_u & in_v
        rows.append(tuple(torch.broadcast_to(a, tail)[None]
                          for a in (nx, ny, nz, sup_x, sup_y, sup_z, dist,
                                    act)))
    return tuple(torch.cat([r[i] for r in rows]) for i in range(8))


def _box_support(px, py, pz, rot, he, nx, ny, nz):
    """Deepest box point along -n and the support radius along n."""
    sup_x, sup_y, sup_z = px, py, pz
    r_eff = 0.0
    for j in range(3):
        a0, a1, a2 = rot[0][j], rot[1][j], rot[2][j]
        d = nx * a0 + ny * a1 + nz * a2
        r_eff = r_eff + torch.abs(d) * he[j]
        s = torch.where(d >= 0, -he[j], he[j])
        sup_x = sup_x + a0 * s
        sup_y = sup_y + a1 * s
        sup_z = sup_z + a2 * s
    return sup_x, sup_y, sup_z, r_eff


# ---------------------------------------------------------------------------
# Floor / ceiling sheets

def _seg_line_closest(ax, ay, ah, bx, by, bh, q0x, q0y, ux, uy):
    """Closest pair between segment [a, b] (with heights) and the line
    q0 + t (ux, uy, 0) in the sheet plane: (witness x, y on the line,
    distance)."""
    dx, dy, dh = bx - ax, by - ay, bh - ah
    wx, wy = ax - q0x, ay - q0y
    b = dx * ux + dy * uy
    e = wx * ux + wy * uy
    rx, ry, rh = dx - b * ux, dy - b * uy, dh
    vx, vy, vh = wx - e * ux, wy - e * uy, ah
    denom = rx * rx + ry * ry + rh * rh
    s = torch.where(denom > 1e-12,
                    -(vx * rx + vy * ry + vh * rh)
                    / torch.clamp(denom, min=1e-12), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    t = e + s * b
    cx, cy = q0x + t * ux, q0y + t * uy
    px_, py_, ph_ = ax + s * dx, ay + s * dy, ah + s * dh
    return cx, cy, torch.sqrt(_sq(px_ - cx) + _sq(py_ - cy) + ph_ * ph_)


def sheet_box_contacts(px, py, pz, rot, he, off, z0, up_sign, core_margin,
                       dist_margin, brk, cell=SHEET_CELL):
    """Oriented box vs one tessellated horizontal sheet (the floor z=0 or
    the ceiling z=H grid of square cells split along the (+1, +1)
    diagonal): one contact per nearby triangle region, 0 the region of
    the deepest core support point, 1 its diagonal partner, 2 across the
    nearest x seam, 3 across the nearest y seam.  Per region the contact
    follows the triangle narrowphase's cases: a core corner below the
    sheet -> the overlap law at the support clamped onto the seam; a
    corner hovering over the region -> its vertical projection; else the
    closest box edge to the seam line.  ``px``.. is the car's position,
    ``off`` the hitbox offset; heights are ``up_sign * (z - z0)``.
    Returns 4 rows (nx, ny, nz, cx, cy, cz, dist, active)."""
    hc = tuple(he[i] - core_margin for i in range(3))
    zero = torch.zeros_like(px)

    def h_of(z):
        return up_sign * (z - z0)

    # deepest core support against the sheet normal (ties: +hc)
    sup_x, sup_y, sup_z = px, py, pz
    for j in range(3):
        a0, a1, a2 = rot[0][j], rot[1][j], rot[2][j]
        sup_x = sup_x + a0 * off[j]
        sup_y = sup_y + a1 * off[j]
        sup_z = sup_z + a2 * off[j]
        s = torch.where(-(up_sign * a2) >= 0, hc[j], -hc[j])
        sup_x = sup_x + a0 * s
        sup_y = sup_y + a1 * s
        sup_z = sup_z + a2 * s
    h_sup = h_of(sup_z)

    cxs, cys, chs = [], [], []
    for sg in CORNER_SIGNS:
        wx, wy, wz = _corner(px, py, pz, rot, tuple(
            off[i] + sg[i] * hc[i] for i in range(3)))
        cxs.append(wx)
        cys.append(wy)
        chs.append(h_of(wz))

    # the support point's cell, nearest seams, cell diagonal
    ox = torch.floor(sup_x / cell) * cell
    oy = torch.floor(sup_y / cell) * cell
    fx, fy = sup_x - ox, sup_y - oy
    xs = torch.where(fx < cell / 2, ox, ox + cell)
    ys = torch.where(fy < cell / 2, oy, oy + cell)
    sup_lower = (fx - fy) >= 0

    nz_ = torch.full_like(px, float(up_sign))
    z_sheet = torch.full_like(px, float(z0))

    def region_row(inside_of, clx, cly, line):
        dmin = torch.full_like(px, float("inf"))
        wx_c = wy_c = zero
        for i in range(8):
            better = inside_of(i) & (chs[i] < dmin)
            dmin = torch.where(better, chs[i], dmin)
            wx_c = torch.where(better, cxs[i], wx_c)
            wy_c = torch.where(better, cys[i], wy_c)
        d_seam = torch.full_like(px, float("inf"))
        sx_w = sy_w = zero
        for i, j in SHEET_EDGES:
            ex, ey, ed = _seg_line_closest(cxs[i], cys[i], chs[i], cxs[j],
                                           cys[j], chs[j], *line)
            closer = ed < d_seam
            d_seam = torch.where(closer, ed, d_seam)
            sx_w = torch.where(closer, ex, sx_w)
            sy_w = torch.where(closer, ey, sy_w)
        overlap = dmin < 0.0
        use_corner = dmin < d_seam
        dist = torch.where(overlap, h_sup,
                           torch.minimum(dmin, d_seam)) - dist_margin
        cx = torch.where(overlap, clx, torch.where(use_corner, wx_c, sx_w))
        cy = torch.where(overlap, cly, torch.where(use_corner, wy_c, sy_w))
        return zero, zero, nz_, cx, cy, z_sheet, dist, dist < brk

    dist0 = h_sup - dist_margin
    t = ((sup_x - ox) + (sup_y - oy)) * 0.5
    sup_right = sup_x >= xs
    sup_above = sup_y >= ys
    return [
        (zero, zero, nz_, sup_x, sup_y, z_sheet, dist0, dist0 < brk),
        region_row(
            lambda i: ((cxs[i] - ox) - (cys[i] - oy) >= 0) != sup_lower,
            ox + t, oy + t, (ox, oy, INV_SQRT2, INV_SQRT2)),
        region_row(lambda i: (cxs[i] >= xs) != sup_right, xs, sup_y,
                   (xs, oy, zero + 0.0, 1.0)),
        region_row(lambda i: (cys[i] >= ys) != sup_above, sup_x, ys,
                   (ox, ys, 1.0, zero + 0.0)),
    ]


def sheet_sphere_contacts(px, py, pz, radius, break_gap, z0, up_sign,
                          cell=SHEET_CELL):
    """Sphere vs one tessellated horizontal sheet: the containing
    triangle's foot contact plus seam duplicates across the cell diagonal
    and the nearest x and y seams, all with the face normal.  Returns 4
    rows (nx, ny, nz, cx, cy, gap, active); (cx, cy) is the witness for
    the octagon-clip test."""
    zero = torch.zeros_like(px)
    nz_ = torch.full_like(px, float(up_sign))
    h = up_sign * (pz - z0)
    ox = torch.floor(px / cell) * cell
    oy = torch.floor(py / cell) * cell
    fx, fy = px - ox, py - oy
    xs = torch.where(fx < cell / 2, ox, ox + cell)
    ys = torch.where(fy < cell / 2, oy, oy + cell)
    h2 = h * h
    gap0 = torch.abs(h) - radius
    d_diag = torch.abs(fx - fy) * INV_SQRT2
    t_d = (fx + fy) * 0.5
    gap_d = torch.sqrt(h2 + d_diag * d_diag) - radius
    d_x = torch.abs(px - xs)
    gap_x = torch.sqrt(h2 + d_x * d_x) - radius
    d_y = torch.abs(py - ys)
    gap_y = torch.sqrt(h2 + d_y * d_y) - radius
    return [(zero, zero, nz_, cx, cy, g, g < break_gap)
            for cx, cy, g in ((px, py, gap0), (ox + t_d, oy + t_d, gap_d),
                              (xs, py, gap_x), (px, ys, gap_y))]


def sheet_clip_ok(tab: FacetTables, cx, cy, inset: float, eps: float = 1.0):
    """True where (cx, cy) lies inside the sheet's octagon clip (the
    inward-offset octagon at the sheet's fillet inset), where the floor
    and ceiling grid triangles exist."""
    ax = cx * torch.where(cx >= 0, 1.0, -1.0)
    ay = cy * torch.where(cy >= 0, 1.0, -1.0)
    ok = torch.ones_like(cx, dtype=torch.bool)
    for side in range(N_SIDES):
        ok = ok & (_side_coords(tab, side, ax, ay)[0] <= -inset + eps)
    return ok


# ---------------------------------------------------------------------------
# Rays

def _ray_band_hits(t, side, ax, ay, oz, adx, ady, dz, sx, sy, max_len,
                   bounds_eps):
    """One side's bands, (N_PROFILE_BANDS,) + S: the hit distance (inf
    where the band is not hit within max_len) and its normal, facing back
    along the ray."""
    b = _bands(t, side, ax)
    z0, w0, tw, tz, L, nw, nzb = (b[k] for k in (
        "z0", "w0", "tw", "tz", "L", "nw", "nz"))
    w_o, t_o = _side_coords(t, side, ax, ay)
    w_d = t.side_nx[side] * adx + t.side_ny[side] * ady
    t_d = t.side_ux[side] * adx + t.side_uy[side] * ady
    denom = w_d * nw + dz * nzb
    s_o = (w_o - w0) * nw + (oz - z0) * nzb
    safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t_hit = -s_o / safe
    w_h = w_o + w_d * t_hit
    t_h = t_o + t_d * t_hit
    z_h = oz + dz * t_hit
    ell = (w_h - w0) * tw + (z_h - z0) * tz
    t_lo = t.lo0[side] - t.loS[side] * w_h
    t_hi = t.hi0[side] - t.hiS[side] * w_h
    cut = b["cut_t0"] - b["cut_ts"] * w_h
    ok = ((torch.abs(denom) > 1e-9)
          & (ell >= -bounds_eps) & (ell <= L + bounds_eps)
          & (t_h >= t_lo - bounds_eps) & (t_h <= t_hi + bounds_eps)
          & ~(b["has_cut"] & (torch.abs(t_h) < cut - bounds_eps)))
    flip = torch.where(denom > 0, -1.0, 1.0)
    nrm = _unfold_normal(t, side, nw * flip, 0.0, nzb * flip, sx, sy)
    t_hit = torch.where(ok & (t_hit >= 0) & (t_hit <= max_len), t_hit,
                        float("inf"))
    return t_hit, nrm


def _ray_rect_hits(ax, ay, oz, adx, ady, dz, sx, sy, max_len, bounds_eps):
    """Per goal rectangle: the hit distance (inf where none within max_len)
    and its normal."""
    coords_o, coords_d = (ax, ay, oz), (adx, ady, dz)
    out = []
    for axis, value, _, (ua, ulo, uhi), (va, vlo, vhi), _ in goal_rects():
        denom = coords_d[axis]
        safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        t_hit = (value - coords_o[axis]) / safe
        u_h = coords_o[ua] + coords_d[ua] * t_hit
        v_h = coords_o[va] + coords_d[va] * t_hit
        ok = ((torch.abs(denom) > 1e-9)
              & (u_h >= ulo - bounds_eps) & (u_h <= uhi + bounds_eps)
              & (v_h >= vlo - bounds_eps) & (v_h <= vhi + bounds_eps))
        flip = torch.where(denom > 0, -1.0, 1.0)
        zeros = torch.zeros_like(t_hit)
        comp = {axis: flip, ua: zeros, va: zeros}
        out.append((torch.where(ok & (t_hit >= 0) & (t_hit <= max_len),
                                t_hit, float("inf")),
                    (comp[0] * sx, comp[1] * sy, comp[2])))
    return out


def raycasts(ox, oy, oz, dx, dy, dz, max_len, tab: FacetTables = None,
             bounds_eps: float = 0.5):
    """Ray (origin o, direction d, length max_len) vs every facet: (dist,
    nx, ny, nz, hit) of the nearest hit; the normal faces back along the
    ray."""
    t = tab or tables()
    sx, sy = _fold_sign(ox), _fold_sign(oy)
    ax, ay = ox * sx, oy * sy
    adx, ady = dx * sx, dy * sy
    best = torch.full_like(ox, float("inf"))
    bnx = bny = bnz = torch.zeros_like(ox)

    def consider(t_hit, nx, ny, nz):
        nonlocal best, bnx, bny, bnz
        closer = t_hit < best
        bnx = torch.where(closer, nx, bnx)
        bny = torch.where(closer, ny, bny)
        bnz = torch.where(closer, nz, bnz)
        best = torch.minimum(best, t_hit)

    for side in range(N_SIDES):
        t_hit, nrm = _ray_band_hits(t, side, ax, ay, oz, adx, ady, dz, sx,
                                    sy, max_len, bounds_eps)
        # nearest band first (lowest band on ties)
        k = torch.argmin(t_hit, dim=0, keepdim=True)
        consider(t_hit.gather(0, k)[0],
                 *(torch.broadcast_to(c, t_hit.shape).gather(0, k)[0]
                   for c in nrm))
    for t_hit, nrm in _ray_rect_hits(ax, ay, oz, adx, ady, dz, sx, sy,
                                      max_len, bounds_eps):
        consider(t_hit, *nrm)
    hit = torch.isfinite(best)
    return torch.where(hit, best, max_len), bnx, bny, bnz, hit


def ray_facet_hits(ox, oy, oz, dx, dy, dz, max_len, tab: FacetTables = None,
                   bounds_eps: float = 0.5):
    """Ray vs every facet item: the hit distance of each (side, band),
    (N_SIDES * N_PROFILE_BANDS,) + S side-major, and of each goal
    rectangle, (N_GOAL_FACETS,) + S; inf where the item is not hit within
    max_len."""
    t = tab or tables()
    sx, sy = _fold_sign(ox), _fold_sign(oy)
    ax, ay = ox * sx, oy * sy
    adx, ady = dx * sx, dy * sy
    bands = [_ray_band_hits(t, side, ax, ay, oz, adx, ady, dz, sx, sy,
                            max_len, bounds_eps)[0]
             for side in range(N_SIDES)]
    rects = [r[0] for r in _ray_rect_hits(ax, ay, oz, adx, ady, dz, sx, sy,
                                          max_len, bounds_eps)]
    return torch.cat(bands), torch.stack(rects)


# ---------------------------------------------------------------------------
# Culls: the arena-step kernel's tests for skipping a facet item (a side's
# band, a goal rectangle, a sheet) for a body or a ray, as in csrc/
# facets.cuh.  Each returns True where none of the item's rows can be live,
# or the ray cannot hit it: a lower bound of every row distance the item
# can yield reaches the break gap.  CULL_SLACK covers the bound's rounding
# against the rows' own arithmetic.  The plain queries do not use them; the
# tests hold them against the live rows and hits, and the card tests hold
# the kernel that uses them against the plain step.

CULL_SLACK = 1.0


def _band_seg_dist(b, w, z):
    """Distance in a side's (w, z) plane to each band's profile segment."""
    ell = _clip((w - b["w0"]) * b["tw"] + (z - b["z0"]) * b["tz"], 0.0,
                b["L"])
    dw = w - (b["w0"] + b["tw"] * ell)
    dz = z - (b["z0"] + b["tz"] * ell)
    return torch.sqrt(dw * dw + dz * dz)


def sphere_band_culled(px, py, pz, radius, break_gap,
                       tab: FacetTables = None):
    """(N_SIDES * N_PROFILE_BANDS,) + S, side-major: every sphere row of the
    band measures a distance to a point of the band, so gap >= the
    centre's distance to the band's profile segment - radius."""
    t = tab or tables()
    ax, ay = px * _fold_sign(px), py * _fold_sign(py)
    out = []
    for side in range(N_SIDES):
        w_q, _ = _side_coords(t, side, ax, ay)
        out.append(_band_seg_dist(_bands(t, side, px), w_q, pz) - radius
                   >= break_gap + CULL_SLACK)
    return torch.cat(out)


def box_band_culled(px, py, pz, rot, hc, dist_m, brk,
                    tab: FacetTables = None):
    """(N_SIDES * N_PROFILE_BANDS,) + S for the box centred at px/py/pz
    (rotation ``rot`` as nested row tuples, core half extents ``hc``):
    dead where the core corners' band-plane heights (the centre's |s_d|
    minus at most the core support radius along the band normal) all
    reach brk + dist_m, or where the centre is farther from the band's
    profile segment than a live row's corner can be (1 uu along it, the
    larger of the core radius and brk + dist_m across it) plus the core
    radius."""
    t = tab or tables()
    sx, sy = _fold_sign(px), _fold_sign(py)
    ax, ay = px * sx, py * sy
    rc = float(np.sqrt(sum(float(h) * float(h) for h in hc)))
    reach = brk + dist_m
    out = []
    for side in range(N_SIDES):
        b = _bands(t, side, px)
        w_q, _ = _side_coords(t, side, ax, ay)
        s_d = (w_q - b["w0"]) * b["nw"] + (pz - b["z0"]) * b["nz"]
        mx = t.side_nx[side] * b["nw"] * sx
        my = t.side_ny[side] * b["nw"] * sy
        mz = b["nz"]
        r_sup = 0.0
        for j in range(3):
            r_sup = r_sup + hc[j] * torch.abs(
                mx * rot[0][j] + my * rot[1][j] + mz * rot[2][j])
        out.append((torch.abs(s_d) - r_sup >= reach + CULL_SLACK)
                   | (_band_seg_dist(b, w_q, pz)
                      >= rc + 1.0 + max(rc, reach) + CULL_SLACK))
    return torch.cat(out)


def ray_band_culled(ox, oy, oz, max_len, tab: FacetTables = None):
    """(N_SIDES * N_PROFILE_BANDS,) + S: a hit lies within 0.5 uu of the
    band's profile segment and within max_len of the origin."""
    t = tab or tables()
    ax, ay = ox * _fold_sign(ox), oy * _fold_sign(oy)
    out = []
    for side in range(N_SIDES):
        w_o, _ = _side_coords(t, side, ax, ay)
        out.append(_band_seg_dist(_bands(t, side, ox), w_o, oz)
                   > max_len + 0.5 + CULL_SLACK)
    return torch.cat(out)


def _rect_dist(ax, ay, pz, widen):
    """Per goal rectangle: the distance from the folded point to the
    rectangle widened by ``widen``, its plane offset and in-plane
    coordinates."""
    coords = (ax, ay, pz)
    out = []
    for axis, value, _, (ua, ulo, uhi), (va, vlo, vhi), _ in goal_rects():
        w_q = coords[axis] - value
        u_q, v_q = coords[ua], coords[va]
        du = u_q - torch.clamp(u_q, ulo - widen, uhi + widen)
        dv = v_q - torch.clamp(v_q, vlo - widen, vhi + widen)
        out.append((torch.sqrt(w_q * w_q + du * du + dv * dv), w_q, u_q,
                    v_q, (ulo, uhi, vlo, vhi)))
    return out


def rect_culled(kind, px, py, pz, reach, size=0.0, bounds_eps=None):
    """(N_GOAL_FACETS,) + S: the goal rectangles an item of ``kind`` skips.
    ``sphere``: reach = break gap, size = radius (every row's gap is at
    least the distance to the rectangle - radius); ``ray``: reach =
    max_len (a hit lies on the rectangle widened by 0.5 uu); ``box``:
    reach = brk, size = the box's bounding radius |he| (the support point
    lies within it of the centre, and must lie on the rectangle widened by
    1 uu)."""
    ax, ay = px * _fold_sign(px), py * _fold_sign(py)
    out = []
    if kind == "sphere":
        for dist, *_ in _rect_dist(ax, ay, pz, 0.0):
            out.append(dist - size >= reach + CULL_SLACK)
    elif kind == "ray":
        for dist, *_ in _rect_dist(ax, ay, pz, 0.5):
            out.append(dist > reach + CULL_SLACK)
    elif kind == "box":
        far = size + CULL_SLACK
        for _, w_q, u_q, v_q, (ulo, uhi, vlo, vhi) in _rect_dist(
                ax, ay, pz, 0.0):
            out.append((torch.abs(w_q) - size >= reach + CULL_SLACK)
                       | (u_q < ulo - 1.0 - far) | (u_q > uhi + 1.0 + far)
                       | (v_q < vlo - 1.0 - far) | (v_q > vhi + 1.0 + far))
    else:
        raise ValueError(kind)
    return torch.stack(out)


def sheet_culled(kind, pz, up_sign, z0, reach, size=0.0, rot=None,
                 hc=None):
    """A floor (z0 = 0, up +1) or ceiling sheet skipped for a body at
    height pz: every sheet row's distance is at least the body's lowest
    height above the sheet (``sphere``: pz is the centre, size the radius;
    ``box``: pz the core box centre, ``rot`` its rotation, ``hc`` its core
    half extents, size = dist_m) minus size."""
    h = up_sign * (pz - z0)
    if kind == "sphere":
        return torch.abs(h) - size >= reach + CULL_SLACK
    r = (hc[0] * torch.abs(rot[2][0]) + hc[1] * torch.abs(rot[2][1])
         + hc[2] * torch.abs(rot[2][2]))
    return h - r - size >= reach + CULL_SLACK
