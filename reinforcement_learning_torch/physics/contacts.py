"""Contact generation and impulse resolution of the portable physics
engine, batched over arenas.

Reimplements the subset of the reference's patched Bullet solver that the
game exercises:

  * sequential-impulse contact with a restitution threshold and
    split-impulse positional pushout (reference:
    btSequentialImpulseConstraintSolver.cpp:795-980 setupContactConstraint;
    erp2=0.8 and a huge split threshold set in Arena.cpp:485-489)
  * the ROCKETSIM "special" ball-world resolve that merges every ball-world
    manifold point into one averaged contact with no positional term
    (reference: btSequentialImpulseConstraintSolver.cpp:1164-1212)
  * material combination rules: vs static -> friction=min,
    restitution=max; dynamic pairs -> product, except the pairs the arena
    callbacks override (reference: btManifoldResult.cpp:56-77,
    Arena.cpp:283-427)
  * car-ball "psyonix impulse" + BallHitInfo (reference: Arena.cpp:283-334)
  * car-car bumps and demos (reference: Arena.cpp:336-418)

Every function takes an arena axis first: cars ``(N, C, ...)``, the ball
``(N, ...)``.  The Gauss-Seidel solvers run their rows in Bullet's order as
Python loops over rows and iterations; nothing in here reads a tensor's
value on the host.  All math is in BT units (1 bt = 50 uu) because the
impulse denominators involve the inertia tensor; inputs and outputs are uu.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.device import constant
from reinforcement_learning_torch.maths import take_along_axis
from reinforcement_learning_torch.physics import arena_geom as geom
from reinforcement_learning_torch.physics import box_box, box_tri, formulas
from reinforcement_learning_torch.physics.car import inv_inertia_world
from reinforcement_learning_torch.physics.mesh import (
    _closest_point_triangle, compact_sel)
from reinforcement_learning_torch.physics.state import (BallState, CarsState,
                                                        MutatorConfig)

# Compacted-candidate widths of the mesh narrowphase (the JAX package's
# contacts.py:665-667, validated there by arena sweeps)
MESH_COMPACT_K_BALL = 32
MESH_COMPACT_K_CAR = 24


def _f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's float32 constants."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """Constant tensors on ``device``, copied there once."""
    signs = [[ix, iy, iz] for ix in (-1, 1) for iy in (-1, 1)
             for iz in (-1, 1)]
    return dict(eye=torch.eye(3, device=device),
                corner_signs=torch.tensor(signs, dtype=torch.float32,
                                          device=device),
                arange4=torch.arange(4, device=device),
                up=torch.tensor([0.0, 0.0, 1.0], device=device))


@functools.lru_cache(maxsize=None)
def _true_planes(mode: str, device: torch.device):
    """(normals (T, 3), offsets (T,)) of the real btStaticPlaneShapes."""
    pn, pd = geom.get_planes(mode, device)
    keep = np.flatnonzero(geom.get_true_plane_mask(mode, "cpu").numpy())
    idx = torch.as_tensor(keep, device=device)
    return pn[idx], pd[idx]


def _restitution_rhs(rel_vel, combined_restitution):
    """bullet restitutionCurve with the velocity threshold (the Arena's
    0.2 bt/s)."""
    rest = combined_restitution * -rel_vel
    rest = torch.where(torch.abs(rel_vel) < 0.2, 0.0, rest)
    return torch.clamp(rest, min=0.0)


def _plane_space_dir(n):
    """bullet btPlaneSpace1's first tangent: the friction direction when
    the tangential relative velocity is ~zero."""
    nz_big = torch.abs(n[..., 2]) > 0.70710678
    a = n[..., 1] ** 2 + n[..., 2] ** 2
    k1 = 1.0 / torch.sqrt(torch.clamp(a, min=1e-12))
    t1 = torch.stack([torch.zeros_like(k1), -n[..., 2] * k1, n[..., 1] * k1],
                     dim=-1)
    b = n[..., 0] ** 2 + n[..., 1] ** 2
    k2 = 1.0 / torch.sqrt(torch.clamp(b, min=1e-12))
    t2 = torch.stack([-n[..., 1] * k2, n[..., 0] * k2, torch.zeros_like(k2)],
                     dim=-1)
    return torch.where(nz_big[..., None], t1, t2)


def _unbind_rows(x, dim=-2):
    return list(torch.unbind(x, dim=dim))


def pgs_rows_vs_static(vel_bt, ang_vel, r_bt, n, active, inv_mass, inv_iw,
                       restitution_coeff, friction_coeff, dist_bt, dt,
                       vel_pre_bt=None, ang_vel_pre=None, iterations=10):
    """Bullet-order PGS over R contact rows of one dynamic body against the
    static world (btSequentialImpulseConstraintSolver with the fork's
    settings: 10 iterations, split impulse always on, erp2=0.8, no creep
    allowance, restitution threshold 0.2, one velocity-dependent friction
    direction per row with the btPlaneSpace1 fallback).

    Per iteration every normal row is solved in row order, then every
    friction row (SOLVER_INTERLEAVE_CONTACT_AND_FRICTION off), as
    solveSingleIteration does.  A second PGS with the same jacobians
    solves the split-impulse positional rows
    (resolveSplitPenetrationImpulse); the angular pseudo-velocity is scaled
    by splitImpulseTurnErp=0.1 at writeback.

    Shapes: vel_bt/ang_vel (..., 3); r_bt/n (..., R, 3); active/dist_bt
    (..., R); inv_iw (..., 3, 3).  dist_bt: contact distance (negative =
    penetration) in BT units.

    Returns (dv_bt (..., 3), dw (..., 3), push_bt (..., 3) position delta,
    turn (..., 3) extra rotation vector, j_n (..., R) accumulated normal
    impulses)."""
    R = n.shape[-2]
    vel_at = vel_bt[..., None, :] + m.cross(ang_vel[..., None, :], r_bt)
    iw_rows = inv_iw[..., None, :, :]

    torque_axis = m.cross(r_bt, n)
    ang_comp = m.rotate(iw_rows, torque_axis)
    denom = inv_mass + m.dot(n, m.cross(ang_comp, r_bt))
    jac_inv = 1.0 / torch.clamp(denom, min=1e-12)

    # restitution from the pre-force velocities (see the module docstring)
    if vel_pre_bt is None:
        rel_rest = m.dot(n, vel_at)
    else:
        wpre = ang_vel if ang_vel_pre is None else ang_vel_pre
        rel_rest = m.dot(n, vel_pre_bt[..., None, :]
                         + m.cross(wpre[..., None, :], r_bt))
    rest = _restitution_rhs(rel_rest, restitution_coeff)

    # friction direction at setup: the tangential relative velocity (with
    # forces); btPlaneSpace1 when ~zero (convertContactInner)
    tang = vel_at - n * m.dot(n, vel_at, keepdim=True)
    t_len = m.norm(tang, keepdim=True)
    t_dir = torch.where(t_len > 1.49e-8, tang / torch.clamp(t_len, min=1e-12),
                        _plane_space_dir(n))
    t_axis = m.cross(r_bt, t_dir)
    t_ang = m.rotate(iw_rows, t_axis)
    t_denom = inv_mass + m.dot(t_dir, m.cross(t_ang, r_bt))
    t_jac_inv = 1.0 / torch.clamp(t_denom, min=1e-12)

    # positional rhs: -penetration * erp2 / dt while penetrating
    push_target = torch.clamp(-dist_bt, min=0.0) * (C.SOLVER_ERP2 / dt)

    act = active.to(n.dtype)
    ns, rs, ts = _unbind_rows(n), _unbind_rows(r_bt), _unbind_rows(t_dir)
    acts, rests, jinv = (_unbind_rows(act, -1), _unbind_rows(rest, -1),
                         _unbind_rows(jac_inv, -1))
    tjinv, pts = _unbind_rows(t_jac_inv, -1), _unbind_rows(push_target, -1)
    zero3 = torch.zeros_like(vel_bt)
    zeroR = torch.zeros(n.shape[:-2], dtype=n.dtype, device=n.device)

    # --- velocity PGS
    dv, dw = zero3, zero3
    j_n = [zeroR] * R
    j_t = [zeroR] * R
    for _ in range(iterations):
        for i in range(R):
            ni, ri = ns[i], rs[i]
            rel = m.dot(ni, (vel_bt + dv) + m.cross(ang_vel + dw, ri))
            dj = (rests[i] - rel) * jinv[i]
            new_acc = torch.clamp(j_n[i] + dj, min=0.0)
            dj = (new_acc - j_n[i]) * acts[i]
            imp = ni * dj[..., None]
            dv = dv + imp * inv_mass
            dw = dw + m.rotate(inv_iw, m.cross(ri, imp))
            j_n[i] = j_n[i] + dj
        for i in range(R):
            ti, ri = ts[i], rs[i]
            rel = m.dot(ti, (vel_bt + dv) + m.cross(ang_vel + dw, ri))
            dj = -rel * tjinv[i]
            lim = friction_coeff * j_n[i]
            new_acc = torch.minimum(torch.maximum(j_t[i] + dj, -lim), lim)
            dj = (new_acc - j_t[i]) * acts[i]
            # bullet skips friction rows whose normal impulse is 0
            dj = torch.where(j_n[i] > 0, dj, 0.0)
            imp = ti * dj[..., None]
            dv = dv + imp * inv_mass
            dw = dw + m.rotate(inv_iw, m.cross(ri, imp))
            j_t[i] = j_t[i] + dj

    # --- split-impulse positional PGS (same jacobians, push target)
    pv, pw = zero3, zero3
    j_p = [zeroR] * R
    for _ in range(iterations):
        for i in range(R):
            ni, ri = ns[i], rs[i]
            rel = m.dot(ni, pv + m.cross(pw, ri))
            dj = (pts[i] - rel) * jinv[i]
            new_acc = torch.clamp(j_p[i] + dj, min=0.0)
            dj = (new_acc - j_p[i]) * acts[i]
            imp = ni * dj[..., None]
            pv = pv + imp * inv_mass
            pw = pw + m.rotate(inv_iw, m.cross(ri, imp))
            j_p[i] = j_p[i] + dj

    push = pv * dt
    turn = pw * (C.SPLIT_IMPULSE_TURN_ERP * dt)
    return dv, dw, push, turn, torch.stack(j_n, dim=-1)


def pgs_rows_two_body(v0, w0, v1, w1, r0, r1, n, active, inv_mass0,
                      inv_mass1, inv_iw0, inv_iw1, restitution_coeff,
                      friction_coeff, dist_bt, dt, v0_pre=None, v1_pre=None,
                      iterations=10):
    """Bullet-order PGS over R contact rows between TWO dynamic bodies (the
    car-car case; the solver settings of :func:`pgs_rows_vs_static`).

    ``n`` is the manifold normal on B (impulse +n on body 0, -n on body 1,
    bullet's m_contactNormal1/2 convention); ``r0``/``r1`` are the lever
    arms positionWorldOnA - com0 / positionWorldOnB - com1.

    Shapes: v0/w0/v1/w1 (..., 3); r0/r1/n (..., R, 3); active/dist_bt
    (..., R).  Returns (dv0, dw0, dv1, dw1, push0, push1, turn0, turn1,
    j_n)."""
    R = n.shape[-2]

    def _vel_at(v, w, r):
        return v[..., None, :] + m.cross(w[..., None, :], r)

    iw0, iw1 = inv_iw0[..., None, :, :], inv_iw1[..., None, :, :]
    ang0 = m.rotate(iw0, m.cross(r0, n))
    ang1 = m.rotate(iw1, m.cross(r1, n))
    denom = (inv_mass0 + inv_mass1
             + m.dot(n, m.cross(ang0, r0))
             + m.dot(n, m.cross(ang1, r1)))
    jac_inv = 1.0 / torch.clamp(denom, min=1e-12)

    # restitution from the pre-force velocities
    v0r = v0 if v0_pre is None else v0_pre
    v1r = v1 if v1_pre is None else v1_pre
    rel_rest = m.dot(n, _vel_at(v0r, w0, r0) - _vel_at(v1r, w1, r1))
    rest = _restitution_rhs(rel_rest, restitution_coeff)

    # one friction direction per row from the setup-time relative
    # tangential velocity, with the btPlaneSpace1 fallback
    rel_v = _vel_at(v0, w0, r0) - _vel_at(v1, w1, r1)
    tang = rel_v - n * m.dot(n, rel_v, keepdim=True)
    t_len = m.norm(tang, keepdim=True)
    t_dir = torch.where(t_len > 1.49e-8, tang / torch.clamp(t_len, min=1e-12),
                        _plane_space_dir(n))
    f_ang0 = m.rotate(iw0, m.cross(r0, t_dir))
    f_ang1 = m.rotate(iw1, m.cross(r1, t_dir))
    t_denom = (inv_mass0 + inv_mass1
               + m.dot(t_dir, m.cross(f_ang0, r0))
               + m.dot(t_dir, m.cross(f_ang1, r1)))
    t_jac_inv = 1.0 / torch.clamp(t_denom, min=1e-12)

    push_target = torch.clamp(-dist_bt, min=0.0) * (C.SOLVER_ERP2 / dt)

    act = active.to(n.dtype)
    ns, ts = _unbind_rows(n), _unbind_rows(t_dir)
    r0s, r1s = _unbind_rows(r0), _unbind_rows(r1)
    acts, rests, jinv = (_unbind_rows(act, -1), _unbind_rows(rest, -1),
                         _unbind_rows(jac_inv, -1))
    tjinv, pts = _unbind_rows(t_jac_inv, -1), _unbind_rows(push_target, -1)
    zero3 = torch.zeros_like(v0)
    zeroR = torch.zeros(n.shape[:-2], dtype=n.dtype, device=n.device)

    def _apply(dv0, dw0, dv1, dw1, direction, ri0, ri1, dj):
        imp = direction * dj[..., None]
        dv0 = dv0 + imp * inv_mass0
        dw0 = dw0 + m.rotate(inv_iw0, m.cross(ri0, imp))
        dv1 = dv1 - imp * inv_mass1
        dw1 = dw1 - m.rotate(inv_iw1, m.cross(ri1, imp))
        return dv0, dw0, dv1, dw1

    dv0 = dw0 = dv1 = dw1 = zero3
    j_n = [zeroR] * R
    j_t = [zeroR] * R
    for _ in range(iterations):
        for i in range(R):
            ni, ri0, ri1 = ns[i], r0s[i], r1s[i]
            rel = m.dot(ni, (v0 + dv0) + m.cross(w0 + dw0, ri0)
                        - (v1 + dv1) - m.cross(w1 + dw1, ri1))
            dj = (rests[i] - rel) * jinv[i]
            new_acc = torch.clamp(j_n[i] + dj, min=0.0)
            dj = (new_acc - j_n[i]) * acts[i]
            dv0, dw0, dv1, dw1 = _apply(dv0, dw0, dv1, dw1, ni, ri0, ri1, dj)
            j_n[i] = j_n[i] + dj
        for i in range(R):
            ti, ri0, ri1 = ts[i], r0s[i], r1s[i]
            rel = m.dot(ti, (v0 + dv0) + m.cross(w0 + dw0, ri0)
                        - (v1 + dv1) - m.cross(w1 + dw1, ri1))
            dj = -rel * tjinv[i]
            lim = friction_coeff * j_n[i]
            new_acc = torch.minimum(torch.maximum(j_t[i] + dj, -lim), lim)
            dj = (new_acc - j_t[i]) * acts[i]
            dj = torch.where(j_n[i] > 0, dj, 0.0)
            dv0, dw0, dv1, dw1 = _apply(dv0, dw0, dv1, dw1, ti, ri0, ri1, dj)
            j_t[i] = j_t[i] + dj

    pv0 = pw0 = pv1 = pw1 = zero3
    j_p = [zeroR] * R
    for _ in range(iterations):
        for i in range(R):
            ni, ri0, ri1 = ns[i], r0s[i], r1s[i]
            rel = m.dot(ni, pv0 + m.cross(pw0, ri0)
                        - pv1 - m.cross(pw1, ri1))
            dj = (pts[i] - rel) * jinv[i]
            new_acc = torch.clamp(j_p[i] + dj, min=0.0)
            dj = (new_acc - j_p[i]) * acts[i]
            pv0, pw0, pv1, pw1 = _apply(pv0, pw0, pv1, pw1, ni, ri0, ri1, dj)
            j_p[i] = j_p[i] + dj

    return (dv0, dw0, dv1, dw1, pv0 * dt, pv1 * dt,
            pw0 * (C.SPLIT_IMPULSE_TURN_ERP * dt),
            pw1 * (C.SPLIT_IMPULSE_TURN_ERP * dt), torch.stack(j_n, dim=-1))


def _contact_impulse_vs_static(vel_bt, ang_vel, r_bt, n, inv_mass, inv_iw,
                               restitution_coeff, friction_coeff,
                               vel_pre_bt=None, ang_vel_pre=None,
                               iterations: int = 1):
    """One contact of a dynamic body against the static world.

    Returns (dv_bt (..., 3), dw (..., 3), normal_impulse (...,)).  Solves
    the normal row (accumulated impulse clamped >= 0) and a friction row
    along the setup-time tangential direction (accumulated impulse clamped
    to mu * j_n), sequentially like Bullet's solver; ``iterations`` > 1
    repeats the pair with running velocities.

    ``vel_pre_bt``/``ang_vel_pre``: the velocity BEFORE this tick's force
    integration.  Bullet keeps forces in the solver body's
    ``m_externalForceImpulse`` and evaluates restitution on the velocity
    WITHOUT them while the constraint drives the velocity WITH them
    (btSequentialImpulseConstraintSolver.cpp:458-476)."""
    vel_at = vel_bt + m.cross(ang_vel, r_bt)
    rel_vel = m.dot(n, vel_at)

    torque_axis = m.cross(r_bt, n)
    ang_comp = m.rotate(inv_iw, torque_axis)
    denom = torch.clamp(inv_mass + m.dot(n, m.cross(ang_comp, r_bt)),
                        min=1e-12)

    if vel_pre_bt is None:
        rel_vel_rest = rel_vel
    else:
        wpre = ang_vel if ang_vel_pre is None else ang_vel_pre
        rel_vel_rest = m.dot(n, vel_pre_bt + m.cross(wpre, r_bt))
    rest = _restitution_rhs(rel_vel_rest, restitution_coeff)

    # the friction direction is fixed at constraint SETUP from the
    # pre-solve relative velocity (setupContactConstraint); only the
    # magnitude rows see running velocities
    tang = vel_at - n * m.dot(n, vel_at, keepdim=True)
    t_len = m.norm(tang, keepdim=True)
    t_dir = torch.where(t_len > 1e-9, tang / torch.clamp(t_len, min=1e-9),
                        0.0)
    t_axis = m.cross(r_bt, t_dir)
    t_ang = m.rotate(inv_iw, t_axis)
    t_denom = torch.clamp(inv_mass + m.dot(t_dir, m.cross(t_ang, r_bt)),
                          min=1e-12)

    def _apply(imp):
        return imp * inv_mass, m.rotate(inv_iw, m.cross(r_bt, imp))

    dv = torch.zeros_like(vel_at)
    dw = torch.zeros_like(vel_at)
    j_n = torch.zeros_like(rel_vel)
    j_t = torch.zeros_like(rel_vel)
    for _ in range(iterations):
        # normal row
        v_at = (vel_bt + dv) + m.cross(ang_vel + dw, r_bt)
        dj = (rest - m.dot(n, v_at)) / denom
        new_acc = torch.clamp(j_n + dj, min=0.0)
        ddv, ddw = _apply(n * (new_acc - j_n)[..., None])
        dv, dw, j_n = dv + ddv, dw + ddw, new_acc
        # friction row (limit from the current normal accumulator)
        v_at = (vel_bt + dv) + m.cross(ang_vel + dw, r_bt)
        djt = -m.dot(t_dir, v_at) / t_denom
        lim = friction_coeff * j_n
        new_t = torch.minimum(torch.maximum(j_t + djt, -lim), lim)
        ddv, ddw = _apply(t_dir * (new_t - j_t)[..., None])
        dv, dw, j_t = dv + ddv, dw + ddw, new_t
    return dv, dw, j_n


def resolve_ball_world(ball: BallState, mut: MutatorConfig,
                       puck_axis=None, game_mode: str = "soccar",
                       vel_pre_uu=None, grid=None):
    """Ball vs arena: the ROCKETSIM merged special contact.

    A contact is live while the surface gap is inside the pair's contact
    breaking threshold, 0.02*(radius_bt + 0.08) for the ball sphere
    (btCollisionShape.cpp:130-133,147-149).  While live, approach along the
    normal is fully blocked and restitution fires off the PRE-gravity
    velocity (``vel_pre_uu``); split-impulse pushout happens only at true
    overlap (gap < 0).

    ``puck_axis`` (snowday, (N, 3)): the puck cylinder's axis in the world
    frame; the exact cylinder support distance against each plane replaces
    the sphere radius.

    Returns (dvel_uu (N, 3), dang_vel (N, 3), pos_push_uu (N, 3), touching
    (N,), navg (N, 3) the average contact normal)."""
    dev = ball.pos.device
    pn, _ = geom.get_planes(game_mode, dev)
    dist_p = geom.signed_distances(ball.pos, game_mode)       # (N, P)
    valid = geom.plane_validity(ball.pos, game_mode)
    if grid is not None and puck_axis is None:
        # mesh world: only the 4 btStaticPlaneShapes remain as planes
        # (Arena.cpp:1060-1100); the rest comes from the triangle mesh
        valid = valid & geom.get_true_plane_mask(game_mode, dev)
    if puck_axis is None:
        support = torch.full_like(dist_p, mut.ball_radius)
        break_gap = C.CONTACT_BREAK_FRAC * (mut.ball_radius
                                            + C.SPHERE_BOUND_EXTRA)
    else:
        a_dot_n = torch.sum(puck_axis[:, None, :] * pn, dim=-1)
        support = (C.Snowday.PUCK_RADIUS
                   * torch.sqrt(torch.clamp(1.0 - a_dot_n ** 2, min=0.0))
                   + (C.Snowday.PUCK_HEIGHT / 2) * torch.abs(a_dot_n))
        # cylinder convex hull: disc = bounding sphere of the point cloud
        disc = float(np.hypot(C.Snowday.PUCK_RADIUS,
                              C.Snowday.PUCK_HEIGHT / 2))
        break_gap = C.CONTACT_BREAK_FRAC * disc
    normals = pn.expand(dist_p.shape + (3,))
    gap = dist_p - support
    active = valid & (gap < break_gap)

    if grid is not None and puck_axis is None:
        # mesh manifold points: one SphereTriangleDetector contact per
        # candidate triangle, compacted to the first MESH_COMPACT_K_BALL
        # actives in BVH order, then bullet's 4-slot retention and the
        # internal-edge adjustment on the retained slots only
        idx = grid.candidates(ball.pos)                       # (N, K)
        a, ab, ac, tri_n = grid._gather(idx)
        cp = _closest_point_triangle(ball.pos[:, None, :], a, ab, ac)
        delta = ball.pos[:, None, :] - cp
        dist_c = m.norm(delta)
        near = (idx >= 0) & (dist_c < mut.ball_radius + break_gap + 0.25)
        selk, ok = compact_sel(near, MESH_COMPACT_K_BALL)
        idx = torch.where(ok, take_along_axis(idx, selk, -1), -1)
        cp = take_along_axis(cp, selk[..., None], -2)
        delta = take_along_axis(delta, selk[..., None], -2)
        dist_c = take_along_axis(dist_c, selk, -1)
        tri_n = take_along_axis(tri_n, selk[..., None], -2)
        side = torch.sign(torch.sum(delta * tri_n, dim=-1, keepdim=True))
        side = torch.where(side == 0, 1.0, side)
        n_mesh = torch.where(dist_c[..., None] > 1e-6,
                             delta / torch.clamp(dist_c[..., None], min=1e-6),
                             tri_n * side)
        gap_mesh = dist_c - mut.ball_radius
        act_mesh = (idx >= 0) & (gap_mesh < break_gap)
        # localPointA on the sphere is -n * radius, set BEFORE the
        # contact-added callback adjusts the normal
        slot = manifold_insert(-n_mesh * mut.ball_radius, gap_mesh,
                               act_mesh)                      # (N, 4)
        sel = torch.clamp(slot, min=0)
        act_mesh = slot >= 0
        idx4 = torch.where(act_mesh, take_along_axis(idx, sel, -1), 0)
        n_mesh, _ = grid.adjust_internal_edges(
            idx4, take_along_axis(n_mesh, sel[..., None], -2),
            take_along_axis(cp, sel[..., None], -2),
            take_along_axis(gap_mesh, sel, -1))
        gap_mesh = take_along_axis(gap_mesh, sel, -1)
        normals = torch.cat([normals, n_mesh], dim=-2)
        gap = torch.cat([gap, gap_mesh], dim=-1)
        active = torch.cat([active, act_mesh], dim=-1)
        support = torch.cat([support, torch.full_like(gap_mesh,
                                                      mut.ball_radius)],
                            dim=-1)

    num = torch.sum(active, dim=-1)
    touching = num > 0
    count = torch.clamp(num, min=1).to(ball.pos.dtype)

    navg = torch.sum(torch.where(active[..., None], normals, 0.0),
                     dim=-2) / count[..., None]
    # rel_pos magnitude: the contact point on the shape's surface
    dists = support * C.UU_TO_BT
    dist = torch.sum(torch.where(active, dists, 0.0), dim=-1) / count
    r_bt = -navg * dist[..., None]

    ball_inv_mass = 1.0 / mut.ball_mass
    if puck_axis is None:
        # solid-sphere inertia (btSphereShape::calculateLocalInertia)
        inertia = 0.4 * mut.ball_mass * (mut.ball_radius * C.UU_TO_BT) ** 2
        inv_iw = _tables(dev)["eye"] / inertia
    else:
        # solid cylinder about its own axes, rotated to the world
        inv_iw = inv_inertia_world(ball.rot,
                                   _puck_inv_inertia(mut.ball_mass, dev))

    restitution = max(mut.ball_world_restitution, C.WORLD_RESTITUTION)
    friction = min(mut.ball_world_friction, C.WORLD_FRICTION)

    vel_pre_bt = None if vel_pre_uu is None else vel_pre_uu * C.UU_TO_BT
    # 10 iterations like bullet: with a multi-surface (non-unit) average
    # normal the friction direction is not orthogonal to it, so the rows
    # couple
    dv_bt, dw, _ = _contact_impulse_vs_static(
        ball.vel * C.UU_TO_BT, ball.ang_vel, r_bt, navg, ball_inv_mass,
        inv_iw, restitution, friction, vel_pre_bt=vel_pre_bt, iterations=10)

    # the merged contact carries no positional term, but the per-point
    # manifolds still get split-impulse pushout at true overlap
    max_depth = torch.amax(torch.where(active, -gap, 0.0), dim=-1)
    push = navg * torch.clamp(max_depth, min=0.0)[..., None] * C.SOLVER_ERP2

    t = touching[..., None]
    return (torch.where(t, dv_bt * C.BT_TO_UU, 0.0),
            torch.where(t, dw, 0.0), torch.where(t, push, 0.0),
            touching, navg)


@functools.lru_cache(maxsize=None)
def _puck_inv_inertia(mass: float, device) -> torch.Tensor:
    """Diagonal inverse inertia of the snowday puck, a solid cylinder
    about its own axes."""
    r_bt = C.Snowday.PUCK_RADIUS * C.UU_TO_BT
    h_bt = C.Snowday.PUCK_HEIGHT * C.UU_TO_BT
    i_axis = 0.5 * mass * r_bt ** 2
    i_perp = mass * (3 * r_bt ** 2 + h_bt ** 2) / 12.0
    return torch.tensor([1.0 / i_perp, 1.0 / i_perp, 1.0 / i_axis],
                        dtype=torch.float32, device=device)


def resolve_car_world(cars: CarsState, half_extents, hitbox_offset,
                      mut: MutatorConfig, inv_iw, game_mode: str = "soccar",
                      vel_pre_uu=None, ang_vel_pre=None):
    """Car hitbox vs the arena planes (the analytic-plane arena).

    Two contact families, the reference arena's two static body kinds
    (Arena.cpp:1060-1100):

    * true planes (floor, ceiling, side walls; btStaticPlaneShape): ONE
      manifold point per tick, the box's support vertex along -n with the
      >= 0 tie broken toward +half_extent (btBoxShape's btFsels), live
      while its plane distance is below the pair's contact breaking
      threshold 0.02 * (|he| + |child offset|);
    * mesh stand-in planes (back walls, corners, goal box): the centroid of
      the corners inside the triangle's 2 uu margin.

    Pushout fires only on true overlap; restitution reads the pre-force
    velocity.  ``half_extents``/``hitbox_offset`` are static (3,) float32
    arrays.  Returns (dvel_uu (N, C, 3), dang_vel (N, C, 3),
    pos_push_uu (N, C, 3), has_contact (N, C), contact_normal
    (N, C, 3))."""
    dev = cars.pos.device
    box_center = cars.pos + m.rotate(cars.rot, constant(hitbox_offset, dev))

    he = constant(half_extents, dev)
    corners_local = _tables(dev)["corner_signs"] * he            # (8, 3)
    corners = box_center[..., None, :] + m.rotate(
        cars.rot[..., None, :, :], corners_local)               # (N,C,8,3)

    pn, pd = geom.get_planes(game_mode, dev)
    d = torch.sum(corners[..., None, :] * pn, dim=-1) + pd      # (N,C,8,P)
    valid = geom.plane_validity(cars.pos, game_mode)            # (N, C, P)
    true_plane = geom.get_true_plane_mask(game_mode, dev)       # (P,)

    # mesh stand-in planes: the corner centroid inside the 2 uu margin
    # (box-vs-trimesh GJK adds manifold points at margin-surface touch)
    pen = -d + C.MESH_COLLISION_MARGIN
    corner_active = valid[..., None, :] & (pen > 0)

    ncontacts = torch.sum(corner_active, dim=-2)                # (N, C, P)
    mesh_active = (ncontacts > 0) & ~true_plane

    w = corner_active.to(torch.float32)
    centroid = torch.sum(w[..., None] * corners[..., :, None, :], dim=-3) \
        / torch.clamp(ncontacts, min=1)[..., None].to(torch.float32)
    mesh_depth = torch.amax(torch.where(corner_active, pen, 0.0), dim=-2)

    # true planes: a single support-vertex contact
    ldir = -m.inv_rotate(cars.rot[..., None, :, :], pn)          # (N,C,P,3)
    sup_local = torch.where(ldir >= 0.0, he, -he)
    sup = box_center[..., None, :] + m.rotate(cars.rot[..., None, :, :],
                                              sup_local)
    sup_d = m.dot(sup, pn) + pd                                  # (N, C, P)
    brk = breaking_threshold(half_extents, hitbox_offset)
    plane_point_active = valid & true_plane & (sup_d < brk)

    plane_active = mesh_active | plane_point_active
    contact_pt = torch.where(true_plane[:, None], sup, centroid)
    max_depth = torch.where(true_plane, torch.clamp(-sup_d, min=0.0),
                            mesh_depth)

    inv_mass = 1.0 / mut.car_mass
    # each live plane contact resolved on its own (Jacobi over planes)
    n = pn.expand(contact_pt.shape)
    r_bt = (contact_pt - cars.pos[..., None, :]) * C.UU_TO_BT
    vel_pre_bt = (None if vel_pre_uu is None
                  else vel_pre_uu[..., None, :] * C.UU_TO_BT)
    wpre = (None if ang_vel_pre is None
            else ang_vel_pre[..., None, :].expand(contact_pt.shape))
    dv_bt, dw, _ = _contact_impulse_vs_static(
        cars.vel[..., None, :] * C.UU_TO_BT,
        cars.ang_vel[..., None, :].expand(contact_pt.shape), r_bt, n,
        inv_mass, inv_iw[..., None, :, :], mut.car_world_restitution,
        mut.car_world_friction, vel_pre_bt=vel_pre_bt, ang_vel_pre=wpre,
        iterations=10)

    act = plane_active[..., None]
    dvel = torch.sum(torch.where(act, dv_bt, 0.0), dim=-2) * C.BT_TO_UU
    dang = torch.sum(torch.where(act, dw, 0.0), dim=-2)
    push = torch.sum(torch.where(
        act, n * (max_depth * C.SOLVER_ERP2)[..., None], 0.0), dim=-2)

    has_contact = torch.any(plane_active, dim=-1)
    nsum = torch.sum(torch.where(act, n, 0.0), dim=-2)
    contact_normal = torch.where(has_contact[..., None], m.normalize(nsum),
                                 0.0)
    return dvel, dang, push, has_contact, contact_normal


def breaking_threshold(half_extents, hitbox_offset) -> float:
    """The car-world pair's contact breaking threshold, 0.02 * the
    compound's angular motion disc = 0.02 * (|he| + |offset|)
    (btCollisionDispatcher::getNewManifold), in float32 as the JAX
    package computes it."""
    he = np.asarray(half_extents, np.float32)
    off = np.asarray(hitbox_offset, np.float32)
    return _f32(C.CONTACT_BREAK_FRAC * (np.linalg.norm(he)
                                        + np.linalg.norm(off)))


def manifold_insert(local_a, dist, active):
    """btPersistentManifold point retention for one tick.

    The fork DISABLES contact deduplication (btPersistentManifold.cpp
    getCacheEntry returns -1), so every narrowphase contact is inserted;
    once the 4 slots are full, sortCachedPoints picks the slot to replace
    (keep the deepest point, then maximise the area spanned by the
    m_localPointA differences).  Candidates MUST come in bullet's BVH
    traversal order, since insertion order decides retention.

    local_a (..., K, 3): contact point relative to the body; dist (..., K):
    manifold point distances; active (..., K).  Returns slot_cand (..., 4)
    int32: the candidate held by each slot (-1 empty), in slot order
    (bullet's constraint row order)."""
    K = dist.shape[-1]
    batch = dist.shape[:-1]
    dev = dist.device
    arange4 = _tables(dev)["arange4"]

    def _area(p, q):
        c = m.cross(p, q)
        return torch.sum(c * c, dim=-1)

    slot_cand = torch.full(batch + (4,), -1, dtype=torch.int32, device=dev)
    slot_la = torch.zeros(batch + (4, 3), dtype=local_a.dtype, device=dev)
    slot_d = torch.zeros(batch + (4,), dtype=dist.dtype, device=dev)
    slot_occ = torch.zeros(batch + (4,), dtype=torch.bool, device=dev)
    for k in range(K):
        la, d, act = local_a[..., k, :], dist[..., k], active[..., k]
        count = torch.sum(slot_occ, dim=-1)

        # the replacement slot (sortCachedPoints)
        deeper = slot_d < d[..., None]
        has_deeper = torch.any(deeper & slot_occ, dim=-1)
        maxpen = torch.where(has_deeper, torch.argmin(
            torch.where(slot_occ, slot_d, torch.inf), dim=-1), -1)
        c0, c1, c2, c3 = torch.unbind(slot_la, dim=-2)
        res = torch.stack([
            torch.where(maxpen != 0, _area(la - c1, c3 - c2), 0.0),
            torch.where(maxpen != 1, _area(la - c0, c3 - c2), 0.0),
            torch.where(maxpen != 2, _area(la - c0, c3 - c1), 0.0),
            torch.where(maxpen != 3, _area(la - c0, c2 - c1), 0.0),
        ], dim=-1)
        replace_slot = torch.argmax(res, dim=-1)

        slot = torch.where(count >= 4, replace_slot, count)   # else append
        write = act[..., None] & (arange4 == slot[..., None])
        slot_cand = torch.where(write, k, slot_cand)
        slot_la = torch.where(write[..., None], la[..., None, :], slot_la)
        slot_d = torch.where(write, d[..., None], slot_d)
        slot_occ = slot_occ | write
    return slot_cand


def resolve_car_world_mesh(cars: CarsState, half_extents, hitbox_offset,
                           mut: MutatorConfig, inv_iw, grid, dt,
                           game_mode: str = "soccar", vel_pre_uu=None,
                           ang_vel_pre=None):
    """Car hitbox vs the triangle-mesh arena plus the 4
    btStaticPlaneShapes (Arena.cpp:1020-1100) with Bullet's narrowphase:
    one GJK contact per overlapping triangle
    (box_tri.box_triangle_contact), the persistent manifold's cap of 4
    points, one support-vertex contact per static plane.  Every row is
    solved jointly by :func:`pgs_rows_vs_static` in manifold order (the
    mesh manifold first, then the planes).

    Returns (dvel_uu (N, C, 3), dang (N, C, 3), push_uu (N, C, 3), turn
    (N, C, 3), has_contact (N, C), contact_normal (N, C, 3))."""
    dev = cars.pos.device
    he_np = np.asarray(half_extents, np.float32)
    he = constant(he_np, dev)
    box_center = cars.pos + m.rotate(cars.rot, constant(hitbox_offset, dev))

    # btBoxShape's safe margin: min(0.04 bt, 0.1 * the least half extent)
    safe_margin = min(C.MESH_COLLISION_MARGIN, 0.1 * float(np.min(he_np)))
    brk = breaking_threshold(he_np, hitbox_offset)
    he_len = float(np.linalg.norm(he_np))

    # two-stage narrowphase: a conservative prune over the padded cell
    # list, compaction to MESH_COMPACT_K_CAR in BVH order, then the exact
    # box-triangle test on those only
    idx = grid.candidates(box_center)                        # (N, C, K)
    a, ab, ac, tri_n = grid._gather(idx)
    cut = brk + safe_margin + 0.5
    cp0 = _closest_point_triangle(box_center[..., None, :], a, ab, ac)
    d0 = m.norm(box_center[..., None, :] - cp0)
    sphere_ok = d0 - he_len <= cut
    plane_dist = torch.abs(torch.sum((box_center[..., None, :] - a) * tri_n,
                                     dim=-1))
    proj = m.inv_rotate(cars.rot[..., None, :, :], tri_n)
    r_eff = torch.sum(torch.abs(proj) * he, dim=-1)
    plane_ok = plane_dist - r_eff <= cut
    near = (idx >= 0) & sphere_ok & plane_ok
    selk, ok = compact_sel(near, MESH_COMPACT_K_CAR)
    idx = torch.where(ok, take_along_axis(idx, selk, -1), -1)  # (N, C, Kc)
    a, ab, ac, _ = grid._gather(idx)
    n_k, pt_k, dist_k = box_tri.box_triangle_contact(
        box_center[..., None, :], cars.rot[..., None, :, :], he,
        C.MESH_COLLISION_MARGIN, safe_margin, a, a + ab, a + ac)
    act_k = (idx >= 0) & (dist_k < brk)
    # retention uses the un-adjusted normal: localPointA is set before the
    # contact-added callback
    pos_a_k = pt_k + n_k * dist_k[..., None]                 # on the car
    local_a = pos_a_k - cars.pos[..., None, :]
    slot = manifold_insert(local_a, dist_k, act_k)           # (N, C, 4)
    mesh_act = slot >= 0
    sel = torch.clamp(slot, min=0)
    # the internal-edge adjustment (arena contact callback) on the
    # retained slots only: elementwise per contact, so the same result
    idx4 = torch.where(mesh_act, take_along_axis(idx, sel, -1), 0)
    n4 = take_along_axis(n_k, sel[..., None], -2)
    pt4 = take_along_axis(pt_k, sel[..., None], -2)
    mesh_dist = take_along_axis(dist_k, sel, -1)
    mesh_n, _ = grid.adjust_internal_edges(idx4, n4, pt4, mesh_dist)
    # the lever arms use positionWorldOnA (unchanged by the callback)
    mesh_pt = take_along_axis(pos_a_k, sel[..., None], -2)

    # true-plane contacts: a single support vertex per plane
    pn, pd = _true_planes(game_mode, dev)
    ldir = -m.inv_rotate(cars.rot[..., None, :, :], pn)
    sup_local = torch.where(ldir >= 0.0, he, -he)
    sup = box_center[..., None, :] + m.rotate(cars.rot[..., None, :, :],
                                              sup_local)
    sup_d = m.dot(sup, pn) + pd                              # (N, C, T)
    plane_act = sup_d < brk
    plane_n = pn.expand(sup.shape)

    # the rows: the mesh manifold first, then the planes
    n_rows = torch.cat([mesh_n, plane_n], dim=-2)
    pt_rows = torch.cat([mesh_pt, sup], dim=-2)
    dist_rows = torch.cat([mesh_dist, sup_d], dim=-1)
    act_rows = torch.cat([mesh_act, plane_act], dim=-1)

    r_bt = (pt_rows - cars.pos[..., None, :]) * C.UU_TO_BT
    dist_bt = dist_rows * C.UU_TO_BT
    inv_mass = 1.0 / mut.car_mass
    vel_pre_bt = None if vel_pre_uu is None else vel_pre_uu * C.UU_TO_BT

    dv_bt, dw, push_bt, turn, _ = pgs_rows_vs_static(
        cars.vel * C.UU_TO_BT, cars.ang_vel, r_bt, n_rows, act_rows,
        inv_mass, inv_iw, mut.car_world_restitution, mut.car_world_friction,
        dist_bt, dt, vel_pre_bt=vel_pre_bt, ang_vel_pre=ang_vel_pre)

    has_contact = torch.any(act_rows, dim=-1)
    nsum = torch.sum(torch.where(act_rows[..., None], n_rows, 0.0), dim=-2)
    contact_normal = torch.where(has_contact[..., None], m.normalize(nsum),
                                 0.0)
    return (dv_bt * C.BT_TO_UU, dw, push_bt * C.BT_TO_UU, turn, has_contact,
            contact_normal)


def closest_point_on_box(point, box_center, box_rot, half_extents):
    """The closest point on an oriented box to ``point`` (world frame)."""
    local = m.inv_rotate(box_rot, point - box_center)
    clamped = torch.minimum(torch.maximum(local, -half_extents),
                            half_extents)
    return box_center + m.rotate(box_rot, clamped), local, clamped


def resolve_car_ball(cars: CarsState, ball: BallState, tick_count,
                     half_extents, hitbox_offset, mut: MutatorConfig,
                     inv_iw_cars, alive=None, game_mode: str = "soccar",
                     cars_vel_pre=None, ball_vel_pre=None):
    """Car-ball contact: the physical impulse (friction 2.0, restitution 0,
    Arena.cpp:289-291) and the psyonix extra impulse into the ball's
    velocity cache (Arena.cpp:283-334).

    Returns (car dvel (N, C, 3), car dang (N, C, 3), ball dvel (N, 3),
    ball dang (N, 3), ball_cache_dv (N, 3), hit_info_updates dict,
    touched (N, C))."""
    dev = cars.pos.device
    bpos = ball.pos[:, None, :]
    box_center = cars.pos + m.rotate(cars.rot, constant(hitbox_offset, dev))
    # Bullet runs box-vs-sphere through convex-convex GJK: the closest
    # point on the margin-SHRUNK box core against the sphere's centre,
    # margins added back along the core-to-core direction
    he_np = np.asarray(half_extents, np.float32)
    he_core = constant(he_np - np.float32(C.MESH_COLLISION_MARGIN), dev)
    closest, _, _ = closest_point_on_box(bpos.expand(cars.pos.shape),
                                         box_center, cars.rot, he_core)
    delta = bpos - closest
    dist = m.norm(delta)
    # hull gap and the pair breaking threshold 0.02 * min(sphere disc
    # radius + 0.08 bt, compound disc |he + 0.04 bt| + |child offset|)
    gap = dist - C.MESH_COLLISION_MARGIN - mut.ball_radius
    off_np = np.asarray(hitbox_offset, np.float32)
    break_gap = _f32(C.CONTACT_BREAK_FRAC * min(
        np.float32(mut.ball_radius + C.SPHERE_BOUND_EXTRA),
        np.linalg.norm(he_np + np.float32(C.MESH_COLLISION_MARGIN))
        + np.linalg.norm(off_np)))
    touching = gap < break_gap
    if alive is not None:
        # demoed cars have no contact response (Car.cpp:74-77)
        touching = touching & alive
    # the normal from car to ball; with the centre inside the core, the
    # centre-to-centre direction
    n = torch.where((dist > 1e-6)[..., None], m.normalize(delta),
                    m.normalize(bpos - box_center))

    car_inv_mass = 1.0 / mut.car_mass
    ball_inv_mass = 1.0 / mut.ball_mass
    inertia_ball = 0.4 * mut.ball_mass * (mut.ball_radius * C.UU_TO_BT) ** 2
    inv_iw_ball = _tables(dev)["eye"] / inertia_ball

    # manifold points: on the sphere surface (B) and gap-offset from it on
    # the box margin surface (A); the solver's lever arms use these
    pt_ball = bpos - n * mut.ball_radius
    pt_car = pt_ball + n * gap[..., None]
    r_car = (pt_car - cars.pos) * C.UU_TO_BT
    r_ball = (pt_ball - bpos) * C.UU_TO_BT

    v_car = cars.vel * C.UU_TO_BT + m.cross(cars.ang_vel, r_car)
    v_ball = ball.vel[:, None, :] * C.UU_TO_BT + m.cross(
        ball.ang_vel[:, None, :].expand(r_ball.shape), r_ball)
    rel_vel = m.dot(n, v_ball - v_car)  # ball relative to car along n

    ta_car = m.rotate(inv_iw_cars, m.cross(r_car, n))
    ta_ball = m.rotate(inv_iw_ball, m.cross(r_ball, n))
    denom = (car_inv_mass + ball_inv_mass
             + m.dot(n, m.cross(ta_car, r_car))
             + m.dot(n, m.cross(ta_ball, r_ball)))

    # the friction direction: the tangential relative velocity at setup
    rel_t0 = (v_ball - v_car) - n * rel_vel[..., None]
    t_len = m.norm(rel_t0, keepdim=True)
    t_dir = torch.where(t_len > 1e-9, rel_t0 / torch.clamp(t_len, min=1e-9),
                        0.0)
    tt_car = m.rotate(inv_iw_cars, m.cross(r_car, t_dir))
    tt_ball = m.rotate(inv_iw_ball, m.cross(r_ball, t_dir))
    t_denom = (car_inv_mass + ball_inv_mass
               + m.dot(t_dir, m.cross(tt_car, r_car))
               + m.dot(t_dir, m.cross(tt_ball, r_ball)))
    mu = C.CARBALL_COLLISION_FRICTION

    # sequential impulses over the coupled normal and friction rows
    # (bullet runs 10), restitution 0, |j_t| <= mu * j_n
    zero3 = torch.zeros_like(v_ball)
    zeroC = torch.zeros_like(rel_vel)
    dvb, dwb, dvc, dwc, jn_acc, jt_acc = (zero3, zero3, zero3, zero3, zeroC,
                                          zeroC)
    for _ in range(10):
        rv = m.dot(n, (v_ball + dvb + m.cross(dwb, r_ball))
                   - (v_car + dvc + m.cross(dwc, r_car)))
        djn = -rv / torch.clamp(denom, min=1e-12)
        djn = torch.clamp(jn_acc + djn, min=0.0) - jn_acc
        djn = torch.where(touching, djn, 0.0)
        jn_acc = jn_acc + djn
        dimp = n * djn[..., None]
        dvb = dvb + dimp * ball_inv_mass
        dwb = dwb + m.rotate(inv_iw_ball, m.cross(r_ball, dimp))
        dvc = dvc - dimp * car_inv_mass
        dwc = dwc + m.rotate(inv_iw_cars, m.cross(r_car, -dimp))

        rt = m.dot(t_dir, (v_ball + dvb + m.cross(dwb, r_ball))
                   - (v_car + dvc + m.cross(dwc, r_car)))
        djt = -rt / torch.clamp(t_denom, min=1e-12)
        lim = mu * jn_acc
        djt = torch.minimum(torch.maximum(jt_acc + djt, -lim), lim) - jt_acc
        djt = torch.where(touching, djt, 0.0)
        jt_acc = jt_acc + djt
        dimp = t_dir * djt[..., None]
        dvb = dvb + dimp * ball_inv_mass
        dwb = dwb + m.rotate(inv_iw_ball, m.cross(r_ball, dimp))
        dvc = dvc - dimp * car_inv_mass
        dwc = dwc + m.rotate(inv_iw_cars, m.cross(r_car, -dimp))

    imp_total = n * jn_acc[..., None] + t_dir * jt_acc[..., None]

    tmask = touching[..., None]
    ball_dv = torch.sum(torch.where(tmask, imp_total, 0.0), dim=-2) \
        * ball_inv_mass * C.BT_TO_UU
    ball_dw = m.rotate(inv_iw_ball, torch.sum(
        torch.where(tmask, m.cross(r_ball, imp_total), 0.0), dim=-2))
    car_dv = torch.where(tmask, -imp_total, 0.0) * car_inv_mass * C.BT_TO_UU
    car_dw = m.rotate(inv_iw_cars, torch.where(
        tmask, m.cross(r_car, -imp_total), 0.0))

    # --- the psyonix extra impulse (Arena.cpp:304-331)
    tick = tick_count[:, None]
    can_extra = touching & ((tick > cars.ball_hit_extra_impulse_tick + 1)
                            | (cars.ball_hit_extra_impulse_tick > tick))
    # GetState() at callback time reads the pre-force velocities (the
    # callback fires during the narrowphase, before the solver integrates
    # forces)
    cv = cars.vel if cars_vel_pre is None else cars_vel_pre
    bv = ball.vel if ball_vel_pre is None else ball_vel_pre
    rel_pos = bpos - cars.pos
    rel_v = bv[:, None, :] - cv
    rel_speed = torch.clamp(m.norm(rel_v),
                            max=C.BALL_CAR_EXTRA_IMPULSE_MAXDELTAVEL_UU)
    if game_mode == "hoops":
        # hoops boosts the z component for grounded upright cars
        # (Arena.cpp:318-322)
        extra_z = cars.is_on_ground & (
            cars.up[..., 2]
            > C.BALL_CAR_EXTRA_IMPULSE_Z_SCALE_HOOPS_NORMAL_Z_THRESH)
        z_scale = torch.where(extra_z,
                              C.BALL_CAR_EXTRA_IMPULSE_Z_SCALE_HOOPS_GROUND,
                              C.BALL_CAR_EXTRA_IMPULSE_Z_SCALE)
    else:
        z_scale = C.BALL_CAR_EXTRA_IMPULSE_Z_SCALE
    hit_dir = m.normalize(torch.cat([rel_pos[..., :2],
                                     (rel_pos[..., 2] * z_scale)[..., None]],
                                    dim=-1))
    fwd = cars.forward
    fwd_adj = fwd * (m.dot(hit_dir, fwd)
                     * (1.0 - C.BALL_CAR_EXTRA_IMPULSE_FORWARD_SCALE))[
                         ..., None]
    hit_dir = m.normalize(hit_dir - fwd_adj)
    factor = m.curve(C.BALL_CAR_EXTRA_IMPULSE_FACTOR_CURVE, rel_speed)
    added_vel = (hit_dir * (rel_speed * factor)[..., None]
                 * mut.ball_hit_extra_force_scale)
    apply_extra = can_extra & (rel_speed > 0)
    ball_cache_dv = torch.sum(torch.where(apply_extra[..., None], added_vel,
                                          0.0), dim=-2)

    # BallHitInfo (Arena.cpp:293-327)
    hit_updates = dict(
        ball_hit_valid=touching | cars.ball_hit_valid,
        ball_hit_rel_pos=torch.where(tmask, pt_ball - bpos,
                                     cars.ball_hit_rel_pos),
        ball_hit_tick=torch.where(touching, tick, cars.ball_hit_tick),
        ball_hit_extra_impulse_tick=torch.where(
            can_extra, tick, cars.ball_hit_extra_impulse_tick),
        ball_hit_ball_pos=torch.where(tmask, bpos, cars.ball_hit_ball_pos),
        ball_hit_extra_vel=torch.where(
            apply_extra[..., None], added_vel,
            torch.where(tmask, 0.0, cars.ball_hit_extra_vel)),
    )
    return (car_dv, car_dw, ball_dv, ball_dw, ball_cache_dv, hit_updates,
            touching)


@functools.lru_cache(maxsize=None)
def _pairs(num_cars: int, device):
    """The car pairs i < j in numpy's triu order: (ii, jj) index tensors on
    ``device`` and as Python lists."""
    ii, jj = np.triu_indices(num_cars, k=1)
    return (torch.as_tensor(ii, device=device),
            torch.as_tensor(jj, device=device), ii.tolist(), jj.tolist())


def _scatter_pairs(a0, a1, ii, jj, num_cars):
    """Per-car sums of per-pair values: ``zeros.at[ii].add(a0).at[jj]
    .add(a1)`` with the additions in that sequential order.  a0/a1
    (N, P, ...) -> (N, C, ...)."""
    cols = []
    for c in range(num_cars):
        acc = None
        for src, idx in ((a0, ii), (a1, jj)):
            for p, car in enumerate(idx):
                if car == c:
                    acc = src[:, p] if acc is None else acc + src[:, p]
        cols.append(torch.zeros_like(a0[:, 0]) if acc is None else acc)
    return torch.stack(cols, dim=1)


def car_car_interactions(cars: CarsState, teams, half_extents, hitbox_offset,
                         mut: MutatorConfig, inv_iw, vel_pre=None,
                         dt: float = 1.0 / 120.0):
    """All-pairs car-car contact and the bump/demo logic
    (Arena.cpp:336-418).

    The physical contact follows the reference's path: Bullet dispatches
    box-box child pairs to the dBoxBox face-clipping detector
    (physics/box_box.py), an up-to-4-point one-tick manifold solved by the
    sequential-impulse solver with per-point friction and split-impulse
    pushout.  Pairs are solved independently (the reference solves every
    manifold jointly; this differs only in pileups of 3 or more cars).

    ``teams`` is (C,) on the cars' device.  Returns (dvel (N, C, 3), dang
    (N, C, 3), push (N, C, 3), turn (N, C, 3), cache_dv (N, C, 3),
    got_demoed (N, C), bumped (N, C, C) bool [i bumped j], is_demo
    (N, C, C) bool [i demoed j], contact_updates dict)."""
    dev = cars.pos.device
    num_cars = cars.pos.shape[-2]
    if vel_pre is None:
        vel_pre = cars.vel
    ii, jj, ii_l, jj_l = _pairs(num_cars, dev)

    he_eff = constant(formulas.box_effective_half_extents_bt(
        np.asarray(half_extents, np.float64) * 2.0), dev)
    box_center_bt = (cars.pos + m.rotate(cars.rot, constant(hitbox_offset, dev))) \
        * C.UU_TO_BT
    pos_bt = cars.pos * C.UU_TO_BT
    inv_mass = 1.0 / mut.car_mass

    def pi(x):
        return x[:, ii]

    def pj(x):
        return x[:, jj]

    mf = box_box.box_box_manifold(pi(box_center_bt), pi(cars.rot), he_eff,
                                  pj(box_center_bt), pj(cars.rot), he_eff)
    pair_alive = ~pi(cars.is_demoed) & ~pj(cars.is_demoed)   # (N, P)
    act = mf["active"] & pair_alive[..., None]               # (N, P, 4)

    n_on_b = -mf["normal"]                                   # +imp on i
    posB = mf["points"]                                      # (N,P,4,3) bt
    posA = posB + mf["normal"][..., None, :] * mf["depth"][..., None]
    r0 = posA - pi(pos_bt)[..., None, :]
    r1 = posB - pj(pos_bt)[..., None, :]

    dv0, dw0, dv1, dw1, push0, push1, turn0, turn1, _ = pgs_rows_two_body(
        pi(cars.vel) * C.UU_TO_BT, pi(cars.ang_vel),
        pj(cars.vel) * C.UU_TO_BT, pj(cars.ang_vel),
        r0, r1, n_on_b[..., None, :].expand(posB.shape), act,
        inv_mass, inv_mass, pi(inv_iw), pj(inv_iw),
        C.CARCAR_COLLISION_RESTITUTION, C.CARCAR_COLLISION_FRICTION,
        -mf["depth"], dt,
        v0_pre=pi(vel_pre) * C.UU_TO_BT, v1_pre=pj(vel_pre) * C.UU_TO_BT)

    def scatter(a0, a1):
        return _scatter_pairs(a0, a1, ii_l, jj_l, num_cars)

    dvel = scatter(dv0, dv1) * C.BT_TO_UU
    dang = scatter(dw0, dw1)
    push = scatter(push0, push1) * C.BT_TO_UU
    turn = scatter(turn0, turn1)

    # (N, C, C) views for the bump/demo logic below
    N = cars.pos.shape[0]
    overlap = torch.zeros(N, num_cars, num_cars, dtype=torch.bool,
                          device=dev)
    overlap[:, ii, jj] = mf["overlap"] & pair_alive
    overlap = overlap | overlap.transpose(1, 2)

    # the per-point local contact points on each car (bullet's
    # m_localPointA/B, mapped to the parent body frame)
    lp_i = m.inv_rotate(pi(cars.rot)[..., None, :, :],
                        posA * C.BT_TO_UU - pi(cars.pos)[..., None, :])
    lp_j = m.inv_rotate(pj(cars.rot)[..., None, :, :],
                        posB * C.BT_TO_UU - pj(cars.pos)[..., None, :])
    hwb_i = torch.any(act & (lp_i[..., 0] > C.BUMP_MIN_FORWARD_DIST), -1)
    hwb_j = torch.any(act & (lp_j[..., 0] > C.BUMP_MIN_FORWARD_DIST), -1)
    hit_with_bumper = torch.zeros(N, num_cars, num_cars, dtype=torch.bool,
                                  device=dev)
    hit_with_bumper[:, ii, jj] = hwb_i
    hit_with_bumper[:, jj, ii] = hwb_j

    # --- bump / demo logic, both directions (i bumps j); Car::GetState()
    # at callback time reads the pre-force velocities
    state_i_vel = vel_pre[:, :, None, :]
    state_j_vel = vel_pre[:, None, :, :]
    delta_pos = cars.pos[:, None, :, :] - cars.pos[:, :, None, :]  # i -> j
    going_towards = m.dot(state_i_vel, delta_pos) > 0

    vel_dir = m.normalize(state_i_vel)
    dir_to_other = m.normalize(delta_pos)
    speed_towards = m.dot(state_i_vel, dir_to_other)
    other_away_speed = m.dot(state_j_vel, vel_dir)

    ids = torch.arange(1, num_cars + 1, device=dev, dtype=torch.int32)
    in_cooldown = (cars.car_contact_other_id[..., None] == ids) & (
        cars.car_contact_cooldown[..., None] > 0)

    bump = (overlap & going_towards & ~in_cooldown
            & (speed_towards > other_away_speed) & hit_with_bumper)

    if mut.demo_mode == "ON_CONTACT":
        is_demo = bump
    elif mut.demo_mode == "DISABLED":
        is_demo = torch.zeros_like(bump)
    else:
        is_demo = bump & cars.is_supersonic[..., None]
    if not mut.enable_team_demos:
        is_demo = is_demo & (teams[:, None] != teams[None, :])

    plain_bump = bump & ~is_demo
    ground_hit = cars.is_on_ground[:, None, :]
    base_scale = torch.where(
        ground_hit, m.curve(C.BUMP_VEL_AMOUNT_GROUND_CURVE, speed_towards),
        m.curve(C.BUMP_VEL_AMOUNT_AIR_CURVE, speed_towards))
    hit_up_dir = torch.where(ground_hit[..., None], cars.up[:, None, :, :],
                             _tables(dev)["up"])
    bump_impulse = (vel_dir * base_scale[..., None]
                    + hit_up_dir * m.curve(C.BUMP_UPWARD_VEL_AMOUNT_CURVE,
                                           speed_towards)[..., None]
                    * mut.bump_force_scale)
    # the sum over bumpers i for each bumped j
    cache_dv = torch.sum(torch.where(plain_bump[..., None], bump_impulse,
                                     0.0), dim=1)

    got_demoed = torch.any(is_demo, dim=1)

    # contact cooldown bookkeeping for the bumper (car i)
    bumped_any = torch.any(bump, dim=2)
    bumped_id = torch.amax(torch.where(bump, ids, 0), dim=2)
    contact_updates = dict(
        car_contact_other_id=torch.where(
            bumped_any, bumped_id, cars.car_contact_other_id).to(torch.int32),
        car_contact_cooldown=torch.where(bumped_any, mut.bump_cooldown_time,
                                         cars.car_contact_cooldown),
    )
    return (dvel, dang, push, turn, cache_dv, got_demoed, bump, is_demo,
            contact_updates)
