"""The physics tick in component form: the plain PyTorch version of the
``csrc/arena_step.cu`` kernel.

Same update order and formulas as the reference (Arena::Step,
Arena.cpp:716-812; Car.cpp:58-193; btVehicleRL.cpp).  Layout (see
ops/pack.py): per-car fields ``(C, E)``, per-env fields ``(E,)``, vectors
and matrices as component tuples.  Wheels, planes, pads and car pairs are
static Python loops.

Two arenas: the analytic-plane arena (``use_mesh=False``: 15 planes, the
goal box and the mesh's surfaces stood in for by half-spaces), and full
fidelity (``use_mesh=True``): the closed-form facet arena of
``physics/facet_arena.py`` plus the 4 true static planes, with 4-slot
contact manifolds solved jointly by a bullet-order PGS.  With
``dynamic_wheel_rays`` the suspension rays also hit the ball and the other
cars, and the wheel friction uses the hit body's velocity and mass.

Game modes on the soccar geometry (``game_mode``): heatseeker steers the
ball toward a goal, retargets it on touches and deep back-wall hits
(``_hs_steer``, ``_hs_on_hit``, ``_hs_wall_bounce``); snowday's puck
collides the analytic planes with the exact support of its cylinder, in
either arena, and sticks to the ground (``_resolve_ball_world_snowday``).
Hoops needs its own arena: ``make_consts`` raises for it.

The only randomness (demo respawn location) comes in from the caller as
one pre-drawn index per car per env step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt.ops import cvec as cv
from perfbench.reference.rlt.ops import pack
from perfbench.reference.rlt.ops.cvec import (vadd, vcross, vdot, vnorm,
                                                   vnormalize, vscale, vsub,
                                                   vwhere, vzero)
from perfbench.reference.rlt.physics import arena_geom as geom
from perfbench.reference.rlt.physics import facet_arena as fa
from perfbench.reference.rlt.physics import formulas

THROTTLE, STEER, PITCH, YAW, ROLL, JUMP, BOOST, HANDBRAKE = range(8)

# How far a step's output may stray from the reference, per PhysicsState
# field as (atol, rtol): tests/test_ctick.py _assert_close field by field;
# the fields it does not name are held to the tolerance of their kind
# (positions 0.1 uu, speeds 0.2 uu/s, times and unit quantities 1e-4, wheel
# forces rtol 1e-4).  Integer and boolean fields must match exactly.
TOLERANCES = {
    "arena.cars.pos": (0.1, 1e-4), "arena.cars.vel": (0.2, 1e-4),
    "arena.cars.ang_vel": (0.02, 1e-4), "arena.cars.rot": (1e-4, 0),
    "arena.cars.boost": (1e-4, 0), "arena.cars.jump_time": (1e-6, 0),
    "arena.cars.handbrake_val": (1e-6, 0),
    "arena.ball.pos": (0.1, 1e-4), "arena.ball.vel": (0.2, 1e-4),
    "arena.ball.ang_vel": (0.02, 1e-4), "arena.pads.cooldown": (1e-5, 0),
    "wheels.steer_angle": (1e-5, 0), "wheels.lat_friction": (1e-4, 0),
    "arena.cars.ball_hit_rel_pos": (0.1, 1e-4),
    "arena.cars.ball_hit_ball_pos": (0.1, 1e-4),
    "arena.cars.ball_hit_extra_vel": (0.2, 1e-4),
    "arena.ball.rot": (1e-4, 0),
    "wheels.engine_force": (1e-3, 1e-4), "wheels.brake": (1e-3, 1e-4),
    # heatseeker (tests/test_ctick.py:334-500): the hit state exact
    "arena.ball.hs_y_target_dir": (0.0, 0),
    "arena.ball.hs_target_speed": (1e-4, 0),
    "arena.ball.hs_time_since_hit": (1e-6, 0),
}
DEFAULT_TOLERANCE = (1e-4, 1e-4)


@dataclasses.dataclass(frozen=True)
class TickConsts:
    """Static per-arena constants as Python floats/tuples."""
    num_cars: int
    teams: tuple            # per-slot team id (0/1)
    dt: float
    mut: object             # MutatorConfig
    half_extents: tuple     # (3,)
    hitbox_offset: tuple    # (3,)
    inv_i_local: tuple      # (3,) diagonal inverse inertia (BT units)
    he_eff_bt: tuple        # (3,) margin-adjusted half extents (BT)
    wheel_offsets: tuple    # (4, 3)
    wheel_radii: tuple      # (4,)
    sus_rest: tuple         # (4,)
    sus_force_scale: tuple  # (4,)
    planes: tuple           # ((nx, ny, nz, d), ...)
    corners_local: tuple    # (8, 3) hitbox corners incl. offset
    pad_locs: tuple         # (34, 3)
    pad_is_big: tuple       # (34,)
    respawn_table: tuple    # (K, 3): x, y, yaw
    use_mesh: bool = False          # the facet arena + 4 true planes
    dynamic_rays: bool = False      # wheel rays hit the ball and cars
    facets: object = None           # facet_arena.FacetTables when use_mesh
    game_mode: str = "soccar"       # soccar | heatseeker | snowday


GAME_MODES = ("soccar", "heatseeker", "snowday")


def check_supported(params) -> None:
    """Raise for the configurations this port does not run yet."""
    mode = getattr(params, "game_mode", "soccar")
    if mode not in GAME_MODES:
        raise NotImplementedError(
            f"game_mode={mode!r}: the kernel runs {GAME_MODES}; hoops needs "
            "the portable physics path, not ported yet")


def make_consts(params, teams) -> TickConsts:
    """params: physics.step.ArenaParams; teams: per-slot ints."""
    check_supported(params)
    cfg = params.car_config
    mut = params.mutators
    size = np.asarray(cfg.hitbox_size, np.float64)
    inv_i = formulas.box_inv_inertia_diag_bt(mut.car_mass, size)
    he = size / 2.0
    off = np.asarray(cfg.hitbox_offset, np.float64)
    corners = [(off[0] + sx * he[0], off[1] + sy * he[1], off[2] + sz * he[2])
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    return TickConsts(
        num_cars=params.num_cars,
        teams=tuple(int(t) for t in np.asarray(teams)),
        dt=float(params.dt),
        mut=mut,
        half_extents=tuple(float(v) for v in he),
        hitbox_offset=tuple(float(v) for v in off),
        inv_i_local=tuple(float(v) for v in inv_i),
        he_eff_bt=tuple(float(v) for v in
                        formulas.box_effective_half_extents_bt(size)),
        wheel_offsets=tuple(tuple(float(x) for x in r)
                            for r in cfg.wheel_offsets()),
        wheel_radii=tuple(float(r) for r in cfg.wheel_radii()),
        sus_rest=tuple(float(r) for r in cfg.sus_rest_lengths()),
        sus_force_scale=tuple(float(r) for r in cfg.sus_force_scales()),
        planes=tuple(tuple(float(x) for x in r)
                     for r in np.asarray(geom._PLANES, np.float64)),
        corners_local=tuple(corners),
        pad_locs=tuple(tuple(float(x) for x in r)
                       for r in np.asarray(C.BOOST_PAD_LOCS_SOCCAR)),
        pad_is_big=tuple(bool(b) for b in C.BOOST_PAD_IS_BIG),
        respawn_table=tuple(tuple(float(x) for x in r) for r in
                            np.asarray(C.CAR_RESPAWN_LOCATIONS_SOCCAR)),
        use_mesh=bool(params.use_mesh),
        dynamic_rays=bool(params.dynamic_wheel_rays),
        facets=fa.tables() if params.use_mesh else None,
        game_mode=str(params.game_mode),
    )


def world_planes(k: TickConsts) -> tuple:
    """Plane indices in the world: in mesh mode only the 4 true static
    planes (Arena.cpp:1060-1100); the facet arena covers the rest."""
    return geom.TRUE_PLANES if k.use_mesh else tuple(range(len(k.planes)))


def plane_validity(pos):
    """Per-plane validity (list of 15 bool tensors or True)."""
    x, y, z = pos
    in_goal_xz = (torch.abs(x) < C.GOAL_HALF_WIDTH) & (z < C.GOAL_HEIGHT)
    behind = torch.abs(y) > C.ARENA_EXTENT_Y
    valid = [True] * geom.NUM_PLANES
    valid[geom.WALL_YN] = ~(in_goal_xz & (y < 0))
    valid[geom.WALL_YP] = ~(in_goal_xz & (y > 0))
    valid[geom.GOAL_XN] = behind
    valid[geom.GOAL_XP] = behind
    valid[geom.GOAL_CEIL] = behind
    valid[geom.NET_YN] = y < 0
    valid[geom.NET_YP] = y > 0
    return valid


def _and_valid(valid, cond):
    return cond if valid is True else valid & cond


def _plane_dist(plane, pos):
    nx, ny, nz, d = plane
    return nx * pos[0] + ny * pos[1] + nz * pos[2] + d


def _raycast(k: TickConsts, start, direction, max_len):
    """Nearest world-plane hit along ``direction``: (hit, dist, normal)."""
    valid = plane_validity(start)
    big = torch.full_like(start[0], 1e30)
    t_min = big
    nx = torch.zeros_like(start[0])
    ny = torch.zeros_like(start[0])
    nz = torch.zeros_like(start[0])
    for p in world_planes(k):
        plane = k.planes[p]
        pn = plane[:3]
        dist_p = _plane_dist(plane, start)
        denom = -(direction[0] * pn[0] + direction[1] * pn[1]
                  + direction[2] * pn[2])
        ok = denom > 1e-6
        t = torch.where(ok, dist_p / torch.clamp(denom, min=1e-6), big)
        t = torch.where(_and_valid(valid[p], t >= 0), t, big)
        closer = t < t_min
        nx = torch.where(closer, pn[0], nx)
        ny = torch.where(closer, pn[1], ny)
        nz = torch.where(closer, pn[2], nz)
        t_min = torch.minimum(t_min, t)
    hit = t_min <= max_len
    dist = torch.where(hit, t_min, max_len)
    return hit, dist, (nx, ny, nz)


def _restitution_rhs(rel_vel, combined_restitution):
    rest = combined_restitution * -rel_vel
    rest = torch.where(torch.abs(rel_vel) < 0.2, 0.0, rest)
    return torch.clamp(rest, min=0.0)


def _contact_vs_static(vel_bt, ang_vel, r_bt, n, active, inv_mass, inv_iw,
                       restitution_coeff, friction_coeff, vel_pre_bt,
                       ang_vel_pre=None, iterations: int = 1):
    """One body against static geometry where ``active``: ``iterations``
    passes of the sequential normal + friction accumulator pair.
    Restitution reads the pre-force velocities.  Returns (dv Vec (bt), dw
    Vec), zero where not ``active``."""
    vel_at = vadd(vel_bt, vcross(ang_vel, r_bt))
    torque_axis = vcross(r_bt, n)
    ang_comp = cv.matvec(inv_iw, torque_axis)
    denom = torch.clamp(inv_mass + vdot(n, vcross(ang_comp, r_bt)),
                        min=1e-12)
    wpre = ang_vel if ang_vel_pre is None else ang_vel_pre
    rel_vel_rest = vdot(n, vadd(vel_pre_bt, vcross(wpre, r_bt)))
    rest = _restitution_rhs(rel_vel_rest, restitution_coeff)

    tang = vsub(vel_at, vscale(n, vdot(n, vel_at)))
    t_len = vnorm(tang)
    t_dir = vwhere(t_len > 1e-9,
                   vscale(tang, 1.0 / torch.clamp(t_len, min=1e-9)),
                   vzero(t_len))
    t_ang = cv.matvec(inv_iw, vcross(r_bt, t_dir))
    t_denom = torch.clamp(inv_mass + vdot(t_dir, vcross(t_ang, r_bt)),
                          min=1e-12)

    dv = vzero(rel_vel_rest)
    dw = vzero(rel_vel_rest)
    j_n = torch.zeros_like(rel_vel_rest)
    j_t = torch.zeros_like(rel_vel_rest)
    for _ in range(iterations):
        v_at = vadd(vadd(vel_bt, dv), vcross(vadd(ang_vel, dw), r_bt))
        dj = (rest - vdot(n, v_at)) / denom
        new_acc = torch.clamp(j_n + dj, min=0.0)
        imp = vscale(n, new_acc - j_n)
        dv = vadd(dv, vscale(imp, inv_mass))
        dw = vadd(dw, cv.matvec(inv_iw, vcross(r_bt, imp)))
        j_n = new_acc

        v_at = vadd(vadd(vel_bt, dv), vcross(vadd(ang_vel, dw), r_bt))
        djt = -vdot(t_dir, v_at) / t_denom
        lim = friction_coeff * j_n
        new_t = torch.clamp(j_t + djt, -lim, lim)
        imp_t = vscale(t_dir, new_t - j_t)
        dv = vadd(dv, vscale(imp_t, inv_mass))
        dw = vadd(dw, cv.matvec(inv_iw, vcross(r_bt, imp_t)))
        j_t = new_t
    z = vzero(j_n)
    return vwhere(active, dv, z), vwhere(active, dw, z)


# ---------------------------------------------------------------------------
# Suspension raycasts + friction (btVehicleRL)

def _ray_sphere(o, d, max_len, center, radius):
    """Ray vs sphere: (hit, t), t = max_len where no hit."""
    oc = vsub(o, center)
    b = vdot(oc, d)
    c2 = vdot(oc, oc) - radius * radius
    disc = b * b - c2
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0.0) & (c2 > 0.0) & (t >= 0.0) & (t <= max_len)
    return hit, torch.where(hit, t, max_len)


def _ray_obb(o, d, max_len, box_center, box_rot, he):
    """Ray vs oriented box (slab method): (hit, t, entry normal Vec)."""
    lo = cv.mat_t_vec(box_rot, vsub(o, box_center))
    ld = cv.mat_t_vec(box_rot, d)
    tmin = torch.full_like(o[0], -float("inf"))
    tmax = torch.full_like(o[0], float("inf"))
    entry_ax = torch.zeros_like(o[0], dtype=torch.int32)
    sign = torch.zeros_like(o[0])
    inside_all = torch.ones_like(o[0], dtype=torch.bool)
    for ax in range(3):
        safe = torch.where(torch.abs(ld[ax]) > 1e-9, ld[ax], 1e-9)
        t1 = (-he[ax] - lo[ax]) / safe
        t2 = (he[ax] - lo[ax]) / safe
        tmin_ax = torch.minimum(t1, t2)
        tmax_ax = torch.maximum(t1, t2)
        inside = (torch.abs(lo[ax]) <= he[ax]) | (torch.abs(ld[ax]) > 1e-9)
        inside_all = inside_all & inside
        better = tmin_ax > tmin
        entry_ax = torch.where(better, ax, entry_ax).to(torch.int32)
        sign = torch.where(better, -torch.sign(ld[ax]), sign)
        tmin = torch.maximum(tmin, tmin_ax)
        tmax = torch.minimum(tmax, torch.where(inside, tmax_ax, float("inf")))
    hit = ((tmax >= tmin) & (tmax >= 0.0) & (tmin >= 0.0)
           & (tmin <= max_len) & inside_all)
    n_local = tuple(torch.where(entry_ax == ax, sign, 0.0) for ax in range(3))
    return hit, torch.where(hit, tmin, max_len), cv.matvec(box_rot, n_local)


def _box_centers(k: TickConsts, st):
    return vadd(st['pos'], cv.matvec(
        st['rot'], cv.vconst(k.hitbox_offset, st['pos'][0])))


def _wheel_raycasts(k: TickConsts, st, inv_iw):
    """Per-wheel raycast data: dict of lists (len 4).  ``ground_idx`` is -1
    for the world (or no hit), -2 for the ball, j >= 0 for car j;
    ``in_world`` is a hit on static geometry.

    In mesh mode the rays also hit the facet arena; with dynamic rays the
    ball and the other live cars' hitboxes, like the reference's
    suspension-grid dynamic-object update (Arena.cpp:733-750,
    btVehicleRL.cpp:149-151)."""
    mut, dt = k.mut, k.dt
    Cn = k.num_cars
    up = cv.up(st['rot'])
    wheel_dir = cv.vneg(up)
    sus_sub_uu = C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU
    travel = C.BTVehicle.MAX_SUSPENSION_TRAVEL
    alive = ~st['is_demoed']
    if k.dynamic_rays:
        box_center = _box_centers(k, st)
    out = dict(hit=[], in_world=[], cp=[], n=[], susp_len=[],
               susp_rel_vel=[], clipped_inv=[], extra_push=[], hard=[],
               ground_idx=[])
    for w in range(4):
        rest_len = k.sus_rest[w]
        radius = k.wheel_radii[w]
        hard = vadd(st['pos'], cv.matvec(
            st['rot'], cv.vconst(k.wheel_offsets[w], st['pos'][0])))
        ray_len = rest_len + travel + radius - sus_sub_uu
        hit, dist, n = _raycast(k, hard, wheel_dir, ray_len)
        if k.use_mesh:
            fdist, fnx, fny, fnz, fhit = fa.raycasts(
                hard[0], hard[1], hard[2], wheel_dir[0], wheel_dir[1],
                wheel_dir[2], ray_len, tab=k.facets)
            closer = fhit & (fdist < dist)
            hit = hit | fhit
            dist = torch.where(closer, fdist, dist)
            n = vwhere(closer, (fnx, fny, fnz), n)
        ground_idx = torch.full_like(hit, -1, dtype=torch.int32)
        if k.dynamic_rays:
            bhit, bt = _ray_sphere(hard, wheel_dir, ray_len,
                                   cv.vbroadcast(st['ball_pos'],
                                                 hard[0].shape),
                                   mut.ball_radius)
            closer = bhit & (bt < dist)
            bn = vnormalize(vsub(vadd(hard, vscale(wheel_dir, bt)),
                                 st['ball_pos']))
            hit = hit | closer
            dist = torch.where(closer, bt, dist)
            n = vwhere(closer, bn, n)
            ground_idx = torch.where(closer, -2, ground_idx)
            for j in range(Cn):
                ohit, ot, on = _ray_obb(
                    hard, wheel_dir, ray_len,
                    cv.vbroadcast(_vslice(box_center, j), hard[0].shape),
                    _mslice(st['rot'], j), k.half_extents)
                # slot i's rays never hit car i
                not_self = torch.stack([torch.full_like(hit[0], i != j)
                                        for i in range(Cn)], 0)
                closer = ohit & not_self & alive[j] & (ot < dist)
                hit = hit | closer
                dist = torch.where(closer, ot, dist)
                n = vwhere(closer, on, n)
                ground_idx = torch.where(closer, j, ground_idx)
        ground_idx = ground_idx.to(torch.int32)
        in_world = hit & (ground_idx == -1)
        cp = vadd(hard, vscale(wheel_dir, dist))
        trace_len = vdot(vsub(hard, cp), up)
        susp_len = torch.clamp(trace_len - radius, rest_len - travel,
                               rest_len + travel)
        susp_len = torch.where(hit, susp_len, rest_len + travel)

        rel = vscale(vsub(cp, st['pos']), C.UU_TO_BT)
        vel_at = vadd(vscale(st['vel'], C.UU_TO_BT),
                      vcross(st['ang_vel'], rel))
        proj_vel = vdot(n, vel_at)
        denom = vdot(n, up)
        good = denom > 0.1
        inv = torch.where(good, 1.0 / torch.clamp(denom, min=0.1), 10.0)
        susp_rel_vel = torch.where(hit & good, proj_vel * inv, 0.0)
        clipped_inv = torch.where(hit, torch.where(good, inv, 10.0), 1.0)

        push_thresh = rest_len + radius - sus_sub_uu
        delta = (trace_len - push_thresh) * C.UU_TO_BT
        # extra pushback fires only against static geometry
        # (btVehicleRL.cpp:184); resolveSingleCollision has zero
        # restitution (btContactConstraint.cpp:59,82)
        needs = in_world & (trace_len < push_thresh)
        pos_err = 0.2 * -delta / dt
        vel_err = -proj_vel
        r_cross_n = vcross(rel, n)
        ang_term = vdot(vcross(cv.matvec(inv_iw, r_cross_n), rel), n)
        denom0 = (1.0 / mut.car_mass) + ang_term
        imp = torch.clamp((pos_err + vel_err) / torch.clamp(denom0, min=1e-9),
                          min=0.0)
        extra_push = torch.where(needs, imp / 4.0, 0.0)

        out['hit'].append(hit)
        out['in_world'].append(in_world)
        out['ground_idx'].append(ground_idx)
        out['cp'].append(cp)
        out['n'].append(vwhere(hit, n, up))
        out['susp_len'].append(susp_len)
        out['susp_rel_vel'].append(susp_rel_vel)
        out['clipped_inv'].append(clipped_inv)
        out['extra_push'].append(extra_push)
        out['hard'].append(hard)
    return out


def _ground_body(k: TickConsts, st, gi):
    """The body a wheel ray hit, selected per lane from ``gi`` (ground_idx):
    (velocity, angular velocity, position, inverse mass), zero for the
    world."""
    mut = k.mut
    is_ball = gi == -2
    is_car = gi >= 0
    zf = vzero(gi.to(st['pos'][0].dtype))
    g_vel = vwhere(is_ball, cv.vbroadcast(st['ball_vel'], gi.shape), zf)
    g_ang = vwhere(is_ball, cv.vbroadcast(st['ball_ang_vel'], gi.shape), zf)
    g_pos = vwhere(is_ball, cv.vbroadcast(st['ball_pos'], gi.shape), zf)
    g_inv_mass = torch.where(is_ball, 1.0 / mut.ball_mass,
                             torch.where(is_car, 1.0 / mut.car_mass, 0.0))
    for j in range(k.num_cars):
        sel = gi == j
        g_vel = vwhere(sel, cv.vbroadcast(_vslice(st['vel'], j), gi.shape),
                       g_vel)
        g_ang = vwhere(sel, cv.vbroadcast(_vslice(st['ang_vel'], j),
                                          gi.shape), g_ang)
        g_pos = vwhere(sel, cv.vbroadcast(_vslice(st['pos'], j), gi.shape),
                       g_pos)
    return g_vel, g_ang, g_pos, g_inv_mass


def _calc_friction_impulses(k: TickConsts, st, rc, wc, inv_iw):
    """car.calc_friction_impulses: 4 impulse Vecs (BT).

    With dynamic rays, a wheel whose ray hit the ball or another car uses
    that body's velocity in the relative-velocity terms and its mass and
    inertia in the side jacobian (btVehicleRL.cpp:321-387), keeping the
    reference's quirk of sampling the ground body's point velocity at the
    car-relative offset for rolling friction."""
    mut = k.mut
    friction_scale = mut.car_mass / 3.0
    up = cv.up(st['rot'])
    rightv = cv.right(st['rot'])
    inv_mass_car = 1.0 / mut.car_mass
    inv_i_ball = 1.0 / (0.4 * mut.ball_mass
                        * (mut.ball_radius * C.UU_TO_BT) ** 2)
    impulses = []
    for w in range(4):
        steer = wc['steer_angle'] if w < 2 else torch.zeros_like(
            wc['steer_angle'])
        cs, sn = torch.cos(steer), torch.sin(steer)
        axle0 = vadd(vscale(rightv, cs), vscale(vcross(up, rightv), sn))
        n = rc['n'][w]
        axle = vnormalize(vsub(axle0, vscale(n, vdot(axle0, n))))
        fwd_dir = vnormalize(vcross(n, axle))

        rel = vscale(vsub(rc['cp'][w], st['pos']), C.UU_TO_BT)
        vel_at = vadd(vscale(st['vel'], C.UU_TO_BT),
                      vcross(st['ang_vel'], rel))
        if k.dynamic_rays:
            gi = rc['ground_idx'][w]
            dyn = gi != -1
            g_vel, g_ang, g_pos, g_inv_mass = _ground_body(k, st, gi)
            zf = vzero(rel[0])
            r_b = vscale(vsub(rc['cp'][w], g_pos), C.UU_TO_BT)
            v2_at = vwhere(dyn, vadd(vscale(g_vel, C.UU_TO_BT),
                                     vcross(g_ang, r_b)), zf)
            v2_quirk = vwhere(dyn, vadd(vscale(g_vel, C.UU_TO_BT),
                                        vcross(g_ang, rel)), zf)
        else:
            v2_at = v2_quirk = vzero(rel[0])
            g_inv_mass = 0.0
        rel_vel_side = vdot(vsub(vel_at, v2_at), axle)
        r_cross_n = vcross(rel, axle)
        ang_term = vdot(vcross(cv.matvec(inv_iw, r_cross_n), rel), axle)
        jac = inv_mass_car + ang_term + g_inv_mass
        if k.dynamic_rays:
            # ground angular term: the ball's isotropic inertia, or the
            # hit car's world inverse-inertia tensor
            rb_cross = vcross(r_b, axle)
            g_ang_term = torch.where(
                gi == -2, vdot(vcross(vscale(rb_cross, inv_i_ball), r_b),
                               axle), 0.0)
            for j in range(k.num_cars):
                car_term = vdot(vcross(cv.matvec(_mslice(inv_iw, j),
                                                 rb_cross), r_b), axle)
                g_ang_term = torch.where(gi == j, car_term, g_ang_term)
            jac = jac + torch.where(dyn, g_ang_term, 0.0)
        side = -C.SIDE_FRICTION_CONTACT_DAMPING * rel_vel_side / (
            torch.clamp(jac, min=1e-9))

        rel_vel_fwd = vdot(vsub(vel_at, v2_quirk), fwd_dir)
        brake = wc['brake']
        engine = wc['engine_force']
        rolling_brake = torch.clamp(
            -rel_vel_fwd * C.ROLLING_FRICTION_SCALE_MAGIC, -brake, brake)
        rolling = torch.where(engine == 0.0,
                              torch.where(brake > 0.0, rolling_brake, 0.0),
                              -engine / friction_scale)
        total = vadd(vscale(fwd_dir, rolling * wc['long_friction'][w]),
                     vscale(axle, side * wc['lat_friction'][w]))
        imp = vscale(total, friction_scale)
        impulses.append(vwhere(rc['hit'][w], imp, vzero(imp[0])))
    return impulses


def _apply_suspension(k: TickConsts, st, rc, inv_iw):
    mut, dt = k.mut, k.dt
    dv = vzero(st['vel'][0])
    torque = vzero(st['vel'][0])
    for w in range(4):
        spring = ((k.sus_rest[w] - rc['susp_len'][w]) * C.UU_TO_BT
                  * C.BTVehicle.SUSPENSION_STIFFNESS * rc['clipped_inv'][w])
        damping_scale = torch.where(rc['susp_rel_vel'][w] < 0,
                                    C.BTVehicle.WHEELS_DAMPING_COMPRESSION,
                                    C.BTVehicle.WHEELS_DAMPING_RELAXATION)
        force = (spring - damping_scale * rc['susp_rel_vel'][w]) \
            * k.sus_force_scale[w]
        force = torch.clamp(force, min=0.0)
        force = torch.where(rc['hit'][w], force, 0.0)
        base = force * dt + rc['extra_push'][w]
        imp = vscale(rc['n'][w], base)
        rel = vscale(vsub(rc['cp'][w], st['pos']), C.UU_TO_BT)
        dv = vadd(dv, imp)
        torque = vadd(torque, vcross(rel, imp))
    vel = vadd(st['vel'], vscale(dv, C.BT_TO_UU / mut.car_mass))
    ang_vel = vadd(st['ang_vel'], cv.matvec(inv_iw, torque))
    return vel, ang_vel


def _apply_friction_impulses(k: TickConsts, st, rc, impulses, inv_iw):
    mut, dt = k.mut, k.dt
    up = cv.up(st['rot'])
    dv = vzero(st['vel'][0])
    torque = vzero(st['vel'][0])
    for w in range(4):
        offset = vscale(vsub(rc['cp'][w], st['pos']), C.UU_TO_BT)
        rel = vsub(offset, vscale(up, vdot(offset, up)))
        imp = vscale(impulses[w], dt)
        dv = vadd(dv, imp)
        torque = vadd(torque, vcross(rel, imp))
    vel = vadd(st['vel'], vscale(dv, C.BT_TO_UU / mut.car_mass))
    ang_vel = vadd(st['ang_vel'], cv.matvec(inv_iw, torque))
    return vel, ang_vel


def _update_wheels(k: TickConsts, st, rc, wc, controls, fwd_speed,
                   num_contact):
    """car.update_wheels: (new wc dict, hb_val, sticky_accel Vec)."""
    dt = k.dt
    abs_speed = torch.abs(fwd_speed)
    hb_input = controls[HANDBRAKE] > 0
    hb_val = torch.where(hb_input,
                         st['handbrake_val'] + C.POWERSLIDE_RISE_RATE * dt,
                         st['handbrake_val'] - C.POWERSLIDE_FALL_RATE * dt)
    hb_val = torch.clamp(hb_val, 0.0, 1.0)

    throttle = controls[THROTTLE]
    boosting = (controls[BOOST] > 0) & (st['boost'] > 0)
    real_throttle = torch.where(boosting, 1.0, throttle)

    drive_scale = cv.curve(C.DRIVE_SPEED_TORQUE_FACTOR_CURVE, abs_speed)
    abs_throttle = torch.abs(real_throttle)
    opposite = (abs_speed > C.STOPPING_FORWARD_VEL) & (
        torch.sign(real_throttle) != torch.sign(fwd_speed))
    engine_throttle_nh = torch.where(
        abs_throttle >= C.THROTTLE_DEADZONE,
        torch.where(opposite
                    & (abs_speed > C.BRAKING_NO_THROTTLE_SPEED_THRESH),
                    0.0, real_throttle),
        0.0)
    brake_nh = torch.where(
        abs_throttle >= C.THROTTLE_DEADZONE,
        torch.where(opposite, 1.0, 0.0),
        torch.where(abs_speed < C.STOPPING_FORWARD_VEL, 1.0,
                    C.COASTING_BRAKE_FACTOR))
    engine_throttle = torch.where(hb_input, real_throttle, engine_throttle_nh)
    real_brake = torch.where(hb_input, 0.0, brake_nh)

    drive_scale = torch.where(num_contact < 3, drive_scale / 4.0,
                              drive_scale)
    engine_force = engine_throttle * (C.THROTTLE_TORQUE_AMOUNT
                                      * C.UU_TO_BT) * drive_scale
    brake_force = real_brake * (C.BRAKE_TORQUE_AMOUNT * C.UU_TO_BT)

    steer_angle = cv.curve(C.STEER_ANGLE_FROM_SPEED_CURVE, abs_speed)
    ps_angle = cv.curve(C.POWERSLIDE_STEER_ANGLE_FROM_SPEED_CURVE, abs_speed)
    steer_angle = steer_angle + (ps_angle - steer_angle) * hb_val
    steer_angle = steer_angle * controls[STEER]

    up = cv.up(st['rot'])
    rightv = cv.right(st['rot'])
    # friction latDir uses the PREVIOUS tick's steer (wheel transforms are
    # refreshed at tick start)
    cs, sn = torch.cos(wc['steer_angle']), torch.sin(wc['steer_angle'])
    steered_right = vadd(vscale(rightv, cs), vscale(vcross(up, rightv), sn))

    new_lat, new_long = [], []
    sticky = real_throttle != 0.0
    for w in range(4):
        lat_dir = steered_right if w < 2 else rightv
        long_dir = vcross(lat_dir, rc['n'][w])
        rel = vsub(rc['hard'][w], st['pos'])
        cross_vec = vscale(
            vadd(vcross(st['ang_vel'], vscale(rel, C.UU_TO_BT)),
                 vscale(st['vel'], C.UU_TO_BT)), C.BT_TO_UU)
        base_fric = torch.abs(vdot(cross_vec, lat_dir))
        fric_input = torch.where(
            base_fric > 5.0,
            base_fric / (torch.abs(vdot(cross_vec, long_dir)) + base_fric),
            0.0)
        lat_f = cv.curve(C.LAT_FRICTION_CURVE, fric_input)
        long_f = cv.curve(C.LONG_FRICTION_CURVE, fric_input)
        lat_hb = lat_f * ((cv.curve(C.HANDBRAKE_LAT_FRICTION_FACTOR_CURVE,
                                    fric_input) - 1.0) * hb_val + 1.0)
        long_hb = long_f * ((cv.curve(C.HANDBRAKE_LONG_FRICTION_FACTOR_CURVE,
                                      fric_input) - 1.0) * hb_val + 1.0)
        has_hb = hb_val > 0
        lat_f = torch.where(has_hb, lat_hb, lat_f)
        long_f = torch.where(has_hb, long_hb, torch.ones_like(long_f))
        non_sticky_scale = cv.curve(C.NON_STICKY_FRICTION_FACTOR_CURVE,
                                    rc['n'][w][2])
        lat_f = torch.where(sticky, lat_f, lat_f * non_sticky_scale)
        long_f = torch.where(sticky, long_f, long_f * non_sticky_scale)
        new_lat.append(torch.where(rc['hit'][w], lat_f,
                                   wc['lat_friction'][w]))
        new_long.append(torch.where(rc['hit'][w], long_f,
                                    wc['long_friction'][w]))

    # sticky force (Car.cpp:463-474), gated on world contact (a wheel on
    # the ball or another car does not stick)
    any_world = (rc['in_world'][0] | rc['in_world'][1] | rc['in_world'][2]
                 | rc['in_world'][3])
    sum_n = vzero(st['pos'][0])
    for w in range(4):
        sum_n = vadd(sum_n, vwhere(rc['hit'][w], rc['n'][w],
                                   vzero(sum_n[0])))
    up_dir = vwhere(vnorm(sum_n) > 1e-9, vnormalize(sum_n), up)
    full_stick = (real_throttle != 0.0) | (abs_speed > C.STOPPING_FORWARD_VEL)
    sticky_scale = 0.5 + torch.where(full_stick, 1.0 - torch.abs(up_dir[2]),
                                     0.0)
    sticky_accel = vscale(up_dir, sticky_scale * C.GRAVITY_Z)
    sticky_accel = vwhere(any_world, sticky_accel, vzero(sticky_accel[0]))
    new_wc = dict(steer_angle=steer_angle, engine_force=engine_force,
                  brake=brake_force, lat_friction=new_lat,
                  long_friction=new_long)
    return new_wc, hb_val, sticky_accel


# ---------------------------------------------------------------------------
# Car state machines (Car.cpp _Update*)

def _update_air_torque(k: TickConsts, st, controls, in_air_mask,
                       zero_wheels):
    """(ang_accel Vec, accel Vec, is_flipping)."""
    fwd = cv.forward(st['rot'])
    rightv = cv.right(st['rot'])
    upv = cv.up(st['rot'])
    dir_pitch = cv.vneg(rightv)
    dir_yaw = upv
    dir_roll = cv.vneg(fwd)

    is_flipping = st['is_flipping'] & st['has_flipped'] & (
        st['flip_time'] < C.FLIP_TORQUE_TIME)
    rt = st['flip_rel_torque']
    has_rel_torque = (rt[0] != 0.0) | (rt[1] != 0.0) | (rt[2] != 0.0)

    pitch_in = controls[PITCH]
    flip_cancel = (rt[1] != 0.0) & (pitch_in != 0.0) & (
        torch.sign(rt[1]) == torch.sign(pitch_in))
    pitch_scale = torch.where(
        flip_cancel, 1.0 - torch.clamp(torch.abs(pitch_in), max=1.0), 1.0)
    dodge_torque = (rt[0] * C.FLIP_TORQUE_X,
                    rt[1] * pitch_scale * C.FLIP_TORQUE_Y,
                    torch.zeros_like(rt[2]))
    flip_ang_accel = cv.matvec(st['rot'], dodge_torque)
    flip_ang_accel = vwhere(is_flipping & has_rel_torque, flip_ang_accel,
                            vzero(rt[0]))

    do_air_control = torch.where(
        is_flipping, (has_rel_torque & flip_cancel) | ~has_rel_torque, True)
    do_air_control = do_air_control & ~st['is_auto_flipping'] & zero_wheels

    pitch_lock = is_flipping | (
        st['has_flipped']
        & (st['flip_time'] < C.FLIP_TORQUE_TIME + C.FLIP_PITCHLOCK_EXTRA_TIME))
    pitch_torque_scale = torch.where(pitch_lock, 0.0, 1.0)

    yaw_in = controls[YAW]
    roll_in = controls[ROLL]
    any_input = (pitch_in != 0) | (yaw_in != 0) | (roll_in != 0)
    tx, ty, tz = C.CAR_AIR_CONTROL_TORQUE
    torque = vadd(vscale(dir_pitch, pitch_in * pitch_torque_scale * tx),
                  vscale(dir_yaw, yaw_in * ty),
                  vscale(dir_roll, roll_in * tz))
    torque = vwhere(any_input, torque, vzero(torque[0]))

    dx, dy, dz = C.CAR_AIR_CONTROL_DAMPING
    damp_pitch = vdot(dir_pitch, st['ang_vel']) * dx * (
        1.0 - torch.abs(torch.where(do_air_control,
                                    pitch_in * pitch_torque_scale, 0.0)))
    damp_yaw = vdot(dir_yaw, st['ang_vel']) * dy * (
        1.0 - torch.abs(torch.where(do_air_control, yaw_in, 0.0)))
    damp_roll = vdot(dir_roll, st['ang_vel']) * dz
    damping = vadd(vscale(dir_yaw, damp_yaw), vscale(dir_pitch, damp_pitch),
                   vscale(dir_roll, damp_roll))
    control_ang_accel = vscale(vsub(torque, damping), C.CAR_TORQUE_SCALE)
    control_ang_accel = vwhere(do_air_control, control_ang_accel,
                               vzero(torque[0]))

    throttle = controls[THROTTLE]
    air_accel = vscale(fwd, throttle * C.THROTTLE_AIR_ACCEL)
    air_accel = vwhere(throttle != 0.0, air_accel, vzero(throttle))

    ang_accel = vadd(flip_ang_accel, control_ang_accel)
    ang_accel = vwhere(in_air_mask, ang_accel, vzero(ang_accel[0]))
    accel = vwhere(in_air_mask, air_accel, vzero(air_accel[0]))
    return ang_accel, accel, is_flipping & in_air_mask


def _update_jump(k: TickConsts, st, controls, jump_pressed):
    """(updates dict, dv Vec, accel Vec)."""
    mut, dt = k.mut, k.dt
    on_ground = st['is_on_ground']
    is_jumping = st['is_jumping']
    has_jumped = st['has_jumped']
    jump_time = st['jump_time']

    reset_ok = on_ground & ~is_jumping & ~(
        has_jumped & (jump_time < C.JUMP_MIN_TIME + C.JUMP_RESET_TIME_PAD))
    has_jumped = has_jumped & ~reset_ok
    jump_time = torch.where(reset_ok, 0.0, jump_time)

    cont = (jump_time < C.JUMP_MIN_TIME) | (
        (controls[JUMP] > 0) & (jump_time < C.JUMP_MAX_TIME))
    start = ~is_jumping & on_ground & jump_pressed
    new_is_jumping = torch.where(is_jumping, cont, start)
    jump_time = torch.where(start, 0.0, jump_time)

    upv = cv.up(st['rot'])
    dv = vwhere(start, vscale(upv, mut.jump_immediate_force),
                vzero(jump_time))
    has_jumped = has_jumped | new_is_jumping
    accel_scale = torch.where(jump_time < C.JUMP_MIN_TIME,
                              C.JUMP_PRE_MIN_ACCEL_SCALE, 1.0)
    accel = vwhere(new_is_jumping, vscale(upv, mut.jump_accel * accel_scale),
                   vzero(jump_time))
    jump_time = torch.where(new_is_jumping | has_jumped, jump_time + dt,
                            jump_time)
    return (dict(is_jumping=new_is_jumping, has_jumped=has_jumped,
                 jump_time=jump_time), dv, accel)


def _update_auto_flip(k: TickConsts, st, controls, jump_pressed):
    dt = k.dt
    roll_ang = cv.roll_angle(st['rot'])
    abs_roll = torch.abs(roll_ang)
    trigger = (jump_pressed & st['has_world_contact']
               & (st['world_contact_normal'][2] > C.CAR_AUTOFLIP_NORMZ_THRESH)
               & (abs_roll > C.CAR_AUTOFLIP_ROLL_THRESH))
    timer = torch.where(trigger, C.CAR_AUTOFLIP_TIME * (abs_roll / np.pi),
                        st['auto_flip_timer'])
    scale = torch.where(trigger, torch.where(roll_ang > 0, 1.0, -1.0),
                        st['auto_flip_torque_scale'])
    is_af = trigger | st['is_auto_flipping']

    upv = cv.up(st['rot'])
    dv = vwhere(trigger, vscale(cv.vneg(upv), C.CAR_AUTOFLIP_IMPULSE),
                vzero(timer))
    active = is_af & (timer > 0)
    expired = is_af & ~active
    fwd = cv.forward(st['rot'])
    dw = vwhere(active, vscale(fwd, C.CAR_AUTOFLIP_TORQUE * scale * dt),
                vzero(timer))
    timer = torch.where(active, timer - dt,
                        torch.where(expired, 0.0, timer))
    is_af = is_af & ~expired
    return (dict(is_auto_flipping=is_af, auto_flip_timer=timer,
                 auto_flip_torque_scale=scale), dv, dw)


def _update_double_jump_or_flip(k: TickConsts, st, controls, jump_pressed,
                                fwd_speed, is_jumping, has_jumped,
                                is_flipping):
    """(updates, dv Vec, z_damp_maybe, z_damp_always)."""
    mut, dt = k.mut, k.dt
    on_ground = st['is_on_ground']
    air = ~on_ground
    has_double_jumped = st['has_double_jumped'] & ~on_ground
    has_flipped = st['has_flipped'] & ~on_ground
    air_time = torch.where(on_ground, 0.0, st['air_time'] + dt)
    atsj = torch.where(
        on_ground, 0.0,
        torch.where(has_jumped & ~is_jumping,
                    st['air_time_since_jump'] + dt, 0.0))
    flip_time = torch.where(on_ground, 0.0, st['flip_time'])
    frt = st['flip_rel_torque']

    press_window = air & jump_pressed & (atsj < C.DOUBLEJUMP_MAX_DELAY)
    yaw_in, pitch_in, roll_in = controls[YAW], controls[PITCH], controls[ROLL]
    input_mag = torch.abs(yaw_in) + torch.abs(pitch_in) + torch.abs(roll_in)
    is_flip_input = input_mag >= C.DODGE_DEADZONE

    fresh = ~has_double_jumped & ~has_flipped
    can_flip = fresh | mut.unlimited_flips
    can_dj = fresh | mut.unlimited_double_jumps
    can_use = torch.where(is_flip_input, can_flip, can_dj)
    can_use = can_use & ~st['is_auto_flipping']
    do_flip = press_window & can_use & is_flip_input
    do_dj = press_window & can_use & ~is_flip_input

    # flip initiation (Car.cpp:677-737)
    fwd_ratio = torch.abs(fwd_speed) / C.CAR_MAX_SPEED
    yaw_roll = yaw_in + roll_in
    zero = torch.zeros_like(pitch_in)
    dodge_dir = (-pitch_in, yaw_roll, zero)
    stall = (torch.abs(yaw_roll) < 0.1) & (torch.abs(pitch_in) < 0.1)
    dodge_dir = vwhere(stall, vzero(pitch_in), vnormalize(dodge_dir))
    new_rel_torque = (-dodge_dir[1], dodge_dir[0], zero)
    ddx = torch.where(torch.abs(dodge_dir[0]) < 0.1, 0.0, dodge_dir[0])
    ddy = torch.where(torch.abs(dodge_dir[1]) < 0.1, 0.0, dodge_dir[1])
    nonzero_dd = (torch.abs(ddx) > 1e-7) | (torch.abs(ddy) > 1e-7)
    backwards = torch.where(torch.abs(fwd_speed) < 100.0, ddx < 0.0,
                            (ddx >= 0.0) != (fwd_speed >= 0.0))
    ivx = ddx * C.FLIP_INITIAL_VEL_SCALE
    ivy = ddy * C.FLIP_INITIAL_VEL_SCALE
    max_x = torch.where(backwards, C.FLIP_BACKWARD_IMPULSE_MAX_SPEED_SCALE,
                        C.FLIP_FORWARD_IMPULSE_MAX_SPEED_SCALE)
    vx = ivx * ((max_x - 1.0) * fwd_ratio + 1.0)
    vy = ivy * ((C.FLIP_SIDE_IMPULSE_MAX_SPEED_SCALE - 1.0) * fwd_ratio
                + 1.0)
    vx = torch.where(backwards, vx * C.FLIP_BACKWARD_IMPULSE_SCALE_X, vx)

    fwd = cv.forward(st['rot'])
    h = torch.sqrt(fwd[0] * fwd[0] + fwd[1] * fwd[1])
    ca = torch.where(h > 1e-12, fwd[0] / torch.clamp(h, min=1e-12), 1.0)
    sa = torch.where(h > 1e-12, fwd[1] / torch.clamp(h, min=1e-12), 0.0)
    dvx = vx * ca + vy * sa
    dvy = -vx * sa + vy * ca
    flip_dv = vwhere(do_flip & nonzero_dd, (dvx, dvy, torch.zeros_like(dvx)),
                     vzero(dvx))
    flip_time = torch.where(do_flip, 0.0, flip_time)
    has_flipped = has_flipped | do_flip
    is_flipping = is_flipping | do_flip
    frt = vwhere(do_flip, new_rel_torque, frt)

    upv = cv.up(st['rot'])
    dj_dv = vwhere(do_dj, vscale(upv, C.JUMP_IMMEDIATE_FORCE), vzero(dvx))
    has_double_jumped = has_double_jumped | do_dj

    flip_time_next = torch.where(is_flipping | has_flipped, flip_time + dt,
                                 flip_time)
    in_torque_window = is_flipping & (flip_time_next <= C.FLIP_TORQUE_TIME)
    z_damp = in_torque_window & (flip_time_next >= C.FLIP_Z_DAMP_START)
    z_damp_always = z_damp & (flip_time_next < C.FLIP_Z_DAMP_END)
    updates = dict(has_double_jumped=has_double_jumped,
                   has_flipped=has_flipped, air_time=air_time,
                   air_time_since_jump=atsj, flip_time=flip_time_next,
                   is_flipping=is_flipping, flip_rel_torque=frt)
    return updates, vadd(flip_dv, dj_dv), z_damp, z_damp_always


def _update_auto_roll(k: TickConsts, st, rc, num_contact):
    """(accel Vec, ang_accel Vec); the caller masks."""
    upv = cv.up(st['rot'])
    sum_n = vzero(st['pos'][0])
    for w in range(4):
        sum_n = vadd(sum_n, vwhere(rc['hit'][w], rc['n'][w],
                                   vzero(sum_n[0])))
    wheels_up = vwhere(vnorm(sum_n) > 1e-9, vnormalize(sum_n), upv)
    ground_up = vwhere(num_contact > 0, wheels_up, st['world_contact_normal'])
    ground_down = cv.vneg(ground_up)
    fdir = cv.forward(st['rot'])
    rdir = cv.right(st['rot'])
    cross_right = vcross(ground_up, fdir)
    cross_fwd = vcross(ground_down, cross_right)
    right_factor = 1.0 - torch.clamp(vdot(rdir, cross_right), 0.0, 1.0)
    fwd_factor = 1.0 - torch.clamp(vdot(fdir, cross_fwd), 0.0, 1.0)
    t_dir_right = vscale(fdir, torch.where(vdot(rdir, ground_up) >= 0,
                                           -1.0, 1.0))
    t_dir_fwd = vscale(rdir, torch.where(vdot(fdir, ground_up) >= 0,
                                         1.0, -1.0))
    torque = vadd(vscale(t_dir_right, right_factor),
                  vscale(t_dir_fwd, fwd_factor))
    return (vscale(ground_down, C.CAR_AUTOROLL_FORCE),
            vscale(torque, C.CAR_AUTOROLL_TORQUE))


def _update_boost(k: TickConsts, st, controls):
    mut, dt = k.mut, k.dt
    boosting_input = controls[BOOST] > 0
    tsb = st['time_spent_boosting']
    stop = ~boosting_input & (tsb >= C.BOOST_MIN_TIME)
    tsb = torch.where(tsb > 0, torch.where(stop, 0.0, tsb + dt),
                      torch.where(boosting_input, dt, 0.0))
    active = (st['boost'] > 0) & (tsb > 0)
    boost_amt = torch.where(
        active,
        torch.clamp(st['boost'] - mut.boost_used_per_second * dt, min=0.0),
        st['boost'])
    boost_amt = torch.clamp(boost_amt, max=C.BOOST_MAX)
    accel_mag = torch.where(st['is_on_ground'], mut.boost_accel_ground,
                            mut.boost_accel_air)
    fwd = cv.forward(st['rot'])
    accel = vwhere(active, vscale(fwd, accel_mag), vzero(tsb))
    return dict(boost=boost_amt, time_spent_boosting=tsb), accel


# ---------------------------------------------------------------------------
# Contacts

def _slot_const(values, sample):
    """Per-car-slot constant shaped like ``sample`` ((C, E))."""
    return torch.stack([torch.full_like(sample[0], float(v)) for v in values],
                       dim=0)


def _resolve_car_world(k: TickConsts, st, inv_iw, vel_pre, ang_vel_pre):
    """Car against every plane.  True planes: single support-vertex point
    live below 0.02*(|he|+|offset|); mesh stand-in planes: centroid of the
    corners inside the 2uu triangle margin.  10 solver passes per plane.
    Returns (dvel Vec uu, dang Vec, push Vec uu, has_contact, normal)."""
    mut = k.mut
    inv_mass = 1.0 / mut.car_mass
    valid = plane_validity(st['pos'])
    he = k.half_extents
    off = k.hitbox_offset
    brk = C.CONTACT_BREAK_FRAC * (float(np.linalg.norm(np.asarray(he)))
                                  + float(np.linalg.norm(np.asarray(off))))
    corners = [vadd(st['pos'], cv.matvec(st['rot'],
                                         cv.vconst(cl, st['pos'][0])))
               for cl in k.corners_local]
    zero = torch.zeros_like(st['pos'][0])
    dvel = dang = push = nsum = vzero(zero)
    has_contact = torch.zeros_like(st['is_on_ground'])
    vel_bt = vscale(st['vel'], C.UU_TO_BT)
    vel_pre_bt = vscale(vel_pre, C.UU_TO_BT)
    for p, plane in enumerate(k.planes):
        n = cv.vconst(plane[:3], zero)
        if geom._TRUE_PLANE[p]:
            # support vertex along -n in the box frame, ties toward +he
            ldir = cv.mat_t_vec(st['rot'], cv.vneg(n))
            sup_local = tuple(
                torch.where(ldir[i] >= 0.0, off[i] + he[i], off[i] - he[i])
                for i in range(3))
            sup = vadd(st['pos'], cv.matvec(st['rot'], sup_local))
            d = _plane_dist(plane, sup)
            plane_active = _and_valid(valid[p], d < brk)
            contact_pt = sup
            max_depth = torch.clamp(-d, min=0.0)
        else:
            ncont = zero
            cx, cy, cz = zero, zero, zero
            max_depth = zero
            for corner in corners:
                pen = -_plane_dist(plane, corner) + C.MESH_COLLISION_MARGIN
                act = _and_valid(valid[p], pen > 0)
                actf = act.to(zero.dtype)
                ncont = ncont + actf
                cx = cx + actf * corner[0]
                cy = cy + actf * corner[1]
                cz = cz + actf * corner[2]
                max_depth = torch.maximum(max_depth,
                                          torch.where(act, pen, 0.0))
            plane_active = ncont > 0
            inv_n = 1.0 / torch.clamp(ncont, min=1.0)
            contact_pt = (cx * inv_n, cy * inv_n, cz * inv_n)
        r_bt = vscale(vsub(contact_pt, st['pos']), C.UU_TO_BT)
        dv_bt, dw = _contact_vs_static(
            vel_bt, st['ang_vel'], r_bt, n, plane_active, inv_mass, inv_iw,
            mut.car_world_restitution, mut.car_world_friction,
            vel_pre_bt, ang_vel_pre, iterations=10)
        z3 = vzero(zero)
        dvel = vadd(dvel, dv_bt)
        dang = vadd(dang, dw)
        push = vadd(push, vwhere(plane_active,
                                 vscale(n, max_depth * C.SOLVER_ERP2), z3))
        nsum = vadd(nsum, vwhere(plane_active, n, z3))
        has_contact = has_contact | plane_active
    normal = vwhere(has_contact, vnormalize(nsum), vzero(zero))
    return vscale(dvel, C.BT_TO_UU), dang, push, has_contact, normal


def _resolve_ball_world(k: TickConsts, ball_pos, ball_vel, ball_ang_vel,
                        ball_vel_pre):
    """The merged sphere-plane contact: (dvel uu, dang, push uu, touching,
    mean contact normal)."""
    mut = k.mut
    radius = mut.ball_radius
    break_gap = C.CONTACT_BREAK_FRAC * (radius + C.SPHERE_BOUND_EXTRA)
    valid = plane_validity(ball_pos)
    zero = torch.zeros_like(ball_pos[0])
    num = zero
    navg = vzero(zero)
    max_depth = zero
    for p, plane in enumerate(k.planes):
        gap = _plane_dist(plane, ball_pos) - radius
        act = _and_valid(valid[p], gap < break_gap)
        actf = act.to(zero.dtype)
        num = num + actf
        navg = vadd(navg, vscale(cv.vconst(plane[:3], zero), actf))
        max_depth = torch.maximum(max_depth, torch.where(act, -gap, 0.0))
    touching = num > 0
    navg = vscale(navg, 1.0 / torch.clamp(num, min=1.0))
    r_bt = vscale(navg, -radius * C.UU_TO_BT)
    inertia = 0.4 * mut.ball_mass * (radius * C.UU_TO_BT) ** 2
    s = 1.0 / inertia
    inv_iw = ((s, 0.0, 0.0), (0.0, s, 0.0), (0.0, 0.0, s))
    restitution = max(mut.ball_world_restitution, C.WORLD_RESTITUTION)
    friction = min(mut.ball_world_friction, C.WORLD_FRICTION)
    dv_bt, dw = _contact_vs_static(
        vscale(ball_vel, C.UU_TO_BT), ball_ang_vel, r_bt, navg, touching,
        1.0 / mut.ball_mass, inv_iw, restitution, friction,
        vscale(ball_vel_pre, C.UU_TO_BT))
    push = vscale(navg, torch.clamp(max_depth, min=0.0) * C.SOLVER_ERP2)
    return (vscale(dv_bt, C.BT_TO_UU), dw,
            vwhere(touching, push, vzero(zero)), touching, navg)


def puck_consts(mut, dt: float) -> tuple:
    """The snowday puck's values, in double precision: its contact break
    gap (uu), inverse inertia across and along its axis (a solid cylinder,
    bt units), and the ground stick's speed change per tick (uu/s)."""
    r_bt = C.Snowday.PUCK_RADIUS * C.UU_TO_BT
    h_bt = C.Snowday.PUCK_HEIGHT * C.UU_TO_BT
    i_axis = 0.5 * mut.ball_mass * r_bt ** 2
    i_perp = mut.ball_mass * (3 * r_bt ** 2 + h_bt ** 2) / 12.0
    return (C.CONTACT_BREAK_FRAC * float(np.hypot(C.Snowday.PUCK_RADIUS,
                                                  C.Snowday.PUCK_HEIGHT / 2)),
            1.0 / i_perp, 1.0 / i_axis,
            C.Snowday.PUCK_GROUND_STICK_FORCE / mut.ball_mass * dt
            * C.BT_TO_UU)


def _snow_plane_row(plane, axis, ball_pos, valid, break_gap):
    """One plane of the puck's contact: the support distance of the
    cylinder (axis ``axis``) along the plane normal, its gap, and whether
    the row is live (valid and within ``break_gap``)."""
    r_p = C.Snowday.PUCK_RADIUS
    h_half = C.Snowday.PUCK_HEIGHT / 2
    pn = cv.vconst(plane[:3], ball_pos[0])
    a_dot_n = vdot(axis, pn)
    support = (r_p * torch.sqrt(torch.clamp(1.0 - a_dot_n * a_dot_n,
                                            min=0.0))
               + h_half * torch.abs(a_dot_n))
    gap = _plane_dist(plane, ball_pos) - support
    return _and_valid(valid, gap < break_gap), support, gap, pn


def _resolve_ball_world_snowday(k: TickConsts, ball_pos, ball_vel,
                                ball_ang_vel, ball_rot, ball_vel_pre):
    """The snowday puck against the arena: the merged contact over all the
    analytic planes (in either arena: the puck never meets the facet arena,
    Ball.cpp:53-82) with the cylinder's exact support distance per plane,
    its solid-cylinder inertia turned to the world, 10 solver passes.
    Returns (dvel uu, dang, push uu, touching, mean contact normal)."""
    mut = k.mut
    axis = (ball_rot[0][2], ball_rot[1][2], ball_rot[2][2])
    break_gap, inv_i_perp, inv_i_axis, _ = puck_consts(mut, k.dt)
    valid = plane_validity(ball_pos)
    zero = torch.zeros_like(ball_pos[0])
    num = zero
    navg = vzero(zero)
    max_depth = zero
    supp_sum = zero
    for p, plane in enumerate(k.planes):
        act, support, gap, pn = _snow_plane_row(plane, axis, ball_pos,
                                                valid[p], break_gap)
        actf = act.to(zero.dtype)
        num = num + actf
        navg = vadd(navg, vscale(pn, actf))
        supp_sum = supp_sum + support * actf
        max_depth = torch.maximum(max_depth, torch.where(act, -gap, 0.0))
    touching = num > 0
    inv_n = 1.0 / torch.clamp(num, min=1.0)
    navg = vscale(navg, inv_n)
    r_bt = vscale(navg, -(supp_sum * inv_n) * C.UU_TO_BT)
    inv_iw = cv.inv_inertia_world(ball_rot, (inv_i_perp, inv_i_perp,
                                             inv_i_axis))
    dv_bt, dw = _contact_vs_static(
        vscale(ball_vel, C.UU_TO_BT), ball_ang_vel, r_bt, navg, touching,
        1.0 / mut.ball_mass, inv_iw,
        max(mut.ball_world_restitution, C.WORLD_RESTITUTION),
        min(mut.ball_world_friction, C.WORLD_FRICTION),
        vscale(ball_vel_pre, C.UU_TO_BT), iterations=10)
    push = vscale(navg, torch.clamp(max_depth, min=0.0) * C.SOLVER_ERP2)
    return (vscale(dv_bt, C.BT_TO_UU), dw,
            vwhere(touching, push, vzero(zero)), touching, navg)


# ---------------------------------------------------------------------------
# Full fidelity: facet-arena manifolds and the joint PGS

def _sq(x):
    return x * x


def keep_diverse4(d, pays, px, py, pz):
    """4-slot contact retention, the stand-in for btPersistentManifold's
    sortCachedPoints: slot 0 takes the deepest candidate, slots 1-3 each
    the one whose least squared distance to the points already kept,
    (px, py, pz), is largest; ties go to the lowest candidate index.  With
    <= 4 live candidates every one is kept.  ``d``: (K,) + S distances,
    1e30 where the candidate is not live; ``pays``: list of (K,) + S
    payloads.  Returns (slot_d, slot_occ, slot_pays), lists of 4."""
    big = 1e30
    K = d.shape[0]
    iota = torch.arange(K, device=d.device).reshape(
        (K,) + (1,) * (d.dim() - 1))
    avail = d < big
    mind = torch.full_like(d, float("inf"))
    slot_d, slot_occ, slot_pay = [], [], []
    for s in range(4):
        if s == 0:
            dm = torch.where(avail, d, big)
            dmin = dm.min(0).values
            hit = dm == dmin[None]
            occ = dmin < big
        else:
            score = torch.where(avail, mind, -float("inf"))
            smax = score.max(0).values
            hit = score == smax[None]
            occ = torch.isfinite(smax)
        first = torch.where(hit & avail, iota, K).min(0).values
        one = iota == first[None]
        idx = torch.clamp(first, max=K - 1)[None]

        def pick(pp):
            return pp.gather(0, idx)[0]
        slot_d.append(torch.where(occ, pick(d), big))
        slot_occ.append(occ)
        slot_pay.append(tuple(torch.where(occ, pick(pp), 0.0)
                              for pp in pays))
        dd = (_sq(px - pick(px)[None]) + _sq(py - pick(py)[None])
              + _sq(pz - pick(pz)[None]))
        mind = torch.where(occ[None], torch.minimum(mind, dd), mind)
        avail = avail & ~one
    return slot_d, slot_occ, slot_pay


def _sheets():
    """(z0, up_sign, fillet inset) of the floor and ceiling grids."""
    return ((0.0, 1.0, geom.FLOOR_FILLET_RADIUS),
            (C.ARENA_HEIGHT, -1.0, geom.CEILING_FILLET_RADIUS))


def _facet_sphere_manifold(k: TickConsts, pos, radius, break_gap):
    """Ball vs the facet arena: 4 retained contacts (n Vec, gap, occ).
    The candidates are the facet rows (with the tessellation-seam
    duplicates, which weight the merged contact's average normal like the
    reference's per-triangle manifold) and the floor and ceiling grid
    rows; retention disperses over the contact normals."""
    big = 1e30
    nx_s, ny_s, nz_s, gap_s, act_s = fa.sphere_contacts(
        pos[0], pos[1], pos[2], radius, break_gap, tab=k.facets)
    d_parts = [torch.where(act_s, gap_s, big)]
    pay_parts = [[nx_s, ny_s, nz_s, gap_s]]
    for z0, up, inset in _sheets():
        for nx, ny, nz, cx, cy, gap, act in fa.sheet_sphere_contacts(
                pos[0], pos[1], pos[2], radius, break_gap, z0, up):
            act = act & fa.sheet_clip_ok(k.facets, cx, cy, inset)
            d_parts.append(torch.where(act, gap, big)[None])
            pay_parts.append([a[None] for a in (nx, ny, nz, gap)])
    d = torch.cat(d_parts)
    pays = [torch.cat([pp[i] for pp in pay_parts]) for i in range(4)]
    _, slot_occ, slot_pay = keep_diverse4(d, pays, pays[0], pays[1],
                                          pays[2])
    return [((p[0], p[1], p[2]), p[3], occ)
            for p, occ in zip(slot_pay, slot_occ)]


def _facet_box_manifold(k: TickConsts, st, brk):
    """Car hitbox vs the facet arena: 4 retained contacts (n Vec, point
    on the car Vec, dist, occ).  The candidates include the floor and
    ceiling grid rows: the reference resolves a landing through one
    contact per overlapping grid triangle; retention disperses over the
    contact points."""
    big = 1e30
    he, off = k.half_extents, k.hitbox_offset
    bc = _box_centers(k, st)
    nx_s, ny_s, nz_s, px_s, py_s, pz_s, dist_s, act_s = fa.box_contacts(
        bc[0], bc[1], bc[2], st['rot'], he, brk, tab=k.facets)
    d_parts = [torch.where(act_s, dist_s, big)]
    pay_parts = [[nx_s, ny_s, nz_s, px_s, py_s, pz_s, dist_s]]
    dist_m = fa.box_dist_margin(he)
    for z0, up, inset in _sheets():
        for nx, ny, nz, cx, cy, cz, dist, act in fa.sheet_box_contacts(
                st['pos'][0], st['pos'][1], st['pos'][2], st['rot'], he,
                off, z0, up, C.MESH_COLLISION_MARGIN, dist_m, brk):
            act = act & fa.sheet_clip_ok(k.facets, cx, cy, inset)
            # the lever arm uses the point on the car, posB + n * dist
            d_parts.append(torch.where(act, dist, big)[None])
            pay_parts.append([a[None] for a in (nx, ny, nz, cx, cy,
                                                cz + nz * dist, dist)])
    d = torch.cat(d_parts)
    pays = [torch.cat([pp[i] for pp in pay_parts]) for i in range(7)]
    _, slot_occ, slot_pay = keep_diverse4(d, pays, pays[3], pays[4],
                                          pays[5])
    return [((p[0], p[1], p[2]), (p[3], p[4], p[5]), p[6], occ)
            for p, occ in zip(slot_pay, slot_occ)]


def _pgs_rows(k: TickConsts, vel_bt, ang_vel, rows, inv_mass, inv_iw,
              restitution, friction, vel_pre_bt, ang_vel_pre,
              iterations: int = 10):
    """One body against the static world over a fixed list of contact rows
    (n Vec, r Vec (bt), dist_bt, act), bullet's order: each of
    ``iterations`` velocity passes runs the normal rows, then the friction
    rows; then ``iterations`` split-impulse position passes.  Inactive rows
    apply their impulse times 0.  Returns (dv Vec bt, dw Vec, push Vec bt,
    turn Vec)."""
    dt = k.dt
    setup = []
    for n, r, dist_bt, act in rows:
        ang_comp = cv.matvec(inv_iw, vcross(r, n))
        jac_inv = 1.0 / torch.clamp(inv_mass + vdot(n, vcross(ang_comp, r)),
                                    min=1e-12)
        rel_rest = vdot(n, vadd(vel_pre_bt, vcross(ang_vel_pre, r)))
        rest = _restitution_rhs(rel_rest, restitution)
        vel_at = vadd(vel_bt, vcross(ang_vel, r))
        tang = vsub(vel_at, vscale(n, vdot(n, vel_at)))
        t_len = vnorm(tang)
        t_dir = vwhere(t_len > 1.49e-8,
                       vscale(tang, 1.0 / torch.clamp(t_len, min=1e-12)),
                       _plane_space(n))
        t_ang = cv.matvec(inv_iw, vcross(r, t_dir))
        t_jac_inv = 1.0 / torch.clamp(
            inv_mass + vdot(t_dir, vcross(t_ang, r)), min=1e-12)
        push_target = torch.clamp(-dist_bt, min=0.0) * (C.SOLVER_ERP2 / dt)
        setup.append((n, r, jac_inv, rest, t_dir, t_jac_inv, push_target,
                      act.to(jac_inv.dtype)))

    def apply(dv, dw, direction, r, dj):
        imp = vscale(direction, dj)
        return (vadd(dv, vscale(imp, inv_mass)),
                vadd(dw, cv.matvec(inv_iw, vcross(r, imp))))

    dv = dw = vzero(vel_bt[0])
    j_n = [torch.zeros_like(vel_bt[0])] * len(rows)
    j_t = list(j_n)
    for _ in range(iterations):
        for i, (n, r, jac_inv, rest, _td, _tj, _pt, actf) in \
                enumerate(setup):
            rel = vdot(n, vadd(vadd(vel_bt, dv), vcross(vadd(ang_vel, dw), r)))
            new_acc = torch.clamp(j_n[i] + (rest - rel) * jac_inv, min=0.0)
            dj = (new_acc - j_n[i]) * actf
            dv, dw = apply(dv, dw, n, r, dj)
            j_n[i] = j_n[i] + dj
        for i, (n, r, _ji, _re, t_dir, t_jac_inv, _pt, actf) in \
                enumerate(setup):
            rel = vdot(t_dir, vadd(vadd(vel_bt, dv),
                                   vcross(vadd(ang_vel, dw), r)))
            lim = friction * j_n[i]
            new_acc = torch.clamp(j_t[i] + -rel * t_jac_inv, -lim, lim)
            dj = torch.where(j_n[i] > 0, (new_acc - j_t[i]) * actf, 0.0)
            dv, dw = apply(dv, dw, t_dir, r, dj)
            j_t[i] = j_t[i] + dj

    pv = pw = vzero(vel_bt[0])
    j_p = [torch.zeros_like(vel_bt[0])] * len(rows)
    for _ in range(iterations):
        for i, (n, r, jac_inv, _re, _td, _tj, push_target, actf) in \
                enumerate(setup):
            rel = vdot(n, vadd(pv, vcross(pw, r)))
            new_acc = torch.clamp(j_p[i] + (push_target - rel) * jac_inv,
                                  min=0.0)
            dj = (new_acc - j_p[i]) * actf
            pv, pw = apply(pv, pw, n, r, dj)
            j_p[i] = j_p[i] + dj
    return dv, dw, vscale(pv, dt), vscale(pw, C.SPLIT_IMPULSE_TURN_ERP * dt)


def _resolve_car_world_mesh(k: TickConsts, st, inv_iw, vel_pre, ang_vel_pre):
    """Car against the full-fidelity world: the 4 retained facet contacts
    and the 4 true planes' support-vertex contacts, solved jointly by
    ``_pgs_rows``.  Returns (dvel uu, dang, push uu, turn, has_contact,
    normal)."""
    mut = k.mut
    he, off = k.half_extents, k.hitbox_offset
    brk = C.CONTACT_BREAK_FRAC * (float(np.linalg.norm(np.asarray(he)))
                                  + float(np.linalg.norm(np.asarray(off))))
    rows = []
    for n, sup, dist, occ in _facet_box_manifold(k, st, brk):
        rows.append((n, vscale(vsub(sup, st['pos']), C.UU_TO_BT),
                     dist * C.UU_TO_BT, occ))
    zero = torch.zeros_like(st['pos'][0])
    for p in world_planes(k):
        plane = k.planes[p]
        n = cv.vconst(plane[:3], zero)
        ldir = cv.mat_t_vec(st['rot'], cv.vneg(n))
        sup_local = tuple(
            torch.where(ldir[i] >= 0.0, off[i] + he[i], off[i] - he[i])
            for i in range(3))
        sup = vadd(st['pos'], cv.matvec(st['rot'], sup_local))
        d = _plane_dist(plane, sup)
        rows.append((n, vscale(vsub(sup, st['pos']), C.UU_TO_BT),
                     d * C.UU_TO_BT, d < brk))
    dv_bt, dw, push_bt, turn = _pgs_rows(
        k, vscale(st['vel'], C.UU_TO_BT), st['ang_vel'], rows,
        1.0 / mut.car_mass, inv_iw, mut.car_world_restitution,
        mut.car_world_friction, vscale(vel_pre, C.UU_TO_BT), ang_vel_pre)
    has_contact = rows[0][3]
    nsum = vzero(zero)
    for n, _r, _d, act in rows:
        has_contact = has_contact | act
        nsum = vadd(nsum, vwhere(act, n, vzero(zero)))
    normal = vwhere(has_contact, vnormalize(nsum), vzero(zero))
    return (vscale(dv_bt, C.BT_TO_UU), dw, vscale(push_bt, C.BT_TO_UU), turn,
            has_contact, normal)


def _resolve_ball_world_mesh(k: TickConsts, ball_pos, ball_vel, ball_ang_vel,
                             ball_vel_pre):
    """Ball against the full-fidelity world: the merged contact over the 4
    true planes and the 4 retained facet contacts, 10 solver passes (the
    averaged normal couples the normal and friction rows).  Returns (dvel
    uu, dang, push uu, touching, mean contact normal)."""
    mut = k.mut
    radius = mut.ball_radius
    break_gap = C.CONTACT_BREAK_FRAC * (radius + C.SPHERE_BOUND_EXTRA)
    zero = torch.zeros_like(ball_pos[0])
    num = zero
    navg = vzero(zero)
    max_depth = zero
    for p in world_planes(k):
        plane = k.planes[p]
        gap = _plane_dist(plane, ball_pos) - radius
        act = gap < break_gap
        actf = act.to(zero.dtype)
        num = num + actf
        navg = vadd(navg, vscale(cv.vconst(plane[:3], zero), actf))
        max_depth = torch.maximum(max_depth, torch.where(act, -gap, 0.0))
    for n, gap, occ in _facet_sphere_manifold(k, ball_pos, radius,
                                              break_gap):
        occf = occ.to(zero.dtype)
        num = num + occf
        navg = vadd(navg, vscale(n, occf))
        max_depth = torch.maximum(max_depth, torch.where(occ, -gap, 0.0))
    touching = num > 0
    navg = vscale(navg, 1.0 / torch.clamp(num, min=1.0))
    r_bt = vscale(navg, -radius * C.UU_TO_BT)
    s = 1.0 / (0.4 * mut.ball_mass * (radius * C.UU_TO_BT) ** 2)
    inv_iw = ((s, 0.0, 0.0), (0.0, s, 0.0), (0.0, 0.0, s))
    dv_bt, dw = _contact_vs_static(
        vscale(ball_vel, C.UU_TO_BT), ball_ang_vel, r_bt, navg, touching,
        1.0 / mut.ball_mass, inv_iw,
        max(mut.ball_world_restitution, C.WORLD_RESTITUTION),
        min(mut.ball_world_friction, C.WORLD_FRICTION),
        vscale(ball_vel_pre, C.UU_TO_BT), iterations=10)
    push = vscale(navg, torch.clamp(max_depth, min=0.0) * C.SOLVER_ERP2)
    return (vscale(dv_bt, C.BT_TO_UU), dw,
            vwhere(touching, push, vzero(zero)), touching, navg)


def _resolve_car_ball(k: TickConsts, st, ball_pos, ball_vel, ball_ang_vel,
                      tick_count, inv_iw, alive, cars_vel_pre, ball_vel_pre):
    """Closest-point car-ball rows (10 coupled normal+friction passes) and
    the psyonix extra impulse (Arena.cpp:304-331).  Ball quantities are
    (E,) and broadcast against the (C, E) car arrays.
    Returns (car_dv, car_dw, ball_dv, ball_dw, ball_cache_dv, hit_updates,
    touching (C, E))."""
    mut = k.mut
    he = k.half_extents
    box_center = vadd(st['pos'], cv.matvec(
        st['rot'], cv.vconst(k.hitbox_offset, st['pos'][0])))
    local = cv.mat_t_vec(st['rot'], vsub(ball_pos, box_center))
    clamped = tuple(torch.clamp(local[i], -he[i], he[i]) for i in range(3))
    closest = vadd(box_center, cv.matvec(st['rot'], clamped))
    delta = vsub(ball_pos, closest)
    dist = vnorm(delta)
    break_gap = C.CONTACT_BREAK_FRAC * float(np.linalg.norm(np.asarray(he)))
    touching = (dist < mut.ball_radius + break_gap) & alive
    n = vwhere(dist > 1e-6, vnormalize(delta),
               vnormalize(vsub(ball_pos, box_center)))

    car_inv_mass = 1.0 / mut.car_mass
    ball_inv_mass = 1.0 / mut.ball_mass
    s = 1.0 / (0.4 * mut.ball_mass * (mut.ball_radius * C.UU_TO_BT) ** 2)
    iw_ball = ((s, 0.0, 0.0), (0.0, s, 0.0), (0.0, 0.0, s))
    r_car = vscale(vsub(closest, st['pos']), C.UU_TO_BT)
    r_ball = vscale(vsub(closest, ball_pos), C.UU_TO_BT)
    imp_total = _car_ball_rows(st, touching, n, r_car, r_ball, ball_vel,
                               ball_ang_vel, inv_iw, iw_ball, car_inv_mass,
                               ball_inv_mass)

    def car_sum(vec):
        out = []
        for c in vec:
            acc = c[0]
            for i in range(1, c.shape[0]):
                acc = acc + c[i]
            out.append(acc)
        return tuple(out)

    zj = vzero(imp_total[0])
    ball_dv = vscale(car_sum(vwhere(touching, imp_total, zj)),
                     ball_inv_mass * C.BT_TO_UU)
    ball_dw = cv.matvec(iw_ball, car_sum(vwhere(
        touching, vcross(r_ball, imp_total), zj)))
    car_dv = vscale(vwhere(touching, cv.vneg(imp_total), zj),
                    car_inv_mass * C.BT_TO_UU)
    car_dw = cv.matvec(inv_iw, vwhere(
        touching, vcross(r_car, cv.vneg(imp_total)), zj))

    # psyonix extra impulse; callback-time state reads pre-force velocity
    can_extra = touching & (
        (tick_count > st['ball_hit_extra_impulse_tick'] + 1)
        | (st['ball_hit_extra_impulse_tick'] > tick_count))
    rel_pos = vsub(ball_pos, st['pos'])
    rel_v = vsub(ball_vel_pre, cars_vel_pre)
    rel_speed = torch.clamp(vnorm(rel_v),
                            max=C.BALL_CAR_EXTRA_IMPULSE_MAXDELTAVEL_UU)
    hit_dir = vnormalize((rel_pos[0], rel_pos[1],
                          rel_pos[2] * C.BALL_CAR_EXTRA_IMPULSE_Z_SCALE))
    fwd = cv.forward(st['rot'])
    fwd_adj = vscale(fwd, vdot(hit_dir, fwd)
                     * (1.0 - C.BALL_CAR_EXTRA_IMPULSE_FORWARD_SCALE))
    hit_dir = vnormalize(vsub(hit_dir, fwd_adj))
    factor = cv.curve(C.BALL_CAR_EXTRA_IMPULSE_FACTOR_CURVE, rel_speed)
    added_vel = vscale(hit_dir,
                       rel_speed * factor * mut.ball_hit_extra_force_scale)
    apply_extra = can_extra & (rel_speed > 0)
    ball_cache_dv = car_sum(vwhere(apply_extra, added_vel,
                                   vzero(rel_speed)))
    tick_b = torch.broadcast_to(tick_count, touching.shape)
    hit_updates = dict(
        ball_hit_valid=touching | st['ball_hit_valid'],
        ball_hit_rel_pos=vwhere(touching, vsub(closest, ball_pos),
                                st['ball_hit_rel_pos']),
        ball_hit_tick=torch.where(touching, tick_b, st['ball_hit_tick']),
        ball_hit_extra_impulse_tick=torch.where(
            can_extra, tick_b, st['ball_hit_extra_impulse_tick']),
        ball_hit_ball_pos=vwhere(touching, cv.vbroadcast(
            ball_pos, touching.shape), st['ball_hit_ball_pos']),
        ball_hit_extra_vel=vwhere(apply_extra, added_vel,
                                  vwhere(touching, vzero(rel_speed),
                                         st['ball_hit_extra_vel'])))
    return (car_dv, car_dw, ball_dv, ball_dw, ball_cache_dv, hit_updates,
            touching)


def _car_ball_rows(st, touching, n, r_car, r_ball, ball_vel, ball_ang_vel,
                   inv_iw, iw_ball, car_inv_mass, ball_inv_mass):
    """The car-ball contact rows where ``touching``: 10 coupled normal +
    friction passes between each car and the ball.  Returns the impulse on
    the ball (BT, per car); what it holds where not ``touching`` is not
    used."""
    v_car = vadd(vscale(st['vel'], C.UU_TO_BT), vcross(st['ang_vel'], r_car))
    v_ball = vadd(vscale(ball_vel, C.UU_TO_BT), vcross(ball_ang_vel, r_ball))
    rel_vel = vdot(n, vsub(v_ball, v_car))
    ta_car = cv.matvec(inv_iw, vcross(r_car, n))
    ta_ball = cv.matvec(iw_ball, vcross(r_ball, n))
    denom = (car_inv_mass + ball_inv_mass + vdot(n, vcross(ta_car, r_car))
             + vdot(n, vcross(ta_ball, r_ball)))
    rel_t0 = vsub(vsub(v_ball, v_car), vscale(n, rel_vel))
    t_len = vnorm(rel_t0)
    t_dir = vwhere(t_len > 1e-9,
                   vscale(rel_t0, 1.0 / torch.clamp(t_len, min=1e-9)),
                   vzero(t_len))
    tt_car = cv.matvec(inv_iw, vcross(r_car, t_dir))
    tt_ball = cv.matvec(iw_ball, vcross(r_ball, t_dir))
    t_denom = (car_inv_mass + ball_inv_mass
               + vdot(t_dir, vcross(tt_car, r_car))
               + vdot(t_dir, vcross(tt_ball, r_ball)))
    mu = C.CARBALL_COLLISION_FRICTION

    zero3 = vzero(rel_vel)
    dvb, dwb, dvc, dwc = zero3, zero3, zero3, zero3
    jn_acc = torch.zeros_like(rel_vel)
    jt_acc = torch.zeros_like(rel_vel)
    for _ in range(10):
        rv = vdot(n, vsub(vadd(v_ball, dvb, vcross(dwb, r_ball)),
                          vadd(v_car, dvc, vcross(dwc, r_car))))
        djn = -rv / torch.clamp(denom, min=1e-12)
        djn = torch.clamp(jn_acc + djn, min=0.0) - jn_acc
        djn = torch.where(touching, djn, 0.0)
        jn_acc = jn_acc + djn
        dimp = vscale(n, djn)
        dvb = vadd(dvb, vscale(dimp, ball_inv_mass))
        dwb = vadd(dwb, cv.matvec(iw_ball, vcross(r_ball, dimp)))
        dvc = vsub(dvc, vscale(dimp, car_inv_mass))
        dwc = vadd(dwc, cv.matvec(inv_iw, vcross(r_car, cv.vneg(dimp))))

        rt = vdot(t_dir, vsub(vadd(v_ball, dvb, vcross(dwb, r_ball)),
                              vadd(v_car, dvc, vcross(dwc, r_car))))
        djt = -rt / torch.clamp(t_denom, min=1e-12)
        djt = torch.clamp(jt_acc + djt, -mu * jn_acc, mu * jn_acc) - jt_acc
        djt = torch.where(touching, djt, 0.0)
        jt_acc = jt_acc + djt
        dimp = vscale(t_dir, djt)
        dvb = vadd(dvb, vscale(dimp, ball_inv_mass))
        dwb = vadd(dwb, cv.matvec(iw_ball, vcross(r_ball, dimp)))
        dvc = vsub(dvc, vscale(dimp, car_inv_mass))
        dwc = vadd(dwc, cv.matvec(inv_iw, vcross(r_car, cv.vneg(dimp))))

    return vadd(vscale(n, jn_acc), vscale(t_dir, jt_acc))


def _vslice(vec, i):
    return (vec[0][i], vec[1][i], vec[2][i])


def _mslice(M, i):
    return tuple(tuple(M[r][c][i] for c in range(3)) for r in range(3))


def _plane_space(n):
    """bullet btPlaneSpace1 first tangent."""
    nz_big = torch.abs(n[2]) > 0.70710678
    k1 = 1.0 / torch.sqrt(torch.clamp(n[1] * n[1] + n[2] * n[2], min=1e-12))
    t1 = (torch.zeros_like(k1), -n[2] * k1, n[1] * k1)
    k2 = 1.0 / torch.sqrt(torch.clamp(n[0] * n[0] + n[1] * n[1], min=1e-12))
    t2 = (-n[1] * k2, n[0] * k2, torch.zeros_like(k2))
    return vwhere(nz_big, t1, t2)


def _pgs_pair(v0, w0, v1, w1, r0s, r1s, n, act, inv_mass, I0, I1,
              rest_coef, mu, deps, dt, v0_pre, v1_pre, iterations=10):
    """One car pair's 4-row manifold: bullet-order sequential impulse
    (normal rows, then friction rows, per pass), restitution from the
    pre-force velocities, split-impulse positional rows.
    Returns (dv0, dw0, dv1, dw1, push0, push1, turn0, turn1)."""
    zero = torch.zeros_like(v0[0])
    jac_inv, rest, t_dir, t_jac_inv, push_tgt, actf = [], [], [], [], [], []
    for p in range(4):
        r0, r1 = r0s[p], r1s[p]
        ang0 = cv.matvec(I0, vcross(r0, n))
        ang1 = cv.matvec(I1, vcross(r1, n))
        denom = (2.0 * inv_mass + vdot(n, vcross(ang0, r0))
                 + vdot(n, vcross(ang1, r1)))
        jac_inv.append(1.0 / torch.clamp(denom, min=1e-12))
        rel_rest = vdot(n, vsub(vadd(v0_pre, vcross(w0, r0)),
                                vadd(v1_pre, vcross(w1, r1))))
        rest.append(_restitution_rhs(rel_rest, rest_coef))
        rel_v = vsub(vadd(v0, vcross(w0, r0)), vadd(v1, vcross(w1, r1)))
        tang = vsub(rel_v, vscale(n, vdot(n, rel_v)))
        t_len = vnorm(tang)
        td = vwhere(t_len > 1.49e-8,
                    vscale(tang, 1.0 / torch.clamp(t_len, min=1e-12)),
                    _plane_space(n))
        t_dir.append(td)
        f_ang0 = cv.matvec(I0, vcross(r0, td))
        f_ang1 = cv.matvec(I1, vcross(r1, td))
        t_den = (2.0 * inv_mass + vdot(td, vcross(f_ang0, r0))
                 + vdot(td, vcross(f_ang1, r1)))
        t_jac_inv.append(1.0 / torch.clamp(t_den, min=1e-12))
        push_tgt.append(torch.clamp(deps[p], min=0.0) * (C.SOLVER_ERP2 / dt))
        actf.append(act[p].to(zero.dtype))

    def _apply(acc, direction, r0, r1, dj):
        dv0, dw0, dv1, dw1 = acc
        imp = vscale(direction, dj)
        return (vadd(dv0, vscale(imp, inv_mass)),
                vadd(dw0, cv.matvec(I0, vcross(r0, imp))),
                vsub(dv1, vscale(imp, inv_mass)),
                vsub(dw1, cv.matvec(I1, vcross(r1, imp))))

    def _rel(acc, direction, r0, r1, b0, b1):
        dv0, dw0, dv1, dw1 = acc
        return vdot(direction, vsub(
            vadd(vadd(b0[0], dv0), vcross(vadd(b0[1], dw0), r0)),
            vadd(vadd(b1[0], dv1), vcross(vadd(b1[1], dw1), r1))))

    z3 = vzero(zero)
    acc = (z3, z3, z3, z3)
    j_n = [zero] * 4
    j_t = [zero] * 4
    for _ in range(iterations):
        for p in range(4):
            rel = _rel(acc, n, r0s[p], r1s[p], (v0, w0), (v1, w1))
            dj = (rest[p] - rel) * jac_inv[p]
            new_acc = torch.clamp(j_n[p] + dj, min=0.0)
            dj = (new_acc - j_n[p]) * actf[p]
            acc = _apply(acc, n, r0s[p], r1s[p], dj)
            j_n[p] = j_n[p] + dj
        for p in range(4):
            td = t_dir[p]
            rel = _rel(acc, td, r0s[p], r1s[p], (v0, w0), (v1, w1))
            dj = -rel * t_jac_inv[p]
            lim = mu * j_n[p]
            new_acc = torch.clamp(j_t[p] + dj, -lim, lim)
            dj = (new_acc - j_t[p]) * actf[p]
            dj = torch.where(j_n[p] > 0, dj, 0.0)
            acc = _apply(acc, td, r0s[p], r1s[p], dj)
            j_t[p] = j_t[p] + dj
    dv0, dw0, dv1, dw1 = acc

    pacc = (z3, z3, z3, z3)
    j_p = [zero] * 4
    for _ in range(iterations):
        for p in range(4):
            rel = _rel(pacc, n, r0s[p], r1s[p], (z3, z3), (z3, z3))
            dj = (push_tgt[p] - rel) * jac_inv[p]
            new_acc = torch.clamp(j_p[p] + dj, min=0.0)
            dj = (new_acc - j_p[p]) * actf[p]
            pacc = _apply(pacc, n, r0s[p], r1s[p], dj)
            j_p[p] = j_p[p] + dj
    pv0, pw0, pv1, pw1 = pacc
    te = C.SPLIT_IMPULSE_TURN_ERP * dt
    return (dv0, dw0, dv1, dw1, vscale(pv0, dt), vscale(pv1, dt),
            vscale(pw0, te), vscale(pw1, te))


def _car_car(k: TickConsts, st, inv_iw, alive, vel_pre):
    """Car pairs (static unordered loop): clamped dBoxBox manifold, 4-row
    two-body sequential impulse, split-impulse pushout, then bump/demo in
    both directions with the pre-force velocities.
    Returns (dvel, dang, push, turn, cache_dv (stacked Vecs), got_demoed,
    contact_updates, latches)."""
    from perfbench.reference.rlt.physics import box_box
    mut = k.mut
    Cn = k.num_cars
    inv_mass = 1.0 / mut.car_mass
    box_center = vadd(st['pos'], cv.matvec(
        st['rot'], cv.vconst(k.hitbox_offset, st['pos'][0])))
    zeroS = torch.zeros_like(st['pos'][0][0])
    falseS = torch.zeros_like(st['is_demoed'][0])
    z3 = vzero(zeroS)
    dvel = [z3] * Cn
    dang = [z3] * Cn
    push = [z3] * Cn
    turn = [z3] * Cn
    cache_dv = [z3] * Cn
    got_demoed = [falseS] * Cn
    bumped_any = [falseS] * Cn
    bumped_id = [torch.zeros_like(st['car_contact_other_id'][0])] * Cn
    lat = {f: [falseS] * Cn for f in pack.LATCHES}
    ups = cv.up(st['rot'])

    for i in range(Cn):
        for j in range(i + 1, Cn):
            Ri = _mslice(st['rot'], i)
            Rj = _mslice(st['rot'], j)
            mfc = box_box.box_box_clamped_components(
                vscale(_vslice(box_center, i), C.UU_TO_BT), Ri, k.he_eff_bt,
                vscale(_vslice(box_center, j), C.UU_TO_BT), Rj, k.he_eff_bt)
            pair_alive = alive[i] & alive[j]
            overlap = mfc['overlap'] & pair_alive
            act = [a & pair_alive for a in mfc['active']]
            n_on_b = cv.vneg(mfc['normal'])   # +impulse on car i
            pos_i_bt = vscale(_vslice(st['pos'], i), C.UU_TO_BT)
            pos_j_bt = vscale(_vslice(st['pos'], j), C.UU_TO_BT)
            posB = mfc['points']
            posA = [vadd(posB[p], vscale(mfc['normal'], mfc['depth'][p]))
                    for p in range(4)]
            r0s = [vsub(posA[p], pos_i_bt) for p in range(4)]
            r1s = [vsub(posB[p], pos_j_bt) for p in range(4)]
            dv0, dw0, dv1, dw1, push0, push1, turn0, turn1 = _pgs_pair(
                vscale(_vslice(st['vel'], i), C.UU_TO_BT),
                _vslice(st['ang_vel'], i),
                vscale(_vslice(st['vel'], j), C.UU_TO_BT),
                _vslice(st['ang_vel'], j),
                r0s, r1s, n_on_b, act, inv_mass,
                _mslice(inv_iw, i), _mslice(inv_iw, j),
                C.CARCAR_COLLISION_RESTITUTION, C.CARCAR_COLLISION_FRICTION,
                mfc['depth'], k.dt,
                vscale(_vslice(vel_pre, i), C.UU_TO_BT),
                vscale(_vslice(vel_pre, j), C.UU_TO_BT))
            dvel[i] = vadd(dvel[i], vscale(dv0, C.BT_TO_UU))
            dvel[j] = vadd(dvel[j], vscale(dv1, C.BT_TO_UU))
            dang[i] = vadd(dang[i], dw0)
            dang[j] = vadd(dang[j], dw1)
            push[i] = vadd(push[i], vscale(push0, C.BT_TO_UU))
            push[j] = vadd(push[j], vscale(push1, C.BT_TO_UU))
            turn[i] = vadd(turn[i], turn0)
            turn[j] = vadd(turn[j], turn1)

            # contact points in each body's frame for the bumper test
            hwb = {i: falseS, j: falseS}
            for p in range(4):
                lp_i = cv.mat_t_vec(Ri, vsub(vscale(posA[p], C.BT_TO_UU),
                                             _vslice(st['pos'], i)))
                lp_j = cv.mat_t_vec(Rj, vsub(vscale(posB[p], C.BT_TO_UU),
                                             _vslice(st['pos'], j)))
                fwd = C.BUMP_MIN_FORWARD_DIST
                hwb[i] = hwb[i] | (act[p] & (lp_i[0] > fwd))
                hwb[j] = hwb[j] | (act[p] & (lp_j[0] > fwd))

            for a, b in ((i, j), (j, i)):
                pos_a = _vslice(st['pos'], a)
                pos_b = _vslice(st['pos'], b)
                va = _vslice(vel_pre, a)
                vb = _vslice(vel_pre, b)
                delta_pos = vsub(pos_b, pos_a)
                going_towards = vdot(va, delta_pos) > 0
                vel_dir = vnormalize(va)
                speed_towards = vdot(va, vnormalize(delta_pos))
                other_away = vdot(vb, vel_dir)
                in_cooldown = (st['car_contact_other_id'][a] == (b + 1)) & (
                    st['car_contact_cooldown'][a] > 0)
                bump = (overlap & going_towards & ~in_cooldown
                        & (speed_towards > other_away) & hwb[a])
                if mut.demo_mode == "ON_CONTACT":
                    is_demo = bump
                elif mut.demo_mode == "DISABLED":
                    is_demo = falseS
                else:
                    is_demo = bump & st['is_supersonic'][a]
                if not mut.enable_team_demos and k.teams[a] == k.teams[b]:
                    is_demo = falseS
                plain_bump = bump & ~is_demo
                ground_hit = st['is_on_ground'][b]
                base_scale = torch.where(
                    ground_hit,
                    cv.curve(C.BUMP_VEL_AMOUNT_GROUND_CURVE, speed_towards),
                    cv.curve(C.BUMP_VEL_AMOUNT_AIR_CURVE, speed_towards))
                hit_up_dir = vwhere(ground_hit, _vslice(ups, b),
                                    cv.vconst((0.0, 0.0, 1.0), zeroS))
                bump_imp = vadd(
                    vscale(vel_dir, base_scale),
                    vscale(hit_up_dir,
                           cv.curve(C.BUMP_UPWARD_VEL_AMOUNT_CURVE,
                                    speed_towards) * mut.bump_force_scale))
                cache_dv[b] = vadd(cache_dv[b],
                                   vwhere(plain_bump, bump_imp, z3))
                got_demoed[b] = got_demoed[b] | is_demo
                bumped_any[a] = bumped_any[a] | bump
                bumped_id[a] = torch.maximum(
                    bumped_id[a], torch.where(bump, b + 1, 0).to(torch.int32))
                if k.teams[a] != k.teams[b]:
                    lat['step_bump'][a] = lat['step_bump'][a] | bump
                    lat['step_bumped'][b] = lat['step_bumped'][b] | bump
                    lat['step_demo'][a] = lat['step_demo'][a] | is_demo
                    lat['step_demoed'][b] = lat['step_demoed'][b] | is_demo

    def stack_vec(lst):
        return tuple(torch.stack([v[c] for v in lst], 0) for c in range(3))

    any_b = torch.stack(bumped_any, 0)
    contact_updates = dict(
        car_contact_other_id=torch.where(any_b, torch.stack(bumped_id, 0),
                                         st['car_contact_other_id']),
        car_contact_cooldown=torch.where(any_b, mut.bump_cooldown_time,
                                         st['car_contact_cooldown']))
    latches = {f: torch.stack(v, 0) for f, v in lat.items()}
    return (stack_vec(dvel), stack_vec(dang), stack_vec(push),
            stack_vec(turn), stack_vec(cache_dv), torch.stack(got_demoed, 0),
            contact_updates, latches)


def _pads_pickup(k: TickConsts, st, pads_active, pads_cooldown,
                 pads_locked, alive):
    """Boost pad pickup with the lock hysteresis (BoostPad.cpp:62-105): the
    previously locked car keeps the pad via pad-box vs car-AABB, others need
    the cylinder test; the LAST colliding car takes lock and pickup
    (Arena.cpp:783-796).  Returns (active, cooldown, locked, new_boost)."""
    mut = k.mut
    Cn = k.num_cars
    x, y, z = st['pos']
    he_m = tuple(v * 50.0 for v in k.he_eff_bt)
    box_center = vadd(st['pos'], cv.matvec(
        st['rot'], cv.vconst(k.hitbox_offset, st['pos'][0])))
    aabb_half = tuple(
        torch.abs(st['rot'][r][0]) * he_m[0]
        + torch.abs(st['rot'][r][1]) * he_m[1]
        + torch.abs(st['rot'][r][2]) * he_m[2] for r in range(3))
    gained = torch.zeros_like(st['boost'])
    new_active, new_cd, new_locked = [], [], []
    for p in range(len(k.pad_locs)):
        lx, ly, lz = k.pad_locs[p]
        big = k.pad_is_big[p]
        rad = C.BoostPads.CYL_RAD_BIG if big else C.BoostPads.CYL_RAD_SMALL
        box_rad = C.BoostPads.BOX_RAD_BIG if big else C.BoostPads.BOX_RAD_SMALL
        d2 = (x - lx) ** 2 + (y - ly) ** 2
        cyl_hit = (d2 < rad * rad) & (torch.abs(z - lz)
                                      < C.BoostPads.CYL_HEIGHT)
        aabb_hit = (
            (lx + box_rad > box_center[0] - aabb_half[0])
            & (lx - box_rad < box_center[0] + aabb_half[0])
            & (ly + box_rad > box_center[1] - aabb_half[1])
            & (ly - box_rad < box_center[1] + aabb_half[1])
            & (lz + C.BoostPads.BOX_HEIGHT > box_center[2] - aabb_half[2])
            & (lz < box_center[2] + aabb_half[2]))
        any_collide = None
        winner = torch.zeros_like(pads_locked[p])
        for c in range(Cn):
            lock_c = pads_locked[p] == (c + 1)
            col_c = torch.where(lock_c, aabb_hit[c], cyl_hit[c]) & alive[c]
            any_collide = col_c if any_collide is None else any_collide | col_c
            winner = torch.where(col_c, c + 1, winner).to(torch.int32)
        pickup = any_collide & pads_active[p]
        amount = (C.BoostPads.BOOST_AMOUNT_BIG if big
                  else C.BoostPads.BOOST_AMOUNT_SMALL)
        win_rows = torch.stack([pickup & (winner == c + 1)
                                for c in range(Cn)], 0)
        gained = gained + win_rows.to(gained.dtype) * amount
        cd_new = (mut.boost_pad_cooldown_big if big
                  else mut.boost_pad_cooldown_small)
        new_active.append(pads_active[p] & ~pickup)
        new_cd.append(torch.where(pickup, cd_new, pads_cooldown[p]))
        new_locked.append(winner)
    new_boost = torch.clamp(st['boost'] + gained, max=C.BOOST_MAX)
    return (torch.stack(new_active, 0), torch.stack(new_cd, 0),
            torch.stack(new_locked, 0), new_boost)


def _respawn(k: TickConsts, st, mask, respawn_idx):
    """Car::Respawn (Car.cpp:43-56) for the cars in ``mask`` at the drawn
    respawn table row, mirrored for orange."""
    mut = k.mut
    zero = torch.zeros_like(st['pos'][0])
    sx = sy = syaw = zero
    for kk, (tx, ty, tyaw) in enumerate(k.respawn_table):
        sel = respawn_idx == kk
        sx = torch.where(sel, tx, sx)
        sy = torch.where(sel, ty, sy)
        syaw = torch.where(sel, tyaw, syaw)
    team_sign = _slot_const([1.0 if t == 0 else -1.0 for t in k.teams], zero)
    yaw_off = _slot_const([0.0 if t == 0 else np.pi for t in k.teams], zero)
    pos = (sx, sy * team_sign, torch.full_like(zero, C.CAR_RESPAWN_Z))
    rot = cv.yaw_mat(syaw + yaw_off)

    def w(field, new):
        return torch.where(mask, new, field)

    st = dict(st)
    st['pos'] = vwhere(mask, pos, st['pos'])
    st['rot'] = cv.mwhere(mask, rot, st['rot'])
    st['vel'] = vwhere(mask, vzero(zero), st['vel'])
    st['ang_vel'] = vwhere(mask, vzero(zero), st['ang_vel'])
    st['is_on_ground'] = st['is_on_ground'] | mask
    st['wheels_with_contact'] = [c & ~mask for c in st['wheels_with_contact']]
    for f in ('has_jumped', 'has_double_jumped', 'has_flipped', 'is_flipping',
              'is_jumping', 'is_supersonic', 'is_auto_flipping',
              'has_world_contact', 'is_demoed'):
        st[f] = st[f] & ~mask
    st['flip_rel_torque'] = vwhere(mask, vzero(zero), st['flip_rel_torque'])
    st['world_contact_normal'] = vwhere(mask, vzero(zero),
                                        st['world_contact_normal'])
    for f in ('jump_time', 'flip_time', 'air_time', 'air_time_since_jump',
              'time_spent_boosting', 'supersonic_time', 'handbrake_val',
              'auto_flip_timer', 'auto_flip_torque_scale',
              'car_contact_cooldown', 'demo_respawn_timer'):
        st[f] = w(st[f], zero)
    st['boost'] = w(st['boost'], mut.car_spawn_boost_amount)
    st['car_contact_other_id'] = w(st['car_contact_other_id'],
                                   torch.zeros_like(
                                       st['car_contact_other_id']))
    return st


# ---------------------------------------------------------------------------
# The tick and the multi-tick step

# Per-car state restored from the tick-start snapshot for cars that were
# demolished at tick start (incl. the wheel drive sub-dict 'wc').
CAR_KEYS = (
    'pos', 'rot', 'vel', 'ang_vel', 'is_on_ground', 'wheels_with_contact',
    'has_jumped', 'has_double_jumped', 'has_flipped', 'flip_rel_torque',
    'jump_time', 'flip_time', 'is_flipping', 'is_jumping', 'air_time',
    'air_time_since_jump', 'boost', 'time_spent_boosting', 'is_supersonic',
    'supersonic_time', 'handbrake_val', 'is_auto_flipping', 'auto_flip_timer',
    'auto_flip_torque_scale', 'has_world_contact', 'world_contact_normal',
    'car_contact_other_id', 'car_contact_cooldown', 'is_demoed',
    'demo_respawn_timer', 'ball_hit_valid', 'ball_hit_rel_pos',
    'ball_hit_tick', 'ball_hit_extra_impulse_tick', 'ball_hit_ball_pos',
    'ball_hit_extra_vel', 'last_controls', 'controls', 'wc')


def _clamp_controls(controls):
    out = [torch.clamp(c, -1.0, 1.0) for c in controls[:5]]
    out += [(c > 0).to(c.dtype) for c in controls[5:]]
    return tuple(out)


def _select_tree(mask, a, b):
    if isinstance(a, dict):
        return {key: _select_tree(mask, a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_select_tree(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask, a, b)


def tick(k: TickConsts, st: dict, respawn_idx) -> dict:
    """One 1/120 s physics tick on the component state dict."""
    mut, dt, Cn = k.mut, k.dt, k.num_cars
    st = dict(st)
    controls = _clamp_controls(st['controls'])
    st['controls'] = controls

    # demo / respawn (Car.cpp:68-87)
    demo_timer = torch.where(
        st['is_demoed'], torch.clamp(st['demo_respawn_timer'] - dt, min=0.0),
        st['demo_respawn_timer'])
    respawn_now = st['is_demoed'] & (demo_timer == 0.0)
    st['demo_respawn_timer'] = demo_timer
    st = _respawn(k, st, respawn_now, respawn_idx)
    alive = ~st['is_demoed']
    frozen = {key: st[key] for key in CAR_KEYS}

    inv_iw = cv.inv_inertia_world(st['rot'], k.inv_i_local)

    # updateVehicleFirst: raycasts + stale friction impulses
    rc = _wheel_raycasts(k, st, inv_iw)
    wheel_impulses = _calc_friction_impulses(k, st, rc, st['wc'], inv_iw)
    num_contact = (rc['hit'][0].to(torch.int32) + rc['hit'][1].to(torch.int32)
                   + rc['hit'][2].to(torch.int32)
                   + rc['hit'][3].to(torch.int32))
    st['wheels_with_contact'] = list(rc['hit'])
    st['is_on_ground'] = num_contact >= 3

    jump_pressed = (controls[JUMP] > 0) & ~(st['last_controls'][JUMP] > 0)
    fwd_speed = vdot(st['vel'], cv.forward(st['rot']))

    new_wc, hb_val, sticky_accel = _update_wheels(
        k, st, rc, st['wc'], controls, fwd_speed, num_contact)
    st['handbrake_val'] = hb_val
    st['wc'] = new_wc

    air_mask = num_contact < 3
    zero_wheels = num_contact == 0
    air_ang_accel, air_accel, is_flipping = _update_air_torque(
        k, st, controls, air_mask, zero_wheels)
    st['is_flipping'] = is_flipping & air_mask

    jump_updates, jump_dv, jump_accel = _update_jump(k, st, controls,
                                                     jump_pressed)
    st['vel'] = vadd(st['vel'], jump_dv)
    st.update(jump_updates)

    af_updates, af_dv, af_dw = _update_auto_flip(k, st, controls,
                                                 jump_pressed)
    st['vel'] = vadd(st['vel'], af_dv)
    st['ang_vel'] = vadd(st['ang_vel'], af_dw)
    st.update(af_updates)

    dj_updates, dj_dv, zdamp_maybe, zdamp_always = \
        _update_double_jump_or_flip(k, st, controls, jump_pressed, fwd_speed,
                                    st['is_jumping'], st['has_jumped'],
                                    st['is_flipping'])
    vel = vadd(st['vel'], dj_dv)
    do_damp = zdamp_always | (zdamp_maybe & (vel[2] < 0))
    damp_factor = (1.0 - C.FLIP_Z_DAMP_120) ** (dt * 120.0)
    st['vel'] = (vel[0], vel[1],
                 vel[2] * torch.where(do_damp, damp_factor, 1.0))
    st.update(dj_updates)

    ar_cond = (controls[THROTTLE] != 0) & (
        ((num_contact > 0) & (num_contact < 4)) | st['has_world_contact'])
    ar_accel, ar_ang_accel = _update_auto_roll(k, st, rc, num_contact)
    ar_accel = vwhere(ar_cond, ar_accel, vzero(ar_accel[0]))
    ar_ang_accel = vwhere(ar_cond, ar_ang_accel, vzero(ar_ang_accel[0]))
    st['has_world_contact'] = torch.zeros_like(alive)

    # updateVehicleSecond: suspension + friction
    st['vel'], st['ang_vel'] = _apply_suspension(k, st, rc, inv_iw)
    st['vel'], st['ang_vel'] = _apply_friction_impulses(
        k, st, rc, wheel_impulses, inv_iw)

    boost_updates, boost_accel = _update_boost(k, st, controls)
    st.update(boost_updates)

    pads_cd = torch.clamp(st['pads_cooldown'] - dt, min=0.0)
    st['pads_cooldown'] = pads_cd
    st['pads_active'] = pads_cd == 0.0

    # ---- world step; restitution and callbacks read pre-force velocities
    gravity = (0.0, 0.0, mut.gravity_z)
    cars_vel_pre = st['vel']
    cars_ang_vel_pre = st['ang_vel']
    total_accel = vadd(cv.vconst(gravity, sticky_accel[0]), sticky_accel,
                       air_accel, jump_accel, ar_accel, boost_accel)
    total_ang_accel = vadd(air_ang_accel, ar_ang_accel)
    st['vel'] = vadd(st['vel'], vscale(total_accel, dt))
    st['ang_vel'] = vadd(st['ang_vel'], vscale(total_ang_accel, dt))

    # ball pre-tick: heatseeker steering (Ball.cpp:153-200)
    if k.game_mode == "heatseeker":
        st = _hs_steer(k, st)

    # ball: sleeping + gravity + drag
    bvel, bang = st['ball_vel'], st['ball_ang_vel']
    ball_awake = (vnorm(bvel) > 0) | (vnorm(bang) > 0)
    ball_vel_pre = bvel
    drag = (1.0 - mut.ball_drag) ** dt
    st['ball_vel'] = vwhere(
        ball_awake,
        vscale(vadd(bvel, vscale(cv.vconst(gravity, bvel[0]), dt)), drag),
        bvel)

    cw_turn = None
    if k.use_mesh:
        cw_dv, cw_dw, cw_push, cw_turn, cw_contact, cw_normal = \
            _resolve_car_world_mesh(k, st, inv_iw, cars_vel_pre,
                                    cars_ang_vel_pre)
    else:
        cw_dv, cw_dw, cw_push, cw_contact, cw_normal = _resolve_car_world(
            k, st, inv_iw, cars_vel_pre, cars_ang_vel_pre)
    st['vel'] = vadd(st['vel'], cw_dv)
    st['ang_vel'] = vadd(st['ang_vel'], cw_dw)
    st['has_world_contact'] = cw_contact
    st['world_contact_normal'] = vwhere(cw_contact, cw_normal,
                                        st['world_contact_normal'])

    cb_car_dv, cb_car_dw, cb_ball_dv, cb_ball_dw, ball_cache_dv, \
        hit_updates, ball_touched = _resolve_car_ball(
            k, st, st['ball_pos'], st['ball_vel'], st['ball_ang_vel'],
            st['tick_count'], inv_iw, alive, cars_vel_pre, ball_vel_pre)
    st['vel'] = vadd(st['vel'], cb_car_dv)
    st['ang_vel'] = vadd(st['ang_vel'], cb_car_dw)
    st.update(hit_updates)
    st['ball_vel'] = vadd(st['ball_vel'], cb_ball_dv)
    st['ball_ang_vel'] = vadd(st['ball_ang_vel'], cb_ball_dw)

    # Ball::_OnHit: heatseeker retargeting, once per touching car
    if k.game_mode == "heatseeker":
        st = _hs_on_hit(k, st, [ball_touched[c] & alive[c]
                                for c in range(Cn)])

    if k.game_mode == "snowday":
        bw_dv, bw_dw, bw_push, bw_touch, bw_navg = \
            _resolve_ball_world_snowday(
                k, st['ball_pos'], st['ball_vel'], st['ball_ang_vel'],
                st['ball_rot'], ball_vel_pre)
    else:
        resolve_ball = _resolve_ball_world_mesh if k.use_mesh \
            else _resolve_ball_world
        bw_dv, bw_dw, bw_push, bw_touch, bw_navg = resolve_ball(
            k, st['ball_pos'], st['ball_vel'], st['ball_ang_vel'],
            ball_vel_pre)
    st['ball_vel'] = vadd(st['ball_vel'], bw_dv)
    st['ball_ang_vel'] = vadd(st['ball_ang_vel'], bw_dw)

    # Ball::_OnWorldCollision: the heatseeker back-wall flip; the snowday
    # puck's ground stick
    if k.game_mode == "heatseeker":
        st, hs_cache = _hs_wall_bounce(k, st, bw_touch, bw_navg)
        ball_cache_dv = vadd(ball_cache_dv, hs_cache)
    elif k.game_mode == "snowday":
        stick = puck_consts(mut, dt)[3]
        st['ball_vel'] = vwhere(
            bw_touch, vsub(st['ball_vel'], vscale(bw_navg, stick)),
            st['ball_vel'])

    latches = None
    cc_push = cc_turn = None
    cc_cache_dv = vzero(st['vel'][0])
    if Cn > 1:
        cc_dv, cc_dw, cc_push, cc_turn, cc_cache_dv, got_demoed, \
            cc_updates, latches = _car_car(k, st, inv_iw, alive,
                                           cars_vel_pre)
        st['vel'] = vadd(st['vel'], cc_dv)
        st['ang_vel'] = vadd(st['ang_vel'], cc_dw)
        st.update(cc_updates)
        st['is_demoed'] = st['is_demoed'] | got_demoed
        st['demo_respawn_timer'] = torch.where(
            got_demoed, mut.respawn_delay, st['demo_respawn_timer'])

    # integrate transforms
    pos = vadd(st['pos'], vscale(st['vel'], dt), cw_push)
    st['pos'] = pos if cc_push is None else vadd(pos, cc_push)
    st['rot'] = cv.integrate_rotation(st['rot'], st['ang_vel'], dt)
    if cw_turn is not None:
        # split-impulse turn pseudo-velocity of the world contacts
        st['rot'] = cv.integrate_rotation(st['rot'], cw_turn, 1.0)
    if cc_turn is not None:
        st['rot'] = cv.integrate_rotation(st['rot'], cc_turn, 1.0)
    ball_awake = (vnorm(st['ball_vel']) > 0) | (vnorm(st['ball_ang_vel']) > 0)
    st['ball_pos'] = vwhere(
        ball_awake, vadd(st['ball_pos'], vscale(st['ball_vel'], dt), bw_push),
        st['ball_pos'])
    st['ball_rot'] = cv.mwhere(
        ball_awake,
        cv.integrate_rotation(st['ball_rot'], st['ball_ang_vel'], dt),
        st['ball_rot'])

    # post-tick + finish
    speed_sq = cv.vnorm2(st['vel'])
    maintain = st['is_supersonic'] & (
        st['supersonic_time'] < C.SUPERSONIC_MAINTAIN_MAX_TIME)
    thresh = torch.where(maintain, C.SUPERSONIC_MAINTAIN_MIN_SPEED,
                         C.SUPERSONIC_START_SPEED)
    is_ss = speed_sq >= thresh * thresh
    st['is_supersonic'] = is_ss
    st['supersonic_time'] = torch.where(is_ss, st['supersonic_time'] + dt,
                                        0.0)
    st['car_contact_cooldown'] = torch.clamp(
        st['car_contact_cooldown'] - dt, min=0.0)
    st['last_controls'] = controls
    st['vel'] = cv.vclamp_norm(vadd(st['vel'], cc_cache_dv), C.CAR_MAX_SPEED)
    st['ang_vel'] = cv.vclamp_norm(st['ang_vel'], C.CAR_MAX_ANG_SPEED)
    st['ball_vel'] = cv.vclamp_norm(vadd(st['ball_vel'], ball_cache_dv),
                                    mut.ball_max_speed)
    st['ball_ang_vel'] = cv.vclamp_norm(st['ball_ang_vel'],
                                        C.BALL_MAX_ANG_SPEED)

    # cars demoed at tick start stay frozen
    st.update(_select_tree(alive, {key: st[key] for key in CAR_KEYS},
                           frozen))

    pa, pc, pl, new_boost = _pads_pickup(k, st, st['pads_active'],
                                         st['pads_cooldown'],
                                         st['pads_locked'], alive)
    st['pads_active'], st['pads_cooldown'] = pa, pc
    st['pads_locked'] = pl
    st['boost'] = new_boost

    goal = torch.abs(st['ball_pos'][1]) > (mut.goal_base_threshold_y
                                           + mut.ball_radius)
    st['goal_scored'] = st['goal_scored'] | goal
    if latches is not None:
        for f in pack.LATCHES:
            st[f] = st[f] | latches[f]
    st['tick_count'] = st['tick_count'] + 1
    return st


# ---------------------------------------------------------------------------
# Heatseeker (Ball.cpp:153-246)

def _wrap(x, minmax):
    """Math::WrapNormalizeFloat (Math.cpp:66-73); fmod is C's fmodf."""
    r = torch.fmod(x, minmax * 2)
    r = torch.where(r > minmax, r - minmax * 2, r)
    return torch.where(r < -minmax, r + minmax * 2, r)


def _round_angle_ue3(ang):
    """Math::RoundAngleUE3 (Math.cpp:75-88): the UE3 rotator quantum
    4*pi/32768.  The cast truncates toward zero and ``>>`` shifts the sign
    in, as C's int conversion and signed shift do."""
    to_ints = float(1 << 15) / np.pi
    back = (1.0 / to_ints) * 4.0
    r = (ang * to_ints).to(torch.int32) >> 2
    return (r & (0x4000 - 1)).to(torch.float32) * back


def _hs_steer(k: TickConsts, st):
    """Ball::_PreTickUpdate, heatseeker (Ball.cpp:153-200): turn the
    velocity toward the target goal point, quantise the angles, blend the
    speed toward the target speed; only while seeking."""
    HS = C.Heatseeker
    dt = k.dt
    ytd, tspeed, tsince = st['ball_hs']
    active = ytd != 0
    vel = st['ball_vel']
    speed = vnorm(vel)
    d2 = torch.sqrt(vel[0] * vel[0] + vel[1] * vel[1])
    v_yaw = torch.atan2(vel[1], vel[0])
    v_pitch = torch.atan2(vel[2], d2)
    gx = 0.0 - st['ball_pos'][0]      # +0 at x = 0, as the reference
    gy = HS.TARGET_Y * ytd - st['ball_pos'][1]
    gz = HS.TARGET_Z - st['ball_pos'][2]
    g_yaw = torch.atan2(gy, gx)
    g_pitch = torch.atan2(gz, torch.sqrt(gx * gx + gy * gy))
    d_yaw = _wrap(g_yaw - v_yaw, np.pi)
    d_pitch = _wrap(g_pitch - v_pitch, np.pi / 2)
    f = (speed / HS.MAX_SPEED) * dt
    new_yaw = _wrap(v_yaw + d_yaw * f * HS.HORIZONTAL_BLEND, np.pi)
    new_pitch = torch.clamp(
        _wrap(v_pitch + d_pitch * f * HS.VERTICAL_BLEND, np.pi / 2),
        -HS.MAX_TURN_PITCH, HS.MAX_TURN_PITCH)
    new_yaw = _round_angle_ue3(new_yaw)
    new_pitch = _round_angle_ue3(new_pitch)
    new_speed = speed + (tspeed - speed) * HS.SPEED_BLEND
    cp, sp = torch.cos(new_pitch), torch.sin(new_pitch)
    new_vel = (cp * torch.cos(new_yaw) * new_speed,
               cp * torch.sin(new_yaw) * new_speed, sp * new_speed)
    st = dict(st)
    st['ball_vel'] = vwhere(active, new_vel, vel)
    st['ball_hs'] = (ytd, tspeed, torch.where(active, tsince + dt, tsince))
    return st


def _hs_on_hit(k: TickConsts, st, touched):
    """Ball::_OnHit, heatseeker (Ball.cpp:203-216), once per touching car
    in index order, each call reading the previous one's writes: the
    toucher's team sets the target goal, and the target speed rises when
    the target flips after the minimum interval (or from idle)."""
    HS = C.Heatseeker
    ytd, tspeed, tsince = st['ball_hs']
    for c in range(k.num_cars):
        t = touched[c]
        d = 1.0 if k.teams[c] == 0 else -1.0
        can_increase = (tsince > HS.MIN_SPEEDUP_INTERVAL) | (ytd == 0)
        sp = t & can_increase & (ytd != d)
        ytd = torch.where(t, d, ytd)
        tspeed = torch.where(
            sp, torch.clamp(tspeed + HS.TARGET_SPEED_INCREMENT,
                            max=HS.MAX_SPEED), tspeed)
        tsince = torch.where(sp, 0.0, tsince)
    st = dict(st)
    st['ball_hs'] = (ytd, tspeed, tsince)
    return st


def _hs_wall_bounce(k: TickConsts, st, touching, navg):
    """Ball::_OnWorldCollision, heatseeker (Ball.cpp:218-246): a world
    contact deep in the target's back wall flips the target and adds a
    goal-ward bounce.  Returns (st, velocity cache addition)."""
    HS = C.Heatseeker
    ytd, tspeed, tsince = st['ball_hs']
    pos = st['ball_pos']
    flip = (touching & (ytd != 0)
            & (navg[1] * ytd <= -HS.WALL_BOUNCE_CHANGE_Y_NORMAL)
            & (pos[1] * ytd >= C.ARENA_EXTENT_Y
               - HS.WALL_BOUNCE_CHANGE_Y_THRESH))
    new_ytd = torch.where(flip, -ytd, ytd)
    to_goal = vnormalize((-pos[0], HS.TARGET_Y * new_ytd - pos[1],
                          HS.TARGET_Z - pos[2]))
    up = HS.WALL_BOUNCE_UP_FRAC
    mag = vnorm(st['ball_vel']) * HS.WALL_BOUNCE_FORCE_SCALE
    bounce = (to_goal[0] * (1.0 - up) * mag, to_goal[1] * (1.0 - up) * mag,
              (to_goal[2] * (1.0 - up) + up) * mag)
    st = dict(st)
    st['ball_hs'] = (new_ytd, tspeed, tsince)
    return st, vwhere(flip, bounce, vzero(mag))


def step(k: TickConsts, st: dict, new_controls, respawn_idx,
         tick_skip: int = 8, action_delay: int = 7) -> dict:
    """Multi-tick env step with action delay.  ``new_controls``: tuple of 8
    (C, E) tensors, applied from tick ``action_delay``; ``respawn_idx``:
    (C, E) int32, one respawn draw per car for this step."""
    st = dict(st)
    st['goal_scored'] = torch.zeros_like(st['goal_scored'])
    for f in pack.LATCHES:
        st[f] = torch.zeros_like(st[f])
    for i in range(tick_skip):
        if i == action_delay:
            st['controls'] = tuple(new_controls)
        st = tick(k, st, respawn_idx)
    return st


def arena_step_reference(phys, new_controls, respawn_idx, consts,
                         tick_skip: int = 8, action_delay: int = 7):
    """The plain version of the kernel on a batched PhysicsState:
    ``new_controls`` (E, C, 8) float32, ``respawn_idx`` (E, C) int32,
    ``consts`` from make_consts.  Returns the next PhysicsState."""
    d = pack.to_components(phys)
    nc = tuple(new_controls[..., c].transpose(0, 1) for c in range(8))
    out = step(consts, d, nc, respawn_idx.transpose(0, 1), tick_skip,
               action_delay)
    return pack.from_components(out)
