"""Car dynamics of the portable physics engine: the suspension raycast
vehicle and the control state machines, batched over arenas.

Branch-free re-derivation of the reference car physics:
  * ``btVehicleRL`` suspension/friction (reference:
    RocketSim/src/Sim/btVehicleRL/btVehicleRL.cpp)
  * ``Car::_PreTickUpdate`` and its ``_Update*`` helpers (reference:
    RocketSim/src/Sim/Car/Car.cpp:58-833)

Every car field is ``(N, C, ...)``: an arena axis, then a car axis; every
reference branch is a masked ``torch.where``.  One quirk kept: the wheel
engine/brake/steer/friction values used for this tick's friction impulses
are the ones computed on the PREVIOUS tick (the reference calls
updateVehicleFirst *before* _UpdateWheels, Car.cpp:90 vs :109), so those
live in ``WheelControlsState``.

Units: state is uu and seconds; impulse math that involves the inertia
tensor is in BT units (1 bt = 50 uu), as in the reference solver.  The 3x3
products are elementwise multiply-and-sum (``maths.rotate``), never a
matmul.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.physics import arena_geom as geom
from reinforcement_learning_torch.physics import formulas
from reinforcement_learning_torch.physics.state import (
    BOOST, HANDBRAKE, JUMP, PITCH, ROLL, STEER, THROTTLE, YAW, CarConfig,
    CarsState, MutatorConfig)

# Compacted candidate width of the mesh raycast (the JAX package's
# contacts.MESH_COMPACT_K_RAY)
MESH_COMPACT_K_RAY = 12


@dataclasses.dataclass
class WheelControlsState:
    """Wheel drive values persisted across ticks (see module docstring)."""
    steer_angle: torch.Tensor    # (C,) front-wheel steering angle
    engine_force: torch.Tensor   # (C,) BT units
    brake: torch.Tensor          # (C,) BT units
    lat_friction: torch.Tensor   # (C, 4)
    long_friction: torch.Tensor  # (C, 4)

    @staticmethod
    def make(num_cars: int, batch=(), device=None) -> "WheelControlsState":
        z = lambda *s: torch.zeros(tuple(batch) + (num_cars,) + s,  # noqa
                                   device=device)
        # btWheelInfoRL starts m_latFriction/m_longFriction at zero
        # (btVehicleRL.h:16): a wheel's first contact tick has no friction
        return WheelControlsState(steer_angle=z(), engine_force=z(),
                                  brake=z(), lat_friction=z(4),
                                  long_friction=z(4))


@functools.lru_cache(maxsize=None)
def car_tables(cfg: CarConfig, mass: float, device: torch.device) -> dict:
    """A car preset's constant tensors on ``device``, copied there once
    (a copy from the host inside a tick would synchronise)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                    device=device)
    he = np.asarray(cfg.hitbox_size, np.float32) / 2.0
    return dict(
        offsets=f32(cfg.wheel_offsets()), radii=f32(cfg.wheel_radii()),
        rest=f32(cfg.sus_rest_lengths()),
        force_scale=f32(cfg.sus_force_scales()),
        hitbox_offset=f32(cfg.hitbox_offset), half_extents=f32(he),
        inv_i_local=box_inv_inertia_local(mass, cfg.hitbox_size, device))


def box_inv_inertia_local(mass: float, full_size_uu, device=None
                          ) -> torch.Tensor:
    """Diagonal inverse inertia of the hitbox in BT units (bullet
    btBoxShape::calculateLocalInertia on the margin-adjusted extents, see
    formulas.box_inv_inertia_diag_bt)."""
    return torch.as_tensor(
        np.asarray(formulas.box_inv_inertia_diag_bt(mass, full_size_uu),
                   np.float32), device=device)


def inv_inertia_world(rot: torch.Tensor, inv_inertia_diag: torch.Tensor
                      ) -> torch.Tensor:
    """R diag(invI) R^T, the world-frame inverse inertia, (..., 3, 3)."""
    return torch.sum((rot * inv_inertia_diag)[..., :, None, :]
                     * rot[..., None, :, :], dim=-1)


def apply_impulse_bt(vel_uu, ang_vel, imp_bt, rel_pos_bt, inv_mass,
                     inv_inertia_ws):
    """bullet btRigidBody::applyImpulse in BT units; returns the updated
    (vel_uu, ang_vel)."""
    dv_bt = imp_bt * inv_mass
    dw = m.rotate(inv_inertia_ws, m.cross(rel_pos_bt, imp_bt))
    return vel_uu + dv_bt * C.BT_TO_UU, ang_vel + dw


def gather_cars(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n, ...]]``: x (N, C, *tail), idx (N, ...) int -> (N, ...,
    *tail)."""
    N = x.shape[0]
    tail = x.shape[2:]
    flat = idx.reshape(N, -1).long()
    out = torch.gather(x, 1, flat.reshape(flat.shape + (1,) * len(tail))
                       .expand(flat.shape + tail))
    return out.reshape(idx.shape + tail)


# ---------------------------------------------------------------------------
# Suspension raycasts (btVehicleRL::rayCast, btVehicleRL.cpp:118-212)

@dataclasses.dataclass
class WheelRaycast:
    is_in_contact: torch.Tensor    # (N, C, 4) bool
    in_world_contact: torch.Tensor  # (N, C, 4) bool (vs static arena only)
    contact_point: torch.Tensor    # (N, C, 4, 3) uu
    contact_normal: torch.Tensor   # (N, C, 4, 3)
    susp_length: torch.Tensor      # (N, C, 4) uu
    susp_rel_vel: torch.Tensor     # (N, C, 4) bt/s
    clipped_inv_dot: torch.Tensor  # (N, C, 4)
    extra_pushback: torch.Tensor   # (N, C, 4) bt impulse magnitude
    hard_point: torch.Tensor       # (N, C, 4, 3) uu
    # Dynamic ground object the ray hit (Arena.cpp:733-750 suspension-grid
    # dynamic overlay: wheel rays also hit the ball and other cars):
    # -1 = static world / none, -2 = ball, >= 0 = other car index
    ground_idx: torch.Tensor       # (N, C, 4) int32


def _ray_sphere(origin, direction, max_len, center, radius):
    """Ray vs sphere: (hit, t).  ``direction`` unit; starts outside."""
    oc = origin - center
    b = m.dot(oc, direction)
    c2 = m.dot(oc, oc) - radius * radius
    disc = b * b - c2
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0.0) & (c2 > 0.0) & (t >= 0.0) & (t <= max_len)
    return hit, torch.where(hit, t, max_len)


def _ray_obb(origin, direction, max_len, box_center, box_rot, he):
    """Ray vs oriented box (slab method in the box's local frame).
    Returns (hit, t, normal_world)."""
    lo = m.inv_rotate(box_rot, origin - box_center)
    ld = m.inv_rotate(box_rot, direction)
    safe = torch.where(torch.abs(ld) > 1e-9, ld, 1e-9)
    t1 = (-he - lo) / safe
    t2 = (he - lo) / safe
    tmin_ax = torch.minimum(t1, t2)
    tmax_ax = torch.maximum(t1, t2)
    # parallel rays miss unless the origin is within the slab
    inside = (torch.abs(lo) <= he) | (torch.abs(ld) > 1e-9)
    tmin = torch.amax(tmin_ax, dim=-1)
    tmax = torch.amin(torch.where(inside, tmax_ax, torch.inf), dim=-1)
    hit = ((tmax >= tmin) & (tmax >= 0.0) & (tmin >= 0.0)
           & (tmin <= max_len) & torch.all(inside, dim=-1))
    entry_ax = torch.argmax(tmin_ax, dim=-1)
    sign = -torch.sign(torch.gather(ld, -1, entry_ax[..., None]))[..., 0]
    n_local = (torch.nn.functional.one_hot(entry_ax, 3).to(ld.dtype)
               * sign[..., None])
    n_world = m.rotate(box_rot, n_local)
    return hit, torch.where(hit, tmin, max_len), n_world


@functools.lru_cache(maxsize=None)
def _not_self(num_cars: int, device) -> torch.Tensor:
    return ~torch.eye(num_cars, dtype=torch.bool, device=device)


def wheel_raycasts(cars: CarsState, cfg: CarConfig, mut: MutatorConfig,
                   dt: float, inv_inertia_ws, game_mode: str = "soccar",
                   grid=None, ball=None, alive=None) -> WheelRaycast:
    dev = cars.pos.device
    k = car_tables(cfg, mut.car_mass, dev)
    offsets, radii, rest_len = k["offsets"], k["radii"], k["rest"]
    travel = C.BTVehicle.MAX_SUSPENSION_TRAVEL

    up = cars.up                                         # (N, C, 3)
    hard_point = cars.pos[..., None, :] + m.rotate(
        cars.rot[..., None, :, :], offsets)              # (N, C, 4, 3)
    wheel_dir = -up[..., None, :]                        # ray direction
    dir_b = wheel_dir.expand(hard_point.shape)

    # SUSPENSION_SUBTRACTION is in BT units (0.05 bt = 2.5 uu); the
    # reference computes ray lengths in BT (btVehicleRL.cpp:124)
    sus_sub_uu = C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU
    ray_len = rest_len + travel + radii - sus_sub_uu
    max_b = ray_len.expand(hard_point.shape[:-1])
    hit, dist, normal = geom.raycast_down_dir(
        hard_point, dir_b, max_b, game_mode,
        true_planes_only=grid is not None)
    if grid is not None:
        # the reference raycasts against the whole static world (meshes +
        # planes, btVehicleRL.cpp:118-212): the closest hit wins
        mhit, mdist, mnormal = grid.raycast(hard_point, dir_b, max_b,
                                            k_compact=MESH_COMPACT_K_RAY)
        closer = mhit & (mdist < dist)
        hit = hit | mhit
        dist = torch.where(closer, mdist, dist)
        normal = torch.where(closer[..., None], mnormal, normal)

    ground_idx = torch.full(hit.shape, -1, dtype=torch.int32, device=dev)

    # --- dynamic objects (Arena.cpp:733-750: the suspension grid gets a
    # per-tick dynamic-object overlay so wheel rays hit the ball and other
    # cars; a dynamic hit sets isInContact but NOT isInContactWithWorld,
    # btVehicleRL.cpp:149-150)
    if ball is not None:
        C_cars = cars.pos.shape[-2]
        bhit, bt_ = _ray_sphere(hard_point, dir_b, max_b,
                                ball.pos[:, None, None, :], mut.ball_radius)
        closer = bhit & (bt_ < dist)
        hit = hit | closer
        dist = torch.where(closer, bt_, dist)
        bpt = hard_point + wheel_dir * bt_[..., None]
        bnormal = m.normalize(bpt - ball.pos[:, None, None, :])
        normal = torch.where(closer[..., None], bnormal, normal)
        ground_idx = torch.where(closer, -2, ground_idx)

        # other cars' hitboxes (alive only, not self)
        box_center = cars.pos + m.rotate(cars.rot, k["hitbox_offset"])
        ohit, ot, onorm = _ray_obb(
            hard_point[..., None, :], dir_b[..., None, :],
            max_b[..., None], box_center[:, None, None, :, :],
            cars.rot[:, None, None, :, :, :], k["half_extents"])
        ok = ohit & _not_self(C_cars, dev)[:, None, :]   # (N, C, 4, C)
        if alive is not None:
            ok = ok & alive[:, None, None, :]
        ot = torch.where(ok, ot, torch.inf)
        j = torch.argmin(ot, dim=-1)                     # (N, C, 4)
        ct = torch.gather(ot, -1, j[..., None])[..., 0]
        chit = torch.isfinite(ct)
        cn = torch.gather(onorm, -2, j[..., None, None].expand(
            j.shape + (1, 3)))[..., 0, :]
        closer = chit & (ct < dist)
        hit = hit | closer
        dist = torch.where(closer, ct, dist)
        normal = torch.where(closer[..., None], cn, normal)
        ground_idx = torch.where(closer, j.to(torch.int32), ground_idx)

    # World contact comes from the single NEAREST hit: when a dynamic
    # object is closer than static geometry, the wheel is NOT in world
    # contact (m_isInContactWithWorld = object->isStaticObject() for the
    # nearest hit, btVehicleRL.cpp:151), which gates the sticky forces and
    # the extra pushback.
    in_world = hit & (ground_idx == -1)

    contact_point = hard_point + wheel_dir * dist[..., None]
    # wheelTraceLen = (hardPoint - contactPoint) . up  (btVehicleRL.cpp:154)
    trace_len = m.dot(hard_point - contact_point, up[..., None, :])
    susp_len = torch.minimum(torch.maximum(trace_len - radii,
                                           rest_len - travel),
                             rest_len + travel)
    susp_len = torch.where(hit, susp_len, rest_len + travel)

    # velocity of the chassis at the contact point
    rel = (contact_point - cars.pos[..., None, :]) * C.UU_TO_BT
    vel_at = cars.vel[..., None, :] * C.UU_TO_BT + m.cross(
        cars.ang_vel[..., None, :], rel)
    proj_vel = m.dot(normal, vel_at)
    denom = m.dot(normal, up[..., None, :])
    good_denom = denom > 0.1
    inv = torch.where(good_denom, 1.0 / torch.clamp(denom, min=0.1), 10.0)
    susp_rel_vel = torch.where(hit & good_denom, proj_vel * inv, 0.0)
    clipped_inv = torch.where(hit, torch.where(good_denom, inv, 10.0), 1.0)

    # Extra pushback (btVehicleRL.cpp:184-201): a wheel ray hit closer than
    # the no-travel rest distance gives a hard contact impulse, against
    # static objects only (btVehicleRL.cpp:184)
    push_thresh = rest_len + radii - sus_sub_uu
    delta = (trace_len - push_thresh) * C.UU_TO_BT  # negative: penetration
    needs_push = in_world & (trace_len < push_thresh)
    # resolveSingleCollision vs static: restitution is hard-coded zero
    # there (btContactConstraint.cpp:59,82)
    positional_err = 0.2 * -delta / dt
    velocity_err = -proj_vel
    r_cross_n = m.cross(rel, normal)
    ang_term = m.dot(m.cross(m.rotate(inv_inertia_ws[..., None, :, :],
                                      r_cross_n), rel), normal)
    denom0 = (1.0 / mut.car_mass) + ang_term
    imp = (positional_err + velocity_err) / torch.clamp(denom0, min=1e-9)
    imp = torch.clamp(imp, min=0.0)
    extra_pushback = torch.where(needs_push, imp / 4.0, 0.0)

    normal = torch.where(hit[..., None], normal, -wheel_dir)
    return WheelRaycast(
        is_in_contact=hit, in_world_contact=in_world,
        contact_point=contact_point, contact_normal=normal,
        susp_length=susp_len, susp_rel_vel=susp_rel_vel,
        clipped_inv_dot=clipped_inv, extra_pushback=extra_pushback,
        hard_point=hard_point,
        ground_idx=torch.where(hit, ground_idx, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# Friction impulses (btVehicleRL::calcFrictionImpulses, :313-387)

def _steered(right, up, angle):
    """The chassis right axis rotated about up by ``angle`` (Rodrigues with
    u = up, u . right = 0): v cos + (u x v) sin."""
    return right * torch.cos(angle) + m.cross(up, right) * torch.sin(angle)


def calc_friction_impulses(cars: CarsState, rc: WheelRaycast,
                           wc: WheelControlsState, mut: MutatorConfig,
                           dt: float, inv_inertia_ws, ball=None
                           ) -> torch.Tensor:
    """Wheel impulse vectors (N, C, 4, 3) in BT units (before the dt
    scaling, as wheel.m_impulse).

    With ``ball`` given, wheels whose ray hit a dynamic ground object
    (rc.ground_idx: -2 ball, >= 0 another car) use that object's velocity
    in the relative-velocity terms and its mass and inertia in the
    bilateral jacobian, like the reference's resolveSingleBilateral against
    a dynamic groundObject (btVehicleRL.cpp:321-387).  The rolling-friction
    branch keeps the reference's quirk of evaluating the ground object's
    point velocity at the CAR-relative contact offset
    (btVehicleRL.cpp:352-356)."""
    friction_scale = mut.car_mass / 3.0

    up = cars.up[..., None, :]
    right = cars.right[..., None, :]
    # steered axle: front wheels only (updateWheelTransform)
    zero = torch.zeros_like(wc.steer_angle)
    steer = torch.stack([wc.steer_angle, wc.steer_angle, zero, zero],
                        dim=-1)                          # (N, C, 4)
    axle0 = _steered(right, up, steer[..., None])

    n = rc.contact_normal
    axle = axle0 - n * m.dot(axle0, n, keepdim=True)
    axle = m.normalize(axle)
    fwd_dir = m.normalize(m.cross(n, axle))

    rel = (rc.contact_point - cars.pos[..., None, :]) * C.UU_TO_BT
    vel_at = cars.vel[..., None, :] * C.UU_TO_BT + m.cross(
        cars.ang_vel[..., None, :], rel)

    # dynamic ground object state (zeros / no-ops for static hits)
    if ball is not None:
        gi = rc.ground_idx
        is_ball = gi == -2
        is_car = gi >= 0
        dyn = is_ball | is_car
        gidx = torch.clamp(gi, min=0)
        gb = is_ball[..., None]
        bvel = ball.vel[:, None, None, :]
        g_vel = torch.where(gb, bvel, gather_cars(cars.vel, gidx))
        g_ang = torch.where(gb, ball.ang_vel[:, None, None, :],
                            gather_cars(cars.ang_vel, gidx))
        g_pos = torch.where(gb, ball.pos[:, None, None, :],
                            gather_cars(cars.pos, gidx))
        i_ball = 0.4 * mut.ball_mass * (mut.ball_radius * C.UU_TO_BT) ** 2
        g_inv_iw = torch.where(
            is_ball[..., None, None],
            torch.eye(3, device=gi.device) / i_ball,
            gather_cars(inv_inertia_ws, gidx))           # (N, C, 4, 3, 3)
        g_inv_mass = torch.where(
            dyn, torch.where(is_ball, 1.0 / mut.ball_mass,
                             1.0 / mut.car_mass), 0.0)   # (N, C, 4)
        r_b = (rc.contact_point - g_pos) * C.UU_TO_BT
        v2_at = torch.where(dyn[..., None],
                            g_vel * C.UU_TO_BT + m.cross(g_ang, r_b), 0.0)
        # reference quirk: rolling friction samples the ground object's
        # point velocity at the CAR-relative offset
        v2_quirk = torch.where(dyn[..., None],
                               g_vel * C.UU_TO_BT + m.cross(g_ang, rel), 0.0)
    else:
        v2_at = v2_quirk = 0.0
        g_inv_mass = 0.0
        g_inv_iw = r_b = None

    # side impulse (bullet resolveSingleBilateral; both bodies' terms when
    # the ground object is dynamic)
    rel_vel_side = m.dot(vel_at - v2_at, axle)
    r_cross_n = m.cross(rel, axle)
    ang_term = m.dot(m.cross(m.rotate(inv_inertia_ws[..., None, :, :],
                                      r_cross_n), rel), axle)
    jac_diag = (1.0 / mut.car_mass) + ang_term + g_inv_mass
    if g_inv_iw is not None:
        rb_cross = m.cross(r_b, axle)
        g_ang_term = m.dot(m.cross(m.rotate(g_inv_iw, rb_cross), r_b), axle)
        jac_diag = jac_diag + torch.where(dyn, g_ang_term, 0.0)
    side_impulse = -C.SIDE_FRICTION_CONTACT_DAMPING * rel_vel_side / (
        torch.clamp(jac_diag, min=1e-9))

    # rolling friction (dt <= 1/80 in training, so the sub-80tps rounding
    # branch is skipped; btVehicleRL.cpp:362-366)
    rel_vel_fwd = m.dot(vel_at - v2_quirk, fwd_dir)
    brake = wc.brake[..., None]
    engine = wc.engine_force[..., None]
    rolling_brake = torch.minimum(torch.maximum(
        -rel_vel_fwd * C.ROLLING_FRICTION_SCALE_MAGIC, -brake), brake)
    rolling = torch.where(engine == 0.0,
                          torch.where(brake > 0.0, rolling_brake, 0.0),
                          -engine / friction_scale)

    total = (fwd_dir * (rolling * wc.long_friction)[..., None]
             + axle * (side_impulse * wc.lat_friction)[..., None])
    impulse = total * friction_scale
    return torch.where(rc.is_in_contact[..., None], impulse, 0.0)


def apply_friction_impulses(cars: CarsState, rc: WheelRaycast,
                            impulses: torch.Tensor, dt: float,
                            mut: MutatorConfig, inv_inertia_ws):
    """btVehicleRL::applyFrictionImpulses (:390-402): impulse * dt at the
    contact offset with its up component removed (the rolling influence
    fix)."""
    up = cars.up
    offset = (rc.contact_point - cars.pos[..., None, :]) * C.UU_TO_BT
    up_dot = m.dot(offset, up[..., None, :], keepdim=True)
    rel = offset - up[..., None, :] * up_dot

    imp = impulses * dt                                   # (N, C, 4, 3)
    dv = torch.sum(imp, dim=-2) / mut.car_mass * C.BT_TO_UU
    torque = torch.sum(m.cross(rel, imp), dim=-2)
    dw = m.rotate(inv_inertia_ws, torque)
    return cars.vel + dv, cars.ang_vel + dw


def apply_suspension(cars: CarsState, rc: WheelRaycast, cfg: CarConfig,
                     mut: MutatorConfig, dt: float, inv_inertia_ws):
    """btVehicleRL::updateSuspension (:277-310): spring and damper forces
    applied as impulses at the contact points."""
    k = car_tables(cfg, mut.car_mass, cars.pos.device)
    rest_len, force_scale = k["rest"], k["force_scale"]

    spring = ((rest_len - rc.susp_length) * C.UU_TO_BT
              * C.BTVehicle.SUSPENSION_STIFFNESS * rc.clipped_inv_dot)
    damping_scale = torch.where(rc.susp_rel_vel < 0,
                                C.BTVehicle.WHEELS_DAMPING_COMPRESSION,
                                C.BTVehicle.WHEELS_DAMPING_RELAXATION)
    force = (spring - damping_scale * rc.susp_rel_vel) * force_scale
    force = torch.clamp(force, min=0.0)
    force = torch.where(rc.is_in_contact, force, 0.0)

    base = force * dt + rc.extra_pushback   # (N, C, 4) bt impulse magnitude
    imp = rc.contact_normal * base[..., None]
    rel = (rc.contact_point - cars.pos[..., None, :]) * C.UU_TO_BT
    dv = torch.sum(imp, dim=-2) / mut.car_mass * C.BT_TO_UU
    torque = torch.sum(m.cross(rel, imp), dim=-2)
    dw = m.rotate(inv_inertia_ws, torque)
    return cars.vel + dv, cars.ang_vel + dw


# ---------------------------------------------------------------------------
# Car::_UpdateWheels (Car.cpp:330-475): new drive values + friction params

def update_wheels(cars: CarsState, rc: WheelRaycast, wc: WheelControlsState,
                  controls, fwd_speed, dt: float):
    """Returns (new WheelControlsState, handbrake_val, sticky_accel
    (N, C, 3), real_throttle)."""
    abs_speed = torch.abs(fwd_speed)

    hb_input = controls[..., HANDBRAKE] > 0
    hb_val = torch.where(hb_input,
                         cars.handbrake_val + C.POWERSLIDE_RISE_RATE * dt,
                         cars.handbrake_val - C.POWERSLIDE_FALL_RATE * dt)
    hb_val = torch.clamp(hb_val, 0.0, 1.0)

    throttle = controls[..., THROTTLE]
    boosting = (controls[..., BOOST] > 0) & (cars.boost > 0)
    real_throttle = torch.where(boosting, 1.0, throttle)

    drive_scale = m.curve(C.DRIVE_SPEED_TORQUE_FACTOR_CURVE, abs_speed)
    abs_throttle = torch.abs(real_throttle)

    opposite = (abs_speed > C.STOPPING_FORWARD_VEL) & (
        torch.sign(real_throttle) != torch.sign(fwd_speed))
    # not handbraking (Car.cpp:359-382)
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

    num_contact = torch.sum(rc.is_in_contact, dim=-1)
    drive_scale = torch.where(num_contact < 3, drive_scale / 4.0,
                              drive_scale)

    engine_force = engine_throttle * (C.THROTTLE_TORQUE_AMOUNT
                                      * C.UU_TO_BT) * drive_scale
    brake_force = real_brake * (C.BRAKE_TORQUE_AMOUNT * C.UU_TO_BT)

    # steering (Car.cpp:395-407)
    steer_angle = m.curve(C.STEER_ANGLE_FROM_SPEED_CURVE, abs_speed)
    ps_angle = m.curve(C.POWERSLIDE_STEER_ANGLE_FROM_SPEED_CURVE, abs_speed)
    steer_angle = steer_angle + (ps_angle - steer_angle) * hb_val
    steer_angle = steer_angle * controls[..., STEER]

    # Friction params (Car.cpp:409-461).  latDir comes from the wheel's
    # m_worldTransform, last refreshed in updateWheelTransform at tick
    # start, i.e. with the PREVIOUS tick's steer angle.
    lat_dir0 = cars.right[..., None, :]
    up = cars.up[..., None, :]
    steered_right = _steered(lat_dir0, up, wc.steer_angle[..., None, None])
    shape = steer_angle.shape + (2, 3)
    lat_dir = torch.cat([steered_right.expand(shape),
                         lat_dir0.expand(shape)], dim=-2)
    long_dir = m.cross(lat_dir, rc.contact_normal)

    rel = rc.hard_point - cars.pos[..., None, :]
    cross_vec = (m.cross(cars.ang_vel[..., None, :], rel * C.UU_TO_BT)
                 + cars.vel[..., None, :] * C.UU_TO_BT) * C.BT_TO_UU
    base_fric = torch.abs(m.dot(cross_vec, lat_dir))
    fric_input = torch.where(
        base_fric > 5.0,
        base_fric / (torch.abs(m.dot(cross_vec, long_dir)) + base_fric),
        0.0)
    lat_f = m.curve(C.LAT_FRICTION_CURVE, fric_input)
    long_f = m.curve(C.LONG_FRICTION_CURVE, fric_input)

    hb = hb_val[..., None]
    lat_hb = lat_f * ((m.curve(C.HANDBRAKE_LAT_FRICTION_FACTOR_CURVE,
                               fric_input) - 1.0) * hb + 1.0)
    long_hb = long_f * ((m.curve(C.HANDBRAKE_LONG_FRICTION_FACTOR_CURVE,
                                 fric_input) - 1.0) * hb + 1.0)
    has_hb = hb > 0
    lat_f = torch.where(has_hb, lat_hb, lat_f)
    long_f = torch.where(has_hb, long_hb, torch.ones_like(long_f))

    sticky = (real_throttle != 0.0)[..., None]
    non_sticky_scale = m.curve(C.NON_STICKY_FRICTION_FACTOR_CURVE,
                               rc.contact_normal[..., 2])
    lat_f = torch.where(sticky, lat_f, lat_f * non_sticky_scale)
    long_f = torch.where(sticky, long_f, long_f * non_sticky_scale)

    # keep the previous values where a wheel has no ground contact (the
    # reference only updates wheels with a ground object)
    lat_f = torch.where(rc.is_in_contact, lat_f, wc.lat_friction)
    long_f = torch.where(rc.is_in_contact, long_f, wc.long_friction)

    # sticky force (Car.cpp:463-474)
    any_world = torch.any(rc.in_world_contact, dim=-1)
    sum_n = torch.sum(torch.where(rc.is_in_contact[..., None],
                                  rc.contact_normal, 0.0), dim=-2)
    up_dir = torch.where(m.norm(sum_n, keepdim=True) > 1e-9,
                         m.normalize(sum_n), cars.up)
    full_stick = (real_throttle != 0.0) | (abs_speed
                                           > C.STOPPING_FORWARD_VEL)
    sticky_scale = 0.5 + torch.where(full_stick,
                                     1.0 - torch.abs(up_dir[..., 2]), 0.0)
    sticky_accel = up_dir * (sticky_scale * C.GRAVITY_Z)[..., None]
    sticky_accel = torch.where(any_world[..., None], sticky_accel, 0.0)

    new_wc = WheelControlsState(
        steer_angle=steer_angle, engine_force=engine_force,
        brake=brake_force, lat_friction=lat_f, long_friction=long_f)
    return new_wc, hb_val, sticky_accel, real_throttle


# ---------------------------------------------------------------------------
# Air control / jump / flip state machines

def update_air_torque(cars: CarsState, controls, in_air_mask, zero_wheels,
                      dt: float):
    """Car::_UpdateAirTorque (Car.cpp:556-641).

    Returns (ang_accel (N, C, 3), accel (N, C, 3), is_flipping).
    ``in_air_mask`` is numWheelsInContact < 3 (whether this update runs at
    all); ``zero_wheels`` is numWheelsInContact == 0 (air control
    allowed)."""
    dir_pitch = -cars.right
    dir_yaw = cars.up
    dir_roll = -cars.forward

    is_flipping = cars.is_flipping & cars.has_flipped & (
        cars.flip_time < C.FLIP_TORQUE_TIME)

    rel_torque = cars.flip_rel_torque
    has_rel_torque = torch.any(rel_torque != 0.0, dim=-1)

    pitch_in = controls[..., PITCH]
    flip_cancel = (rel_torque[..., 1] != 0.0) & (pitch_in != 0.0) & (
        torch.sign(rel_torque[..., 1]) == torch.sign(pitch_in))
    pitch_scale = torch.where(
        flip_cancel, 1.0 - torch.clamp(torch.abs(pitch_in), max=1.0), 1.0)
    dodge_torque = torch.stack([rel_torque[..., 0] * C.FLIP_TORQUE_X,
                                (rel_torque[..., 1] * pitch_scale)
                                * C.FLIP_TORQUE_Y,
                                rel_torque[..., 2] * 0.0], dim=-1)
    flip_ang_accel = m.rotate(cars.rot, dodge_torque)
    flip_ang_accel = torch.where((is_flipping & has_rel_torque)[..., None],
                                 flip_ang_accel, 0.0)

    do_air_control = torch.where(
        is_flipping, has_rel_torque & flip_cancel | ~has_rel_torque,
        torch.ones_like(is_flipping))
    do_air_control = do_air_control & ~cars.is_auto_flipping & zero_wheels

    # pitch lock during and after flips
    pitch_lock = is_flipping | (
        cars.has_flipped
        & (cars.flip_time < C.FLIP_TORQUE_TIME + C.FLIP_PITCHLOCK_EXTRA_TIME))
    pitch_torque_scale = torch.where(pitch_lock, 0.0, 1.0)

    yaw_in, roll_in = controls[..., YAW], controls[..., ROLL]
    any_input = (pitch_in != 0) | (yaw_in != 0) | (roll_in != 0)
    tx, ty, tz = C.CAR_AIR_CONTROL_TORQUE
    torque = ((pitch_in * pitch_torque_scale)[..., None] * dir_pitch * tx
              + yaw_in[..., None] * dir_yaw * ty
              + roll_in[..., None] * dir_roll * tz)
    torque = torch.where(any_input[..., None], torque, 0.0)

    dx, dy, dz = C.CAR_AIR_CONTROL_DAMPING
    damp_pitch = m.dot(dir_pitch, cars.ang_vel) * dx * (
        1.0 - torch.abs(torch.where(do_air_control,
                                    pitch_in * pitch_torque_scale, 0.0)))
    damp_yaw = m.dot(dir_yaw, cars.ang_vel) * dy * (
        1.0 - torch.abs(torch.where(do_air_control, yaw_in, 0.0)))
    damp_roll = m.dot(dir_roll, cars.ang_vel) * dz
    damping = (dir_yaw * damp_yaw[..., None]
               + dir_pitch * damp_pitch[..., None]
               + dir_roll * damp_roll[..., None])
    control_ang_accel = (torque - damping) * C.CAR_TORQUE_SCALE
    control_ang_accel = torch.where(do_air_control[..., None],
                                    control_ang_accel, 0.0)

    # air throttle (Car.cpp:639-640), whenever _UpdateAirTorque runs
    throttle = controls[..., THROTTLE]
    air_accel = cars.forward * (throttle * C.THROTTLE_AIR_ACCEL)[..., None]
    air_accel = torch.where((throttle != 0.0)[..., None], air_accel, 0.0)

    ang_accel = flip_ang_accel + control_ang_accel
    ang_accel = torch.where(in_air_mask[..., None], ang_accel, 0.0)
    accel = torch.where(in_air_mask[..., None], air_accel, 0.0)
    is_flipping = is_flipping & in_air_mask
    return ang_accel, accel, is_flipping


def update_jump(cars: CarsState, controls, jump_pressed, mut: MutatorConfig,
                dt: float):
    """Car::_UpdateJump (Car.cpp:507-554).  Returns (state updates dict,
    dv (N, C, 3), accel (N, C, 3))."""
    on_ground = cars.is_on_ground
    is_jumping = cars.is_jumping
    has_jumped = cars.has_jumped
    jump_time = cars.jump_time

    # ground reset with a time pad
    reset_ok = on_ground & ~is_jumping & ~(
        has_jumped & (jump_time < C.JUMP_MIN_TIME + C.JUMP_RESET_TIME_PAD))
    has_jumped = has_jumped & ~reset_ok
    jump_time = torch.where(reset_ok, 0.0, jump_time)

    # continue or stop jumping
    cont = (jump_time < C.JUMP_MIN_TIME) | (
        (controls[..., JUMP] > 0) & (jump_time < C.JUMP_MAX_TIME))
    start = ~is_jumping & on_ground & jump_pressed
    new_is_jumping = torch.where(is_jumping, cont, start)
    jump_time = torch.where(start, 0.0, jump_time)

    dv = torch.where(start[..., None], cars.up * mut.jump_immediate_force,
                     0.0)

    has_jumped = has_jumped | new_is_jumping
    accel_scale = torch.where(jump_time < C.JUMP_MIN_TIME,
                              C.JUMP_PRE_MIN_ACCEL_SCALE, 1.0)
    accel = torch.where(new_is_jumping[..., None],
                        cars.up * (mut.jump_accel * accel_scale)[..., None],
                        0.0)

    jump_time = torch.where(new_is_jumping | has_jumped, jump_time + dt,
                            jump_time)
    updates = dict(is_jumping=new_is_jumping, has_jumped=has_jumped,
                   jump_time=jump_time)
    return updates, dv, accel


def update_auto_flip(cars: CarsState, controls, jump_pressed, dt: float):
    """Car::_UpdateAutoFlip (Car.cpp:763-797)."""
    _, _, roll_ang = m.rotmat_to_euler(cars.rot)
    abs_roll = torch.abs(roll_ang)
    trigger = (jump_pressed & cars.has_world_contact
               & (cars.world_contact_normal[..., 2]
                  > C.CAR_AUTOFLIP_NORMZ_THRESH)
               & (abs_roll > C.CAR_AUTOFLIP_ROLL_THRESH))

    timer = torch.where(trigger, C.CAR_AUTOFLIP_TIME * (abs_roll / np.pi),
                        cars.auto_flip_timer)
    scale = torch.where(trigger, torch.where(roll_ang > 0, 1.0, -1.0),
                        cars.auto_flip_torque_scale)
    is_af = trigger | cars.is_auto_flipping

    dv = torch.where(trigger[..., None], -cars.up * C.CAR_AUTOFLIP_IMPULSE,
                     0.0)

    active = is_af & (timer > 0)
    expired = is_af & ~active
    dw = torch.where(
        active[..., None],
        cars.forward * (C.CAR_AUTOFLIP_TORQUE * scale * dt)[..., None], 0.0)
    timer = torch.where(active, timer - dt,
                        torch.where(expired, 0.0, timer))
    is_af = is_af & ~expired
    updates = dict(is_auto_flipping=is_af, auto_flip_timer=timer,
                   auto_flip_torque_scale=scale)
    return updates, dv, dw


def update_double_jump_or_flip(cars: CarsState, controls, jump_pressed,
                               fwd_speed, cfg: CarConfig, mut: MutatorConfig,
                               dt: float, is_jumping, has_jumped, jump_time,
                               is_flipping):
    """Car::_UpdateDoubleJumpOrFlip (Car.cpp:643-761), after update_jump.
    Returns (updates dict, dv (N, C, 3), z_damp_maybe, z_damp_always)."""
    on_ground = cars.is_on_ground
    air = ~on_ground

    has_double_jumped = cars.has_double_jumped & air
    has_flipped = cars.has_flipped & air
    air_time = torch.where(on_ground, 0.0, cars.air_time + dt)
    atsj = torch.where(
        on_ground, 0.0,
        torch.where(has_jumped & ~is_jumping,
                    cars.air_time_since_jump + dt, 0.0))
    flip_time = torch.where(on_ground, 0.0, cars.flip_time)
    flip_rel_torque = cars.flip_rel_torque

    press_window = air & jump_pressed & (atsj < C.DOUBLEJUMP_MAX_DELAY)
    pitch_in, yaw_in, roll_in = (controls[..., PITCH], controls[..., YAW],
                                 controls[..., ROLL])
    input_mag = torch.abs(yaw_in) + torch.abs(pitch_in) + torch.abs(roll_in)
    is_flip_input = input_mag >= cfg.dodge_deadzone

    fresh = ~has_double_jumped & ~has_flipped
    always = torch.ones_like(fresh)
    can_flip = always if mut.unlimited_flips else fresh
    can_dj = always if mut.unlimited_double_jumps else fresh
    can_use = torch.where(is_flip_input, can_flip, can_dj)
    can_use = can_use & ~cars.is_auto_flipping

    do_flip = press_window & can_use & is_flip_input
    do_dj = press_window & can_use & ~is_flip_input

    # flip initiation (Car.cpp:677-737)
    fwd_ratio = torch.abs(fwd_speed) / C.CAR_MAX_SPEED
    yaw_roll = yaw_in + roll_in
    zero = torch.zeros_like(pitch_in)
    dodge_dir = torch.stack([-pitch_in, yaw_roll, zero], dim=-1)
    stall = (torch.abs(yaw_roll) < 0.1) & (torch.abs(pitch_in) < 0.1)
    dodge_dir = torch.where(stall[..., None], 0.0, m.normalize(dodge_dir))
    new_rel_torque = torch.stack([-dodge_dir[..., 1], dodge_dir[..., 0],
                                  zero], dim=-1)
    d0 = torch.where(torch.abs(dodge_dir[..., 0]) < 0.1, 0.0,
                     dodge_dir[..., 0])
    d1 = torch.where(torch.abs(dodge_dir[..., 1]) < 0.1, 0.0,
                     dodge_dir[..., 1])
    dd = torch.stack([d0, d1, dodge_dir[..., 2]], dim=-1)
    nonzero_dd = torch.any(torch.abs(dd) > 1e-7, dim=-1)

    backwards = torch.where(torch.abs(fwd_speed) < 100.0, d0 < 0.0,
                            (d0 >= 0.0) != (fwd_speed >= 0.0))
    init_vel = dd * C.FLIP_INITIAL_VEL_SCALE
    max_x = torch.where(backwards, C.FLIP_BACKWARD_IMPULSE_MAX_SPEED_SCALE,
                        C.FLIP_FORWARD_IMPULSE_MAX_SPEED_SCALE)
    vx = init_vel[..., 0] * ((max_x - 1.0) * fwd_ratio + 1.0)
    vy = init_vel[..., 1] * (
        (C.FLIP_SIDE_IMPULSE_MAX_SPEED_SCALE - 1.0) * fwd_ratio + 1.0)
    vx = torch.where(backwards, vx * C.FLIP_BACKWARD_IMPULSE_SCALE_X, vx)

    f = cars.forward
    fwd_ang = torch.atan2(f[..., 1], f[..., 0])
    ca, sa = torch.cos(fwd_ang), torch.sin(fwd_ang)
    # xVelDir = (cos, -sin, 0), yVelDir = (sin, cos, 0)
    dvx = vx * ca + vy * sa
    dvy = -vx * sa + vy * ca
    flip_dv = torch.stack([dvx, dvy, torch.zeros_like(dvx)], dim=-1)
    flip_dv = torch.where((do_flip & nonzero_dd)[..., None], flip_dv, 0.0)

    flip_time = torch.where(do_flip, 0.0, flip_time)
    has_flipped = has_flipped | do_flip
    is_flipping = is_flipping | do_flip
    flip_rel_torque = torch.where(do_flip[..., None], new_rel_torque,
                                  flip_rel_torque)

    # double jump
    dj_dv = torch.where(do_dj[..., None], cars.up * C.JUMP_IMMEDIATE_FORCE,
                        0.0)
    has_double_jumped = has_double_jumped | do_dj

    # flip timing and z damping (Car.cpp:749-760); the vel.z < 0 test is
    # the caller's
    flip_time_next = torch.where(is_flipping | has_flipped,
                                 flip_time + dt, flip_time)
    in_torque_window = is_flipping & (flip_time_next <= C.FLIP_TORQUE_TIME)
    z_damp = in_torque_window & (flip_time_next >= C.FLIP_Z_DAMP_START)
    z_damp_always = z_damp & (flip_time_next < C.FLIP_Z_DAMP_END)

    updates = dict(
        has_double_jumped=has_double_jumped, has_flipped=has_flipped,
        air_time=air_time, air_time_since_jump=atsj,
        flip_time=flip_time_next, is_flipping=is_flipping,
        flip_rel_torque=flip_rel_torque)
    return updates, flip_dv + dj_dv, z_damp, z_damp_always


def update_auto_roll(cars: CarsState, rc: WheelRaycast, controls,
                     num_contact):
    """Car::_UpdateAutoRoll (Car.cpp:799-833).  Returns (accel,
    ang_accel); the caller masks them by the trigger condition."""
    sum_n = torch.sum(torch.where(rc.is_in_contact[..., None],
                                  rc.contact_normal, 0.0), dim=-2)
    wheels_up = torch.where(m.norm(sum_n, keepdim=True) > 1e-9,
                            m.normalize(sum_n), cars.up)
    ground_up = torch.where((num_contact > 0)[..., None], wheels_up,
                            cars.world_contact_normal)
    ground_down = -ground_up

    fdir, rdir = cars.forward, cars.right
    cross_right = m.cross(ground_up, fdir)
    cross_fwd = m.cross(ground_down, cross_right)

    right_factor = 1.0 - torch.clamp(m.dot(rdir, cross_right), 0.0, 1.0)
    fwd_factor = 1.0 - torch.clamp(m.dot(fdir, cross_fwd), 0.0, 1.0)

    t_dir_right = fdir * torch.where(m.dot(rdir, ground_up) >= 0, -1.0,
                                     1.0)[..., None]
    t_dir_fwd = rdir * torch.where(m.dot(fdir, ground_up) >= 0, 1.0,
                                   -1.0)[..., None]
    torque = (t_dir_right * right_factor[..., None]
              + t_dir_fwd * fwd_factor[..., None])

    accel = ground_down * C.CAR_AUTOROLL_FORCE
    ang_accel = torque * C.CAR_AUTOROLL_TORQUE
    return accel, ang_accel


def update_boost(cars: CarsState, controls, mut: MutatorConfig, dt: float):
    """Car::_UpdateBoost (Car.cpp:477-505).  Returns (updates, accel)."""
    boosting_input = controls[..., BOOST] > 0
    tsb = cars.time_spent_boosting
    stop = ~boosting_input & (tsb >= C.BOOST_MIN_TIME)
    tsb = torch.where(tsb > 0, torch.where(stop, 0.0, tsb + dt),
                      torch.where(boosting_input, dt, 0.0))

    active = (cars.boost > 0) & (tsb > 0)
    boost_amt = torch.where(
        active,
        torch.clamp(cars.boost - mut.boost_used_per_second * dt, min=0.0),
        cars.boost)
    boost_amt = torch.clamp(boost_amt, max=C.BOOST_MAX)

    accel_mag = torch.where(cars.is_on_ground, mut.boost_accel_ground,
                            mut.boost_accel_air)
    accel = torch.where(active[..., None],
                        cars.forward * accel_mag[..., None], 0.0)
    return dict(boost=boost_amt, time_spent_boosting=tsb), accel
