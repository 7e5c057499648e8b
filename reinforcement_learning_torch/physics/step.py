"""Arena stepping: the state containers, the static arena configuration,
and the portable physics engine's tick and multi-tick env step.

The env advances arenas by one of two routes (``envs.env``): the kernel
route, ``ops.arena_step`` (the CUDA kernel on the card, its plain PyTorch
version ``ops.ctick`` on the CPU), and the portable route here, batched
torch ops that run on any device, hoops and real ``.cmf`` assets
included.  The two routes are twins of two JAX routes (the Pallas
megakernel and the XLA engine) that differ on the long curved climbs, so
each is held against its own reference.

The portable tick replicates the reference per-tick pipeline order
(Arena::Step, Arena.cpp:716-812):

  1. ball zero-velocity sleeping
  2. per-car ``_PreTickUpdate`` (Car.cpp:58-131): demo/respawn, suspension
     raycasts + stale-control friction impulses (btVehicleRL quirk), drive
     update, air torque, jump/auto-flip/double-jump-flip/auto-roll state
     machines, suspension + friction impulse application, boost
  3. boost pad pre-tick (cooldowns)
  4. world step: integrate forces into velocities, resolve contacts
     (car-world, car-ball, ball-world, car-car), integrate transforms
  5. per-car ``_PostTickUpdate`` + ``_FinishPhysicsTick``: supersonic
     hysteresis, velocity-impulse caches, speed clamps
  6. boost pad pickup + post-tick
  7. goal detection

Every field has an arena axis first, ``(N, C, ...)``.  ``arena_step`` runs
``tick_skip`` ticks with the new actions applied ``action_delay`` ticks in
(EnvSet.cpp:113-156).  Nothing reads a tensor's value on the host inside
a tick.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.device import constant, resolve_device
from reinforcement_learning_torch.physics import arena_geom as geom
from reinforcement_learning_torch.physics import car as carmod
from reinforcement_learning_torch.physics import contacts
from reinforcement_learning_torch.physics import formulas
from reinforcement_learning_torch.physics import world as worldmod
from reinforcement_learning_torch.physics.car import WheelControlsState
from reinforcement_learning_torch.physics.state import (
    JUMP, THROTTLE, ArenaState, BallState, CarConfig, CarsState,
    MutatorConfig, make_arena_state)


@dataclasses.dataclass
class PhysicsState:
    """ArenaState plus the cross-tick wheel drive state."""
    arena: ArenaState
    wheels: WheelControlsState

    @property
    def cars(self):
        return self.arena.cars

    @property
    def ball(self):
        return self.arena.ball


@dataclasses.dataclass(frozen=True)
class ArenaParams:
    """Static arena configuration.

    ``use_mesh`` (collide against the arena's triangle mesh: on the kernel
    route the procedural mesh as the closed-form facet arena, on the
    portable route the ``world.get_grid`` mesh) and ``dynamic_wheel_rays``
    (wheel rays also hit the ball and other cars) default to the
    reference's full fidelity; with both off the arena is analytic
    planes."""
    num_cars: int
    mutators: MutatorConfig = None
    car_config: CarConfig = CarConfig()
    tick_rate: float = 120.0
    game_mode: str = "soccar"
    use_mesh: bool = True
    dynamic_wheel_rays: bool = True

    def __post_init__(self):
        if self.mutators is None:
            object.__setattr__(self, "mutators",
                               MutatorConfig.for_mode(self.game_mode))

    @property
    def dt(self) -> float:
        return 1.0 / self.tick_rate


def make_physics_state(params: ArenaParams, batch=(),
                       device=None) -> PhysicsState:
    """Default state of one arena, or of ``batch`` arenas, on ``device``
    (default ``"cuda"``)."""
    device = resolve_device(device)
    return PhysicsState(
        arena=make_arena_state(params.num_cars, params.mutators,
                               params.game_mode, batch, device),
        wheels=WheelControlsState.make(params.num_cars, batch, device))


def clamp_controls(controls: torch.Tensor) -> torch.Tensor:
    """CarControls::ClampFix (CarControls.h:26-32) + booleanized buttons."""
    analog = torch.clamp(controls[..., :5], -1.0, 1.0)
    buttons = (controls[..., 5:] > 0).to(controls.dtype)
    return torch.cat([analog, buttons], dim=-1)


# ---------------------------------------------------------------------------
# constants on the device

@functools.lru_cache(maxsize=None)
def _tick_tables(game_mode: str, teams: tuple, device) -> dict:
    """The tick's constant tensors on ``device``, copied there once (a copy
    from the host inside a tick would synchronise)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                    device=device)
    hoops = game_mode == "hoops"
    locs = C.BOOST_PAD_LOCS_HOOPS if hoops else C.BOOST_PAD_LOCS_SOCCAR
    is_big = C.BOOST_PAD_IS_BIG_HOOPS if hoops else C.BOOST_PAD_IS_BIG
    t = np.asarray(teams, np.int32)
    return dict(
        teams=torch.as_tensor(t, device=device),
        team_sign=f32(np.where(t == 0, 1.0, -1.0)),
        team_yaw=f32(np.where(t == 0, 0.0, np.pi)),
        opp=torch.as_tensor(t[:, None] != t[None, :], device=device),
        respawn=f32(C.CAR_RESPAWN_LOCATIONS_HOOPS if hoops
                    else C.CAR_RESPAWN_LOCATIONS_SOCCAR),
        pad_locs=f32(locs), pad_is_big=torch.as_tensor(np.asarray(is_big),
                                                       device=device),
        ids=torch.arange(1, len(t) + 1, dtype=torch.int32, device=device),
        cars_arange=torch.arange(len(t), device=device))


def _bcast(mask, x):
    """``mask`` (N, C) reshaped to broadcast against ``x`` (N, C, ...)."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _respawn_cars(cars: CarsState, tables: dict, respawn_mask, respawn_idx,
                  mut: MutatorConfig) -> CarsState:
    """Car::Respawn (Car.cpp:43-56): a fresh default state at respawn
    location ``respawn_idx`` (N, C), mirrored for orange."""
    spawn = tables["respawn"][respawn_idx.long()]       # (N, C, 3): x, y, yaw
    pos = torch.stack([spawn[..., 0], spawn[..., 1] * tables["team_sign"],
                       torch.full_like(spawn[..., 0], C.CAR_RESPAWN_Z)],
                      dim=-1)
    yaw = spawn[..., 2] + tables["team_yaw"]
    rot = m.euler_to_rotmat(yaw)

    def w(field, new):
        return torch.where(_bcast(respawn_mask, field), new, field)

    return dataclasses.replace(
        cars, pos=w(cars.pos, pos), rot=w(cars.rot, rot),
        vel=w(cars.vel, 0.0), ang_vel=w(cars.ang_vel, 0.0),
        is_on_ground=w(cars.is_on_ground, True),
        wheels_with_contact=w(cars.wheels_with_contact, False),
        has_jumped=w(cars.has_jumped, False),
        has_double_jumped=w(cars.has_double_jumped, False),
        has_flipped=w(cars.has_flipped, False),
        flip_rel_torque=w(cars.flip_rel_torque, 0.0),
        jump_time=w(cars.jump_time, 0.0), flip_time=w(cars.flip_time, 0.0),
        is_flipping=w(cars.is_flipping, False),
        is_jumping=w(cars.is_jumping, False),
        air_time=w(cars.air_time, 0.0),
        air_time_since_jump=w(cars.air_time_since_jump, 0.0),
        boost=w(cars.boost, mut.car_spawn_boost_amount),
        time_spent_boosting=w(cars.time_spent_boosting, 0.0),
        is_supersonic=w(cars.is_supersonic, False),
        supersonic_time=w(cars.supersonic_time, 0.0),
        handbrake_val=w(cars.handbrake_val, 0.0),
        is_auto_flipping=w(cars.is_auto_flipping, False),
        auto_flip_timer=w(cars.auto_flip_timer, 0.0),
        auto_flip_torque_scale=w(cars.auto_flip_torque_scale, 0.0),
        has_world_contact=w(cars.has_world_contact, False),
        world_contact_normal=w(cars.world_contact_normal, 0.0),
        car_contact_other_id=w(cars.car_contact_other_id, 0),
        car_contact_cooldown=w(cars.car_contact_cooldown, 0.0),
        is_demoed=w(cars.is_demoed, False),
        demo_respawn_timer=w(cars.demo_respawn_timer, 0.0),
    )


def arena_tick(phys: PhysicsState, teams, respawn_idx: torch.Tensor,
               params: ArenaParams) -> PhysicsState:
    """One 1/120 s physics tick of every arena.

    ``teams``: the per-car team ids (C,), static; ``respawn_idx`` (N, C)
    int: the respawn location of a car whose demolition timer runs out
    this tick (the JAX tick draws it from its key).

    Every per-car update runs UNMASKED for every car; one select at the
    end restores the frozen state of cars that were demolished at tick
    start (DISABLE_SIMULATION, Car.cpp:74-87).  Only cross-object effects
    (ball impulses, car-car, pad pickup) carry explicit alive masks."""
    mut = params.mutators
    cfg = params.car_config
    dt = params.dt
    num_cars = params.num_cars
    arena = phys.arena
    cars = arena.cars
    ball = arena.ball
    wc = phys.wheels
    dev = cars.pos.device
    tables = _tick_tables(params.game_mode,
                          tuple(int(t) for t in np.asarray(teams)), dev)
    grid = (worldmod.get_grid(params.game_mode, dev) if params.use_mesh
            else None)

    # static numpy, as the JAX tick's contact-margin scalars
    half_extents = np.asarray(cfg.hitbox_size, np.float32) / 2.0
    hitbox_offset = np.asarray(cfg.hitbox_offset, np.float32)
    inv_i_local = carmod.car_tables(cfg, mut.car_mass, dev)["inv_i_local"]

    controls = clamp_controls(cars.controls)
    cars = dataclasses.replace(cars, controls=controls)

    # --- demo / respawn (Car.cpp:68-87)
    demo_timer = torch.where(
        cars.is_demoed, torch.clamp(cars.demo_respawn_timer - dt, min=0.0),
        cars.demo_respawn_timer)
    respawn_now = cars.is_demoed & (demo_timer == 0.0)
    cars = dataclasses.replace(cars, demo_respawn_timer=demo_timer)
    cars = _respawn_cars(cars, tables, respawn_now, respawn_idx, mut)
    alive = ~cars.is_demoed
    # frozen snapshot: demoed cars keep exactly this state this tick
    frozen_cars = cars
    frozen_wc = wc

    # world-frame inverse inertia: the rotation is constant until the
    # transform integration, so one serves the whole tick
    inv_iw = carmod.inv_inertia_world(cars.rot, inv_i_local)

    # --- updateVehicleFirst: raycasts + stale friction impulses; the rays
    # also hit the ball and other (alive) cars (Arena.cpp:733-750)
    ray_ball = ball if params.dynamic_wheel_rays else None
    rc = carmod.wheel_raycasts(cars, cfg, mut, dt, inv_iw,
                               params.game_mode, grid=grid, ball=ray_ball,
                               alive=alive)
    wheel_impulses = carmod.calc_friction_impulses(cars, rc, wc, mut, dt,
                                                   inv_iw, ball=ray_ball)

    num_contact = torch.sum(rc.is_in_contact, dim=-1)
    cars = dataclasses.replace(cars, wheels_with_contact=rc.is_in_contact,
                               is_on_ground=num_contact >= 3)

    jump_pressed = (controls[..., JUMP] > 0) & ~(
        cars.last_controls[..., JUMP] > 0)
    fwd_speed = m.dot(cars.vel, cars.forward)

    # --- _UpdateWheels
    new_wc, hb_val, sticky_accel, _ = carmod.update_wheels(
        cars, rc, wc, controls, fwd_speed, dt)
    cars = dataclasses.replace(cars, handbrake_val=hb_val)

    # --- air torque / flipping clear (Car.cpp:111-115)
    air_mask = num_contact < 3
    zero_wheels = num_contact == 0
    air_ang_accel, air_accel, is_flipping = carmod.update_air_torque(
        cars, controls, air_mask, zero_wheels, dt)
    cars = dataclasses.replace(cars, is_flipping=is_flipping & air_mask)

    # --- jump
    jump_updates, jump_dv, jump_accel = carmod.update_jump(
        cars, controls, jump_pressed, mut, dt)
    cars = dataclasses.replace(cars, vel=cars.vel + jump_dv, **jump_updates)

    # --- auto flip
    af_updates, af_dv, af_dw = carmod.update_auto_flip(cars, controls,
                                                       jump_pressed, dt)
    cars = dataclasses.replace(cars, vel=cars.vel + af_dv,
                               ang_vel=cars.ang_vel + af_dw, **af_updates)

    # --- double jump / flip
    dj_updates, dj_dv, zdamp_maybe, zdamp_always = \
        carmod.update_double_jump_or_flip(
            cars, controls, jump_pressed, fwd_speed, cfg, mut, dt,
            cars.is_jumping, cars.has_jumped, cars.jump_time,
            cars.is_flipping)
    vel = cars.vel + dj_dv
    # flip z-damping (Car.cpp:749-755)
    do_damp = zdamp_always | (zdamp_maybe & (vel[..., 2] < 0))
    damp_factor = (1.0 - C.FLIP_Z_DAMP_120) ** (dt * 120.0)
    vel = torch.cat([vel[..., :2], (vel[..., 2] * torch.where(
        do_damp, damp_factor, 1.0))[..., None]], dim=-1)
    cars = dataclasses.replace(cars, vel=vel, **dj_updates)

    # --- auto roll (Car.cpp:122-123)
    ar_cond = (controls[..., THROTTLE] != 0) & (
        ((num_contact > 0) & (num_contact < 4)) | cars.has_world_contact)
    ar_accel, ar_ang_accel = carmod.update_auto_roll(cars, rc, controls,
                                                     num_contact)
    ar_accel = torch.where(ar_cond[..., None], ar_accel, 0.0)
    ar_ang_accel = torch.where(ar_cond[..., None], ar_ang_accel, 0.0)

    # worldContact cleared after use (Car.cpp:125)
    cars = dataclasses.replace(cars,
                               has_world_contact=torch.zeros_like(alive))

    # --- updateVehicleSecond: suspension + friction application
    vel, ang_vel = carmod.apply_suspension(cars, rc, cfg, mut, dt, inv_iw)
    cars = dataclasses.replace(cars, vel=vel, ang_vel=ang_vel)
    vel, ang_vel = carmod.apply_friction_impulses(cars, rc, wheel_impulses,
                                                  dt, mut, inv_iw)
    cars = dataclasses.replace(cars, vel=vel, ang_vel=ang_vel)

    # --- boost
    boost_updates, boost_accel = carmod.update_boost(cars, controls, mut, dt)
    cars = dataclasses.replace(cars, **boost_updates)

    # --- boost pad pre-tick (BoostPad.cpp:52-60)
    pads = arena.pads
    cooldown = torch.clamp(pads.cooldown - dt, min=0.0)
    pads = dataclasses.replace(pads, cooldown=cooldown,
                               is_active=cooldown == 0.0)

    # =======================================================================
    # World step (bullet stepSimulation)

    gravity = constant((0.0, 0.0, mut.gravity_z), dev)

    # pre-force velocities: bullet defers forces into the solver's
    # externalForceImpulse; restitution and the contact callbacks read the
    # velocities WITHOUT them
    cars_vel_pre = cars.vel
    cars_ang_vel_pre = cars.ang_vel

    total_accel = (gravity + sticky_accel + air_accel + jump_accel
                   + ar_accel + boost_accel)
    total_ang_accel = air_ang_accel + ar_ang_accel
    cars = dataclasses.replace(cars, vel=cars.vel + total_accel * dt,
                               ang_vel=cars.ang_vel + total_ang_accel * dt)

    # ball pre-tick (Ball::_PreTickUpdate, Ball.cpp:152-201)
    if params.game_mode == "heatseeker":
        ball = _heatseeker_steer(ball, dt)

    # ball: sleeping + gravity + drag (Arena.cpp:721-727, Ball.cpp:95-98)
    ball_awake = (m.norm(ball.vel) > 0) | (m.norm(ball.ang_vel) > 0)
    ball_vel_pre = ball.vel
    drag = (1.0 - mut.ball_drag) ** dt
    ball = dataclasses.replace(ball, vel=torch.where(
        ball_awake[..., None], (ball.vel + gravity * dt) * drag, ball.vel))

    # --- contacts (the rotations are unchanged, so inv_iw still holds)
    if grid is not None:
        cw_dv, cw_dw, cw_push, cw_turn, cw_contact, cw_normal = \
            contacts.resolve_car_world_mesh(
                cars, half_extents, hitbox_offset, mut, inv_iw, grid, dt,
                params.game_mode, vel_pre_uu=cars_vel_pre,
                ang_vel_pre=cars_ang_vel_pre)
    else:
        cw_dv, cw_dw, cw_push, cw_contact, cw_normal = \
            contacts.resolve_car_world(
                cars, half_extents, hitbox_offset, mut, inv_iw,
                params.game_mode, vel_pre_uu=cars_vel_pre,
                ang_vel_pre=cars_ang_vel_pre)
        cw_turn = None
    cars = dataclasses.replace(
        cars, vel=cars.vel + cw_dv, ang_vel=cars.ang_vel + cw_dw,
        has_world_contact=cw_contact,
        world_contact_normal=torch.where(cw_contact[..., None], cw_normal,
                                         cars.world_contact_normal))

    # car-ball (+ the psyonix impulse cache); demoed cars have no contact
    # response, so their ball-side effects are masked by `alive`
    cb_car_dv, cb_car_dw, cb_ball_dv, cb_ball_dw, ball_cache_dv, \
        hit_updates, ball_touched = contacts.resolve_car_ball(
            cars, ball, arena.tick_count, half_extents, hitbox_offset, mut,
            inv_iw, alive, params.game_mode,
            cars_vel_pre=cars_vel_pre, ball_vel_pre=ball_vel_pre)
    cars = dataclasses.replace(cars, vel=cars.vel + cb_car_dv,
                               ang_vel=cars.ang_vel + cb_car_dw,
                               **hit_updates)
    ball = dataclasses.replace(ball, vel=ball.vel + cb_ball_dv,
                               ang_vel=ball.ang_vel + cb_ball_dw)

    # Ball::_OnHit (heatseeker target and speed-up, Ball.cpp:203-216)
    if params.game_mode == "heatseeker":
        ball = _heatseeker_on_hit(ball, ball_touched & alive,
                                  np.asarray(teams), dt)

    # ball-world (the merged special contact)
    puck_axis = ball.rot[..., :, 2] if params.game_mode == "snowday" \
        else None
    bw_dv, bw_dw, bw_push, bw_touch, bw_normal = contacts.resolve_ball_world(
        ball, mut, puck_axis, params.game_mode, vel_pre_uu=ball_vel_pre,
        grid=grid)
    ball = dataclasses.replace(ball, vel=ball.vel + bw_dv,
                               ang_vel=ball.ang_vel + bw_dw)

    # Ball::_OnWorldCollision (Ball.cpp:218-252)
    if params.game_mode == "heatseeker":
        ball, hs_bounce_dv = _heatseeker_wall_bounce(ball, bw_touch,
                                                     bw_normal)
        ball_cache_dv = ball_cache_dv + hs_bounce_dv
    elif params.game_mode == "snowday":
        # puck ground stick: a central force -normal * 70 (BT) per tick
        stick_dv = torch.where(
            bw_touch[..., None],
            -bw_normal * (C.Snowday.PUCK_GROUND_STICK_FORCE / mut.ball_mass
                          * dt * C.BT_TO_UU), 0.0)
        ball = dataclasses.replace(ball, vel=ball.vel + stick_dv)

    # car-car (+ bump/demo); masks demoed cars itself
    if num_cars > 1:
        cc_dv, cc_dw, cc_push, cc_turn, cc_cache_dv, got_demoed, bumped, \
            demo_mat, cc_updates = contacts.car_car_interactions(
                cars, tables["teams"], half_extents, hitbox_offset, mut,
                inv_iw, vel_pre=cars_vel_pre, dt=dt)
        cars = dataclasses.replace(cars, vel=cars.vel + cc_dv,
                                   ang_vel=cars.ang_vel + cc_dw,
                                   **cc_updates)
        # demolish (Car.cpp:38-41)
        cars = dataclasses.replace(
            cars, is_demoed=cars.is_demoed | got_demoed,
            demo_respawn_timer=torch.where(got_demoed, mut.respawn_delay,
                                           cars.demo_respawn_timer))
    else:
        cc_push = torch.zeros_like(cars.vel)
        cc_turn = None
        cc_cache_dv = torch.zeros_like(cars.vel)
        N = cars.pos.shape[0]
        bumped = torch.zeros(N, num_cars, num_cars, dtype=torch.bool,
                             device=dev)
        demo_mat = bumped

    # --- integrate transforms
    new_rot = m.integrate_rotation(cars.rot, cars.ang_vel, dt)
    if cw_turn is not None:
        # the split-impulse turn pseudo-velocity writeback (scaled by
        # splitImpulseTurnErp inside the solver)
        new_rot = m.integrate_rotation(new_rot, cw_turn, 1.0)
    if cc_turn is not None:
        new_rot = m.integrate_rotation(new_rot, cc_turn, 1.0)
    cars = dataclasses.replace(
        cars, pos=cars.pos + cars.vel * dt + cw_push + cc_push, rot=new_rot)
    ball_awake = ((m.norm(ball.vel) > 0) | (m.norm(ball.ang_vel) > 0))
    ball = dataclasses.replace(
        ball,
        pos=ball.pos + torch.where(ball_awake[..., None],
                                   ball.vel * dt + bw_push, 0.0),
        rot=torch.where(ball_awake[..., None, None],
                        m.integrate_rotation(ball.rot, ball.ang_vel, dt),
                        ball.rot))

    # =======================================================================
    # Post-tick (Car.cpp:133-163) + finish (Car.cpp:165-193)

    speed_sq = torch.sum(cars.vel ** 2, dim=-1)
    maintain = cars.is_supersonic & (
        cars.supersonic_time < C.SUPERSONIC_MAINTAIN_MAX_TIME)
    thresh = torch.where(maintain, C.SUPERSONIC_MAINTAIN_MIN_SPEED,
                         C.SUPERSONIC_START_SPEED)
    is_ss = speed_sq >= thresh ** 2
    cars = dataclasses.replace(
        cars, is_supersonic=is_ss,
        supersonic_time=torch.where(is_ss, cars.supersonic_time + dt, 0.0),
        car_contact_cooldown=torch.clamp(cars.car_contact_cooldown - dt,
                                         min=0.0),
        last_controls=controls)

    # finish: the bump velocity cache + clamps
    cars = dataclasses.replace(
        cars, vel=m.clamp_norm(cars.vel + cc_cache_dv, C.CAR_MAX_SPEED),
        ang_vel=m.clamp_norm(cars.ang_vel, C.CAR_MAX_ANG_SPEED))

    # ball finish (Ball.cpp:113-137): the psyonix cache + clamps
    ball = dataclasses.replace(
        ball, vel=m.clamp_norm(ball.vel + ball_cache_dv, mut.ball_max_speed),
        ang_vel=m.clamp_norm(ball.ang_vel, C.BALL_MAX_ANG_SPEED))

    # --- restore the frozen state of cars demoed at tick start (the single
    # alive-select; the reference disables their simulation entirely)
    def _sel(upd, froz):
        return torch.where(_bcast(alive, upd), upd, froz)

    cars = CarsState(**{f.name: _sel(getattr(cars, f.name),
                                     getattr(frozen_cars, f.name))
                        for f in dataclasses.fields(CarsState)})
    new_wc = WheelControlsState(**{
        f.name: _sel(getattr(new_wc, f.name), getattr(frozen_wc, f.name))
        for f in dataclasses.fields(WheelControlsState)})

    # --- boost pad pickup (BoostPad.cpp:62-105)
    pads, cars = _pads_check_and_pickup(pads, cars, alive, tables,
                                        half_extents, hitbox_offset, mut)

    if params.game_mode == "hoops":
        goal = _is_ball_scored_hoops(ball.pos)
    else:
        goal = geom.is_ball_scored(ball.pos, mut.ball_radius,
                                   mut.goal_base_threshold_y)

    # event latches: bump/demo vs the opposing team only (EnvSet.cpp:31-42)
    bump_opp = bumped & tables["opp"]          # (N, C, C): i bumped j
    demo_opp = demo_mat & tables["opp"]
    arena = dataclasses.replace(
        arena, cars=cars, ball=ball, pads=pads,
        tick_count=arena.tick_count + 1,
        goal_scored=arena.goal_scored | goal,
        step_bump=arena.step_bump | torch.any(bump_opp, dim=2),
        step_bumped=arena.step_bumped | torch.any(bump_opp, dim=1),
        step_demo=arena.step_demo | torch.any(demo_opp, dim=2),
        step_demoed=arena.step_demoed | torch.any(demo_opp, dim=1))
    return PhysicsState(arena=arena, wheels=new_wc)


# ---------------------------------------------------------------------------
# Game-mode hooks (XLA form of the JAX package's step.py:497-605)

def _wrap(x, minmax):
    """Math::WrapNormalizeFloat (Math.cpp:66-73)."""
    r = torch.fmod(x, minmax * 2)
    r = torch.where(r > minmax, r - minmax * 2, r)
    return torch.where(r < -minmax, r + minmax * 2, r)


def _round_angle_ue3(ang):
    """Math::RoundAngleUE3 (Math.cpp:75-88): UE3 rotator quantization."""
    to_ints = float(1 << 15) / np.pi
    back = (1.0 / to_ints) * 4.0
    r = (ang * to_ints).to(torch.int32) >> 2
    return (r & (0x4000 - 1)).to(torch.float32) * back


def _heatseeker_steer(ball: BallState, dt: float) -> BallState:
    """Ball::_PreTickUpdate heatseeker branch (Ball.cpp:153-200): rotate
    the velocity toward the target goal point and blend the speed."""
    HS = C.Heatseeker
    ytd = ball.hs_y_target_dir
    active = ytd != 0

    vel = ball.vel
    speed = m.norm(vel)
    d2 = torch.sqrt(vel[..., 0] ** 2 + vel[..., 1] ** 2)
    v_yaw = torch.atan2(vel[..., 1], vel[..., 0])
    v_pitch = torch.atan2(vel[..., 2], d2)

    to_goal = torch.stack([0.0 - ball.pos[..., 0],
                           HS.TARGET_Y * ytd - ball.pos[..., 1],
                           HS.TARGET_Z - ball.pos[..., 2]], dim=-1)
    g_d2 = torch.sqrt(to_goal[..., 0] ** 2 + to_goal[..., 1] ** 2)
    g_yaw = torch.atan2(to_goal[..., 1], to_goal[..., 0])
    g_pitch = torch.atan2(to_goal[..., 2], g_d2)

    # Angle::GetDeltaTo wraps yaw to +-pi and pitch to +-pi/2
    d_yaw = _wrap(g_yaw - v_yaw, np.pi)
    d_pitch = _wrap(g_pitch - v_pitch, np.pi / 2)

    f = (speed / HS.MAX_SPEED) * dt
    new_yaw = v_yaw + d_yaw * f * HS.HORIZONTAL_BLEND
    new_pitch = v_pitch + d_pitch * f * HS.VERTICAL_BLEND
    new_yaw = _wrap(new_yaw, np.pi)
    new_pitch = torch.clamp(_wrap(new_pitch, np.pi / 2),
                            -HS.MAX_TURN_PITCH, HS.MAX_TURN_PITCH)
    new_yaw = _round_angle_ue3(new_yaw)
    new_pitch = _round_angle_ue3(new_pitch)

    new_speed = speed + (ball.hs_target_speed - speed) * HS.SPEED_BLEND
    cp, sp = torch.cos(new_pitch), torch.sin(new_pitch)
    new_vel = torch.stack([cp * torch.cos(new_yaw), cp * torch.sin(new_yaw),
                           sp], dim=-1) * new_speed[..., None]

    return dataclasses.replace(
        ball, vel=torch.where(active[..., None], new_vel, ball.vel),
        hs_time_since_hit=torch.where(active, ball.hs_time_since_hit + dt,
                                      ball.hs_time_since_hit))


def _heatseeker_on_hit(ball: BallState, touched, teams, dt: float
                       ) -> BallState:
    """Ball::_OnHit heatseeker branch (Ball.cpp:204-216).  The reference
    fires _OnHit once PER touching car in index order, each call reading
    the previous call's writes, so the cars are folded in sequence."""
    HS = C.Heatseeker
    ytd = ball.hs_y_target_dir
    speed = ball.hs_target_speed
    tsince = ball.hs_time_since_hit
    for c in range(touched.shape[-1]):
        t = touched[..., c]
        new_dir = 1.0 if int(teams[c]) == 0 else -1.0
        can_increase = (tsince > HS.MIN_SPEEDUP_INTERVAL) | (ytd == 0)
        sp = t & can_increase & (ytd != new_dir)
        ytd = torch.where(t, new_dir, ytd)
        speed = torch.where(
            sp, torch.clamp(speed + HS.TARGET_SPEED_INCREMENT,
                            max=HS.MAX_SPEED), speed)
        tsince = torch.where(sp, 0.0, tsince)
    return dataclasses.replace(ball, hs_time_since_hit=tsince,
                               hs_target_speed=speed, hs_y_target_dir=ytd)


def _heatseeker_wall_bounce(ball: BallState, touching, normal):
    """Ball::_OnWorldCollision heatseeker branch (Ball.cpp:220-246): deep
    back-wall hits flip the target and add a goal-ward bounce impulse into
    the velocity cache.  Returns (ball, cache_dv)."""
    HS = C.Heatseeker
    ytd = ball.hs_y_target_dir
    rel_normal_y = normal[..., 1] * ytd
    rel_y = ball.pos[..., 1] * ytd
    flip = (touching & (ytd != 0)
            & (rel_normal_y <= -HS.WALL_BOUNCE_CHANGE_Y_NORMAL)
            & (rel_y >= C.ARENA_EXTENT_Y - HS.WALL_BOUNCE_CHANGE_Y_THRESH))
    new_ytd = torch.where(flip, -ytd, ytd)
    to_goal = torch.stack([0.0 - ball.pos[..., 0],
                           HS.TARGET_Y * new_ytd - ball.pos[..., 1],
                           HS.TARGET_Z - ball.pos[..., 2]], dim=-1)
    dir_to_goal = m.normalize(to_goal)
    up = torch.stack([torch.zeros_like(ytd), torch.zeros_like(ytd),
                      torch.full_like(ytd, HS.WALL_BOUNCE_UP_FRAC)], dim=-1)
    bounce_dir = dir_to_goal * (1.0 - HS.WALL_BOUNCE_UP_FRAC) + up
    cache_dv = torch.where(
        flip[..., None],
        bounce_dir * m.norm(ball.vel, keepdim=True)
        * HS.WALL_BOUNCE_FORCE_SCALE, 0.0)
    return dataclasses.replace(ball, hs_y_target_dir=new_ytd), cache_dv


def _is_ball_scored_hoops(ball_pos):
    """Arena::IsBallScored hoops branch (Arena.cpp:958-971): below the rim
    height and within the basket's xy region."""
    below = ball_pos[..., 2] < C.HOOPS_GOAL_SCORE_THRESHOLD_Z
    dy = torch.abs(ball_pos[..., 1]) * C.HOOPS_GOAL_SCALE_Y \
        - C.HOOPS_GOAL_OFFSET_Y
    dist_sq = ball_pos[..., 0] ** 2 + dy ** 2
    return below & (dist_sq < C.HOOPS_GOAL_RADIUS ** 2)


def _pads_check_and_pickup(pads, cars: CarsState, alive, tables: dict,
                           half_extents, hitbox_offset, mut: MutatorConfig):
    """Boost pad collision and pickup with the reference's lock
    hysteresis (BoostPad.cpp:62-105): the car that collided with a pad
    last tick (``pads.prev_locked``) keeps it by a pad-box vs car-AABB
    test; every other car must pass the cylinder test on its ORIGIN.  Cars
    are checked in index order and each colliding car overwrites the lock
    (Arena.cpp:783-796), so the HIGHEST colliding index wins the tick's
    pickup; the lock persists while the pad is on cooldown."""
    dev = cars.pos.device
    locs = tables["pad_locs"]                              # (P, 3)
    is_big = tables["pad_is_big"]
    num_cars = cars.pos.shape[-2]
    cyl_rad = torch.where(is_big, C.BoostPads.CYL_RAD_BIG,
                          C.BoostPads.CYL_RAD_SMALL)

    # the cylinder test on the car origin (the non-locked path)
    d2 = torch.sum((cars.pos[..., None, :2] - locs[:, :2]) ** 2, dim=-1)
    dz = torch.abs(cars.pos[..., None, 2] - locs[:, 2])
    cyl_hit = (d2 < cyl_rad ** 2) & (dz < C.BoostPads.CYL_HEIGHT)  # (N,C,P)

    # the AABB test (the locked path): the pad box (+-BOX_RAD in xy, z in
    # [0, 64]) vs the car compound's world AABB, |R| * the
    # margin-adjusted extents around the hitbox centre
    he_m = constant(np.asarray(formulas.box_effective_half_extents_bt(
        np.asarray(half_extents, np.float64) * 2.0) * 50.0, np.float32), dev)
    box_center = cars.pos + m.rotate(cars.rot,
                                     constant(hitbox_offset, dev))
    aabb_half = m.rotate(torch.abs(cars.rot), he_m)        # (N, C, 3)
    car_min = box_center - aabb_half
    car_max = box_center + aabb_half
    box_rad = torch.where(is_big, C.BoostPads.BOX_RAD_BIG,
                          C.BoostPads.BOX_RAD_SMALL)
    pad_min = torch.stack([locs[:, 0] - box_rad, locs[:, 1] - box_rad,
                           locs[:, 2]], dim=-1)
    pad_max = torch.stack([locs[:, 0] + box_rad, locs[:, 1] + box_rad,
                           locs[:, 2] + C.BoostPads.BOX_HEIGHT], dim=-1)
    aabb_hit = torch.all((pad_max > car_min[..., None, :])
                         & (pad_min < car_max[..., None, :]), dim=-1)

    ids = tables["ids"]
    locked = pads.prev_locked[:, None, :] == ids[:, None]  # (N, C, P)
    colliding = torch.where(locked, aabb_hit, cyl_hit) & alive[..., None]

    any_collide = torch.any(colliding, dim=1)              # (N, P)
    # the last colliding car in iteration order wins the lock
    winner = num_cars - 1 - torch.argmax(
        torch.flip(colliding, dims=[1]).to(torch.int32), dim=1)
    pickup = any_collide & pads.is_active
    winner_cp = ((tables["cars_arange"][:, None] == winner[:, None, :])
                 .to(torch.float32) * pickup[:, None, :].to(torch.float32))
    amount = torch.where(is_big, C.BoostPads.BOOST_AMOUNT_BIG,
                         C.BoostPads.BOOST_AMOUNT_SMALL)
    gained = torch.sum(winner_cp * amount, dim=-1)
    new_boost = torch.clamp(cars.boost + gained, max=C.BOOST_MAX)

    cooldown_new = torch.where(is_big, mut.boost_pad_cooldown_big,
                               mut.boost_pad_cooldown_small)
    pads = dataclasses.replace(
        pads, is_active=pads.is_active & ~pickup,
        cooldown=torch.where(pickup, cooldown_new, pads.cooldown),
        prev_locked=torch.where(any_collide, winner + 1, 0).to(torch.int32))
    cars = dataclasses.replace(cars, boost=new_boost)
    return pads, cars


# ---------------------------------------------------------------------------
# Multi-tick env step with action delay

def arena_step(phys: PhysicsState, new_controls: torch.Tensor, teams,
               respawn_idx: torch.Tensor, params: ArenaParams,
               tick_skip: int = 8, action_delay: int = 7) -> PhysicsState:
    """Step every arena ``tick_skip`` ticks; the first ``action_delay``
    ticks run with the controls already in the state (the previous
    action), then ``new_controls`` (N, C, 8) apply (EnvSet::StepFirstHalf /
    StepSecondHalf, EnvSet.cpp:113-156).  ``respawn_idx`` (N, tick_skip, C)
    holds one respawn draw per car per tick, as the JAX step draws them
    from its key (step.py:699-700)."""
    # clear the per-step latches (EnvSet GameState::ResetBeforeStep)
    arena = phys.arena
    phys = dataclasses.replace(phys, arena=dataclasses.replace(
        arena, goal_scored=torch.zeros_like(arena.goal_scored),
        step_bump=torch.zeros_like(arena.step_bump),
        step_bumped=torch.zeros_like(arena.step_bumped),
        step_demo=torch.zeros_like(arena.step_demo),
        step_demoed=torch.zeros_like(arena.step_demoed)))
    for i in range(tick_skip):
        if i == action_delay:
            phys = dataclasses.replace(phys, arena=dataclasses.replace(
                phys.arena, cars=dataclasses.replace(
                    phys.arena.cars, controls=new_controls)))
        phys = arena_tick(phys, teams, respawn_idx[:, i], params)
    return phys
