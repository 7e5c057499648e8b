"""Physics state as dataclasses of tensors.

Field names and shapes follow the reference ``CarState`` / ``BallState`` /
``BoostPadState`` (Car.h:17-115, Ball.h:17-46, BoostPad.h:36-58).  Every
per-car field has a car axis ``C``; a batch of arenas puts the env axis
``E`` in front, so a batched field is ``(E, C, ...)``.  Booleans are
``torch.bool``; integers are ``torch.int32``.

Controls layout: [throttle, steer, pitch, yaw, roll, jump, boost, handbrake].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt.device import resolve_device

THROTTLE, STEER, PITCH, YAW, ROLL, JUMP, BOOST, HANDBRAKE = range(8)
NUM_CONTROLS = 8

Tensor = torch.Tensor


@dataclasses.dataclass
class CarsState:
    pos: Tensor            # (C, 3)
    rot: Tensor            # (C, 3, 3) columns forward/right/up
    vel: Tensor            # (C, 3)
    ang_vel: Tensor        # (C, 3)

    is_on_ground: Tensor          # (C,) bool
    wheels_with_contact: Tensor   # (C, 4) bool
    has_jumped: Tensor
    has_double_jumped: Tensor
    has_flipped: Tensor
    flip_rel_torque: Tensor       # (C, 3)
    jump_time: Tensor
    flip_time: Tensor
    is_flipping: Tensor
    is_jumping: Tensor
    air_time: Tensor
    air_time_since_jump: Tensor
    boost: Tensor
    time_spent_boosting: Tensor
    is_supersonic: Tensor
    supersonic_time: Tensor
    handbrake_val: Tensor
    is_auto_flipping: Tensor
    auto_flip_timer: Tensor
    auto_flip_torque_scale: Tensor

    has_world_contact: Tensor
    world_contact_normal: Tensor  # (C, 3)

    car_contact_other_id: Tensor  # (C,) int32 (0 = none)
    car_contact_cooldown: Tensor

    is_demoed: Tensor
    demo_respawn_timer: Tensor

    ball_hit_valid: Tensor
    ball_hit_rel_pos: Tensor      # (C, 3)
    ball_hit_tick: Tensor         # (C,) int32
    ball_hit_extra_impulse_tick: Tensor  # (C,) int32
    ball_hit_ball_pos: Tensor     # (C, 3)
    ball_hit_extra_vel: Tensor    # (C, 3)

    last_controls: Tensor         # (C, 8)
    controls: Tensor              # (C, 8)

    @property
    def forward(self):
        return self.rot[..., :, 0]

    @property
    def right(self):
        return self.rot[..., :, 1]

    @property
    def up(self):
        return self.rot[..., :, 2]

    def has_flip_or_jump(self):
        """CarState::HasFlipOrJump (Car.cpp:285-289)."""
        return self.is_on_ground | (
            ~self.has_flipped & ~self.has_double_jumped
            & (self.air_time_since_jump < C.DOUBLEJUMP_MAX_DELAY))


@dataclasses.dataclass
class BallState:
    pos: Tensor      # (3,)
    rot: Tensor      # (3, 3)
    vel: Tensor      # (3,)
    ang_vel: Tensor  # (3,)
    hs_y_target_dir: Tensor     # () heatseeker state, carried untouched
    hs_target_speed: Tensor
    hs_time_since_hit: Tensor


@dataclasses.dataclass
class PadsState:
    is_active: Tensor    # (34,) bool
    cooldown: Tensor     # (34,)
    prev_locked: Tensor  # (34,) int32: id+1 of last tick's colliding car


@dataclasses.dataclass
class ArenaState:
    cars: CarsState
    ball: BallState
    pads: PadsState
    tick_count: Tensor   # () int32
    goal_scored: Tensor  # () bool
    step_bump: Tensor    # (C,) bool, per env step, opposing team only
    step_bumped: Tensor
    step_demo: Tensor
    step_demoed: Tensor


@dataclasses.dataclass(frozen=True)
class MutatorConfig:
    """Per-arena tunables (MutatorConfig.h:16-75)."""
    gravity_z: float = C.GRAVITY_Z
    car_mass: float = C.CAR_MASS_BT
    car_world_friction: float = C.CARWORLD_COLLISION_FRICTION
    car_world_restitution: float = C.CARWORLD_COLLISION_RESTITUTION
    ball_mass: float = C.BALL_MASS_BT
    ball_max_speed: float = C.BALL_MAX_SPEED
    ball_drag: float = C.BALL_DRAG
    ball_world_friction: float = C.BALL_FRICTION
    ball_world_restitution: float = C.BALL_RESTITUTION
    jump_accel: float = C.JUMP_ACCEL
    jump_immediate_force: float = C.JUMP_IMMEDIATE_FORCE
    boost_accel_ground: float = C.BOOST_ACCEL_GROUND
    boost_accel_air: float = C.BOOST_ACCEL_AIR
    boost_used_per_second: float = C.BOOST_USED_PER_SECOND
    respawn_delay: float = C.DEMO_RESPAWN_TIME
    bump_cooldown_time: float = C.BUMP_COOLDOWN_TIME
    boost_pad_cooldown_big: float = C.BoostPads.COOLDOWN_BIG
    boost_pad_cooldown_small: float = C.BoostPads.COOLDOWN_SMALL
    car_spawn_boost_amount: float = C.BOOST_SPAWN_AMOUNT
    ball_hit_extra_force_scale: float = 1.0
    bump_force_scale: float = 1.0
    ball_radius: float = C.BALL_COLLISION_RADIUS_SOCCAR
    unlimited_flips: bool = False
    unlimited_double_jumps: bool = False
    demo_mode: str = "NORMAL"  # NORMAL | ON_CONTACT | DISABLED
    enable_team_demos: bool = False
    goal_base_threshold_y: float = C.SOCCAR_GOAL_SCORE_BASE_THRESHOLD_Y

    @classmethod
    def for_mode(cls, game_mode: str) -> "MutatorConfig":
        """Game-mode defaults (MutatorConfig.cpp:5-34)."""
        kw = {}
        if game_mode == "hoops":
            kw["ball_radius"] = C.BALL_COLLISION_RADIUS_HOOPS
        elif game_mode == "snowday":
            kw["ball_radius"] = C.Snowday.PUCK_RADIUS
            kw["ball_world_friction"] = C.Snowday.PUCK_FRICTION
            kw["ball_world_restitution"] = C.Snowday.PUCK_RESTITUTION
            kw["ball_mass"] = C.Snowday.PUCK_MASS_BT
        if game_mode == "heatseeker":
            kw["car_spawn_boost_amount"] = 100.0
            kw["boost_used_per_second"] = 0.0
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class CarConfig:
    """Car preset (CarConfig.h/.cpp); one preset for all cars of an arena."""
    hitbox_size: tuple = tuple(C.HITBOX_SIZES[C.OCTANE])
    hitbox_offset: tuple = tuple(C.HITBOX_OFFSETS[C.OCTANE])
    front_wheel_radius: float = float(C.FRONT_WHEEL_RADS[C.OCTANE])
    back_wheel_radius: float = float(C.BACK_WHEEL_RADS[C.OCTANE])
    front_sus_rest: float = float(C.FRONT_WHEEL_SUS_REST[C.OCTANE])
    back_sus_rest: float = float(C.BACK_WHEEL_SUS_REST[C.OCTANE])
    front_wheel_offset: tuple = tuple(C.FRONT_WHEELS_OFFSET[C.OCTANE])
    back_wheel_offset: tuple = tuple(C.BACK_WHEELS_OFFSET[C.OCTANE])
    dodge_deadzone: float = C.DODGE_DEADZONE

    def wheel_offsets(self):
        """(4, 3) suspension points, local frame: front-right, front-left,
        back-right, back-left (Car.cpp:243-264)."""
        f = np.asarray(self.front_wheel_offset, np.float32)
        b = np.asarray(self.back_wheel_offset, np.float32)
        flip = np.array([1, -1, 1], np.float32)
        return np.stack([f, f * flip, b, b * flip])

    def wheel_radii(self):
        return np.array([self.front_wheel_radius] * 2
                        + [self.back_wheel_radius] * 2, np.float32)

    def sus_rest_lengths(self):
        """Rest lengths after MAX_SUSPENSION_TRAVEL (Car.cpp:255-258)."""
        rest = np.array([self.front_sus_rest] * 2 + [self.back_sus_rest] * 2,
                        np.float32)
        return rest - C.BTVehicle.MAX_SUSPENSION_TRAVEL

    def sus_force_scales(self):
        return np.array([C.BTVehicle.SUSPENSION_FORCE_SCALE_FRONT] * 2
                        + [C.BTVehicle.SUSPENSION_FORCE_SCALE_BACK] * 2,
                        np.float32)


def _zeros(batch, *shape, dtype=torch.float32, device=None):
    return torch.zeros(tuple(batch) + shape, dtype=dtype, device=device)


def make_cars_state(num_cars: int, mutators: MutatorConfig | None = None,
                    batch=(), device=None) -> CarsState:
    """Default cars (Car.h:17-115): at rest near the origin; the caller
    then sets pos/rot.  ``batch`` prefixes every field (e.g. ``(E,)``)."""
    n = num_cars
    boost0 = (mutators.car_spawn_boost_amount if mutators is not None
              else C.BOOST_SPAWN_AMOUNT)
    f = lambda *s: _zeros(batch, n, *s, device=device)
    b = lambda *s: _zeros(batch, n, *s, dtype=torch.bool, device=device)
    i = lambda *s: _zeros(batch, n, *s, dtype=torch.int32, device=device)
    pos = f(3)
    pos[..., 2] = C.CAR_SPAWN_REST_Z
    rot = torch.eye(3, device=device).expand(tuple(batch) + (n, 3, 3)).clone()
    return CarsState(
        pos=pos, rot=rot, vel=f(3), ang_vel=f(3),
        is_on_ground=torch.ones(tuple(batch) + (n,), dtype=torch.bool,
                                device=device),
        wheels_with_contact=b(4),
        has_jumped=b(), has_double_jumped=b(), has_flipped=b(),
        flip_rel_torque=f(3), jump_time=f(), flip_time=f(),
        is_flipping=b(), is_jumping=b(), air_time=f(),
        air_time_since_jump=f(),
        boost=torch.full(tuple(batch) + (n,), boost0, device=device),
        time_spent_boosting=f(), is_supersonic=b(), supersonic_time=f(),
        handbrake_val=f(), is_auto_flipping=b(), auto_flip_timer=f(),
        auto_flip_torque_scale=f(), has_world_contact=b(),
        world_contact_normal=f(3), car_contact_other_id=i(),
        car_contact_cooldown=f(), is_demoed=b(), demo_respawn_timer=f(),
        ball_hit_valid=b(), ball_hit_rel_pos=f(3), ball_hit_tick=i(),
        ball_hit_extra_impulse_tick=i(), ball_hit_ball_pos=f(3),
        ball_hit_extra_vel=f(3), last_controls=f(NUM_CONTROLS),
        controls=f(NUM_CONTROLS))


def make_ball_state(batch=(), device=None) -> BallState:
    pos = _zeros(batch, 3, device=device)
    pos[..., 2] = C.BALL_REST_Z
    return BallState(
        pos=pos,
        rot=torch.eye(3, device=device).expand(tuple(batch) + (3, 3)).clone(),
        vel=_zeros(batch, 3, device=device),
        ang_vel=_zeros(batch, 3, device=device),
        hs_y_target_dir=_zeros(batch, device=device),
        hs_target_speed=torch.full(tuple(batch),
                                   C.Heatseeker.INITIAL_TARGET_SPEED,
                                   device=device),
        hs_time_since_hit=_zeros(batch, device=device))


def make_pads_state(game_mode: str = "soccar", batch=(),
                    device=None) -> PadsState:
    n = (C.NUM_BOOST_PADS_HOOPS if game_mode == "hoops"
         else C.NUM_BOOST_PADS)
    return PadsState(
        is_active=torch.ones(tuple(batch) + (n,), dtype=torch.bool,
                             device=device),
        cooldown=_zeros(batch, n, device=device),
        prev_locked=_zeros(batch, n, dtype=torch.int32, device=device))


def make_arena_state(num_cars: int, mutators: MutatorConfig | None = None,
                     game_mode: str = "soccar", batch=(),
                     device=None) -> ArenaState:
    device = resolve_device(device)
    b = lambda: _zeros(batch, num_cars, dtype=torch.bool, device=device)
    return ArenaState(
        cars=make_cars_state(num_cars, mutators, batch, device),
        ball=make_ball_state(batch, device),
        pads=make_pads_state(game_mode, batch, device),
        tick_count=_zeros(batch, dtype=torch.int32, device=device),
        goal_scored=_zeros(batch, dtype=torch.bool, device=device),
        step_bump=b(), step_bumped=b(), step_demo=b(), step_demoed=b())


@dataclasses.dataclass
class WheelControlsState:
    """Wheel drive values persisted across ticks: the engine, brake, steer
    and friction values a tick's friction impulses use are the previous
    tick's (the reference calls updateVehicleFirst before _UpdateWheels,
    Car.cpp:90 vs :109)."""
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
