"""Layout conversion: batched PhysicsState <-> component state dict.

The env layer keeps ``PhysicsState`` with a leading env axis ``(E, C, ...)``
and trailing xyz axes.  The tick wants struct-of-arrays components with the
env axis innermost: per-car fields ``(C, E)``, per-env fields ``(E,)``, every
vector a tuple of 3 such tensors and every rotation a 3x3 nested tuple.  A
CUDA thread per arena then reads neighbouring addresses as its neighbours
do.  The conversion happens once per env step, not per tick.
"""

from __future__ import annotations

import torch

from perfbench.reference.rlt.physics.state import WheelControlsState
from perfbench.reference.rlt.physics.state import (ArenaState, BallState,
                                                        CarsState, PadsState)
from perfbench.reference.rlt.physics.step import PhysicsState

CAR_SCALARS_F32 = (
    'jump_time', 'flip_time', 'air_time', 'air_time_since_jump', 'boost',
    'time_spent_boosting', 'supersonic_time', 'handbrake_val',
    'auto_flip_timer', 'auto_flip_torque_scale', 'car_contact_cooldown',
    'demo_respawn_timer')
CAR_BOOLS = (
    'is_on_ground', 'has_jumped', 'has_double_jumped', 'has_flipped',
    'is_flipping', 'is_jumping', 'is_supersonic', 'is_auto_flipping',
    'has_world_contact', 'is_demoed', 'ball_hit_valid')
CAR_VECS = (
    'pos', 'vel', 'ang_vel', 'flip_rel_torque', 'world_contact_normal',
    'ball_hit_rel_pos', 'ball_hit_ball_pos', 'ball_hit_extra_vel')
CAR_INTS = ('car_contact_other_id', 'ball_hit_tick',
            'ball_hit_extra_impulse_tick')
LATCHES = ('step_bump', 'step_bumped', 'step_demo', 'step_demoed')


def _t(a):
    """(E, C) -> (C, E)."""
    return a.transpose(0, 1)


def to_components(phys: PhysicsState) -> dict:
    """Batched PhysicsState (leading env axis E) -> component dict."""
    arena = phys.arena
    cars = arena.cars
    d = {}
    for f in CAR_SCALARS_F32 + CAR_BOOLS + CAR_INTS:
        d[f] = _t(getattr(cars, f))
    for f in CAR_VECS:
        a = getattr(cars, f)
        d[f] = tuple(_t(a[..., i]) for i in range(3))
    d['rot'] = tuple(tuple(_t(cars.rot[..., i, j]) for j in range(3))
                     for i in range(3))
    d['wheels_with_contact'] = [_t(cars.wheels_with_contact[..., w])
                                for w in range(4)]
    d['last_controls'] = tuple(_t(cars.last_controls[..., c])
                               for c in range(8))
    d['controls'] = tuple(_t(cars.controls[..., c]) for c in range(8))
    wc = phys.wheels
    d['wc'] = dict(
        steer_angle=_t(wc.steer_angle), engine_force=_t(wc.engine_force),
        brake=_t(wc.brake),
        lat_friction=[_t(wc.lat_friction[..., w]) for w in range(4)],
        long_friction=[_t(wc.long_friction[..., w]) for w in range(4)])
    ball = arena.ball
    d['ball_pos'] = tuple(ball.pos[..., i] for i in range(3))
    d['ball_vel'] = tuple(ball.vel[..., i] for i in range(3))
    d['ball_ang_vel'] = tuple(ball.ang_vel[..., i] for i in range(3))
    d['ball_rot'] = tuple(tuple(ball.rot[..., i, j] for j in range(3))
                          for i in range(3))
    d['ball_hs'] = (ball.hs_y_target_dir, ball.hs_target_speed,
                    ball.hs_time_since_hit)
    pads = arena.pads
    d['pads_active'] = _t(pads.is_active)
    d['pads_cooldown'] = _t(pads.cooldown)
    d['pads_locked'] = _t(pads.prev_locked)
    d['tick_count'] = arena.tick_count
    d['goal_scored'] = arena.goal_scored
    for f in LATCHES:
        d[f] = _t(getattr(arena, f))
    return d


def from_components(d: dict) -> PhysicsState:
    """Inverse of to_components (fresh contiguous tensors)."""
    def car(a):
        return _t(a).contiguous()

    def vec(t):
        return torch.stack([_t(c) for c in t], dim=-1)

    def mat(t, per_car=True):
        f = _t if per_car else (lambda x: x)
        return torch.stack([torch.stack([f(t[i][j]) for j in range(3)], -1)
                            for i in range(3)], dim=-2)

    kw = {}
    for f in CAR_SCALARS_F32 + CAR_BOOLS + CAR_INTS:
        kw[f] = car(d[f])
    for f in CAR_VECS:
        kw[f] = vec(d[f])
    kw['rot'] = mat(d['rot'])
    kw['wheels_with_contact'] = vec(d['wheels_with_contact'])
    kw['last_controls'] = vec(d['last_controls'])
    kw['controls'] = vec(d['controls'])
    ball = BallState(
        pos=torch.stack(d['ball_pos'], -1),
        rot=mat(d['ball_rot'], per_car=False),
        vel=torch.stack(d['ball_vel'], -1),
        ang_vel=torch.stack(d['ball_ang_vel'], -1),
        hs_y_target_dir=d['ball_hs'][0].contiguous(),
        hs_target_speed=d['ball_hs'][1].contiguous(),
        hs_time_since_hit=d['ball_hs'][2].contiguous())
    pads = PadsState(is_active=car(d['pads_active']),
                     cooldown=car(d['pads_cooldown']),
                     prev_locked=car(d['pads_locked']))
    arena = ArenaState(
        cars=CarsState(**kw), ball=ball, pads=pads,
        tick_count=d['tick_count'].contiguous(),
        goal_scored=d['goal_scored'].contiguous(),
        **{f: car(d[f]) for f in LATCHES})
    wcd = d['wc']
    wheels = WheelControlsState(
        steer_angle=car(wcd['steer_angle']),
        engine_force=car(wcd['engine_force']), brake=car(wcd['brake']),
        lat_friction=vec(wcd['lat_friction']),
        long_friction=vec(wcd['long_friction']))
    return PhysicsState(arena=arena, wheels=wheels)
