"""The portable engine's car contacts (reinforcement_learning_torch/
physics/contacts.py) against the JAX package's, from the same seeded numpy
inputs at 8 arenas: car-world (the plane arena, or the mesh manifold and
the true planes through the joint PGS), car-ball with the psyonix impulse
(and hoops' z scale) and car-car with the bump and demo logic (the ball's
contact in tests/test_torch_ball_pred.py).  The JAX functions run as
tests/test_torch_portable.py's ``_jax_eager`` says, the tolerances are
its: 1e-3 uu and uu/s with 1e-5 relative (1e-4 where impulses in BT units
pass through the 10-iteration solvers), flags exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch import maths as tm
from reinforcement_learning_torch.physics import car as tcar
from reinforcement_learning_torch.physics import contacts as tcontacts
from reinforcement_learning_torch.physics import world as tworld
from tests.test_torch_physics import CARS, TEAMS
from tests.test_torch_portable import (CAR_CASES, E, _jax_eager, _params,
                                       both_states, car_state, close_tree)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode,mesh,seed", CAR_CASES)
def test_car_contacts_match_jax(mode, mesh, seed):
    """Car-world (the plane arena, or the mesh manifold with the true
    planes through the joint PGS), car-ball with the psyonix impulse (and
    hoops' z scale) and car-car with the bump and demo logic, from the
    same states; and the closest point on a box."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import car as jcar
    from reinforcement_learning_tpu.physics import contacts as jcon
    from reinforcement_learning_tpu.physics import world as jworld
    ov = car_state(seed, mode)
    tp_cfg = _params(mode, mesh).car_config
    # cars pressed into the floor, the walls and each other, the ball
    # against car 0's bumper
    pos = ov["arena.cars.pos"].copy()
    pos[:, :, 2] = np.where(ov["arena.cars.is_on_ground"], 16.0,
                            pos[:, :, 2])
    # car 0 drives its bumper into car 1, just ahead of it
    fwd0 = ov["arena.cars.rot"][:, 0, :, 0]
    pos[:, 1] = pos[:, 0] + fwd0 * 110.0 + [0.0, 0.0, 3.0]
    ov["arena.cars.rot"][:, 1] = ov["arena.cars.rot"][:, 0]
    ov["arena.cars.vel"][:, 0] = fwd0 * 1500.0
    ov["arena.cars.vel"][:, 1] = 0.0
    pos[::2, 2, 0] = np.float32(TC.ARENA_EXTENT_X_HOOPS if mode == "hoops"
                                else 4096.0) - 50.0
    ov["arena.cars.pos"] = pos
    # the ball 0.5 uu into car 0's front face
    rot0 = ov["arena.cars.rot"][:, 0]
    he0 = np.asarray(tp_cfg.hitbox_size, np.float32) / 2.0
    radius = _params(mode, mesh).mutators.ball_radius
    centre = pos[:, 0] + np.einsum("eij,j->ei", rot0,
                                   np.float32(tp_cfg.hitbox_offset))
    ov["arena.ball.pos"] = np.float32(centre + rot0[:, :, 0]
                                      * (he0[0] + radius - 0.5))
    ov["arena.cars.car_contact_cooldown"] = np.zeros((E, CARS), np.float32)
    jphys, tphys = both_states(ov, mode, mesh)
    jp, tp = _params(mode, mesh, True), _params(mode, mesh)
    cfg, mut, dt = tp.car_config, tp.mutators, tp.dt
    jc, tc = jphys.arena.cars, tphys.arena.cars
    he = np.asarray(cfg.hitbox_size, np.float32) / 2.0
    off = np.asarray(cfg.hitbox_offset, np.float32)
    inv_l = tcar.car_tables(cfg, mut.car_mass, torch.device("cpu"))[
        "inv_i_local"]
    t_iw = tcar.inv_inertia_world(tc.rot, inv_l)
    j_iw = jnp.asarray(t_iw.numpy())
    vpre = np.asarray(jc.vel) * np.float32(0.98)
    wpre = np.asarray(jc.ang_vel) * np.float32(0.99)
    tv, tw = torch.from_numpy(vpre), torch.from_numpy(wpre)
    if mesh:
        jgrid, tgrid = jworld.get_grid(mode), tworld.get_grid(mode, "cpu")
        want = _jax_eager(lambda c, iw, vp, wp: jcon.resolve_car_world_mesh(
            c, he, off, jp.mutators, iw, jgrid, dt, mode, vel_pre_uu=vp,
            ang_vel_pre=wp), jc, j_iw, vpre, wpre)
        got = tcontacts.resolve_car_world_mesh(
            tc, he, off, mut, t_iw, tgrid, dt, mode, vel_pre_uu=tv,
            ang_vel_pre=tw)
    else:
        want = _jax_eager(lambda c, iw, vp, wp: jcon.resolve_car_world(
            c, he, off, jp.mutators, iw, mode, vel_pre_uu=vp,
            ang_vel_pre=wp), jc, j_iw, vpre, wpre)
        got = tcontacts.resolve_car_world(tc, he, off, mut, t_iw, mode,
                                          vel_pre_uu=tv, ang_vel_pre=tw)
    close_tree(got, want, what="car-world")
    assert np.asarray(want[-2]).any()

    alive = ~np.asarray(jc.is_demoed)
    bvpre = np.asarray(jphys.arena.ball.vel) * np.float32(0.98)
    want = _jax_eager(lambda c, b, tick, iw, al, vp, bp: jcon.resolve_car_ball(
        c, b, tick, he, off, jp.mutators, iw, al, mode, cars_vel_pre=vp,
        ball_vel_pre=bp), jc, jphys.arena.ball, jphys.arena.tick_count,
        j_iw, alive, vpre, bvpre)
    got = tcontacts.resolve_car_ball(
        tc, tphys.arena.ball, tphys.arena.tick_count, he, off, mut, t_iw,
        torch.from_numpy(alive), mode, cars_vel_pre=tv,
        ball_vel_pre=torch.from_numpy(bvpre))
    close_tree(got, want, what="car-ball")
    assert np.asarray(want[-1]).any()

    teams = np.asarray(TEAMS, np.int32)
    want = _jax_eager(lambda c, iw, vp: jcon.car_car_interactions(
        c, jnp.asarray(teams), he, off, jp.mutators, iw, vel_pre=vp, dt=dt),
        jc, j_iw, vpre)
    got = tcontacts.car_car_interactions(
        tc, torch.from_numpy(teams), he, off, mut, t_iw, vel_pre=tv, dt=dt)
    close_tree(got, want, 1e-4, 1e-4, "car-car")
    assert np.asarray(want[6]).any()

    box_c = tc.pos + tm.rotate(tc.rot, torch.from_numpy(off))
    got = tcontacts.closest_point_on_box(
        tphys.arena.ball.pos[:, None, :].expand(tc.pos.shape), box_c,
        tc.rot, torch.from_numpy(he))
    want = _jax_eager(lambda p, c, r: jcon.closest_point_on_box(
        p, c, r, jnp.asarray(he)), np.broadcast_to(
            np.asarray(jphys.arena.ball.pos)[:, None], tc.pos.shape),
        box_c.numpy(), tc.rot.numpy())
    close_tree(got, want, what="closest_point_on_box")
    assert jcar  # the module the tick pairs these with
