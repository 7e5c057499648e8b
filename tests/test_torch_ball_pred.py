"""The ball on the port's portable engine: the merged ball-world contact
(``contacts.resolve_ball_world``: the planes, the mesh manifold with its
retention and internal-edge adjustment, the snowday puck) against the JAX
package's from the same balls touching walls, fillets, corners, the goal
mouth and the hoops rim; and ball prediction
(reinforcement_learning_torch/physics/ball_pred.py, batched over balls):
tests/test_ball_pred.py's two tests (the predictor reproduces the
engine's ball with no car near it, to 1e-3 uu; the tracker's API), and
``predict_ball`` against the JAX ``ball_only_tick`` tick by tick.  The
JAX functions run as tests/test_torch_portable.py's ``_jax_eager`` says;
tolerances 1e-3 uu and uu/s with 1e-5 relative, flags exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.physics import ball_pred as tpred
from reinforcement_learning_torch.physics import contacts as tcontacts
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.physics import world as tworld
from reinforcement_learning_torch.physics.state import BallState
from tests.test_torch_physics import E, _rotmat
from tests.test_torch_portable import (_jax_eager, _params, both_states,
                                       close_tree)

torch.set_num_threads(1)


BALL_CASES = [("soccar", True), ("soccar", False), ("hoops", True),
              ("snowday", True), ("snowday", False)]


def _wall_balls(mode: str) -> dict:
    """Balls touching the arena: fillets, walls, corners, the goal mouth,
    the hoops rim and backboard, the floor."""
    if mode == "hoops":
        cy = TC.HOOPS_GOAL_OFFSET_Y / TC.HOOPS_GOAL_SCALE_Y
        ex = TC.ARENA_EXTENT_X_HOOPS
        pos = [[0, cy, 300], [736, cy, 460], [0, cy - 880, 250],
               [ex - 100, 500, 1000], [ex - 120, 2000, 150],
               [0, 0, 95], [-ex + 90, -3000, 95], [300, -3400, 1700]]
    else:
        pos = [[3972, 0, 124], [3972, 700, 124], [150, 5850, 300],
               [-40, 5060, 700], [3850, 4060, 400], [-3850, -4060, 250],
               [3939, 1000, 1891], [0, 0, 93]]
    rng = np.random.RandomState(len(mode))
    pos = _touching(np.float32(pos), mode)
    return {"arena.ball.pos": pos,
            "arena.ball.vel": rng.uniform(-900, 900, (E, 3)).astype(
                np.float32),
            "arena.ball.ang_vel": rng.uniform(-3, 3, (E, 3)).astype(
                np.float32),
            "arena.ball.rot": _rotmat(rng.uniform(-3, 3, E),
                                      rng.uniform(-1.4, 1.4, E),
                                      rng.uniform(-3, 3, E))}


def _touching(pos, mode):
    """Ball centres moved along the nearest surface's normal to 0.5 uu
    inside it (the port's mesh and plane queries find it)."""
    from reinforcement_learning_torch.physics import arena_geom as tgeom
    radius = tstep.ArenaParams(1, game_mode=mode).mutators.ball_radius
    p = torch.from_numpy(pos)
    n, depth, act = tworld.get_grid(mode, "cpu").sphere_contacts(p, 5000.0)
    dist = torch.where(act, 5000.0 - depth, torch.inf)
    pn, _ = tgeom.get_planes(mode, "cpu")
    dp = torch.where(tgeom.plane_validity(p, mode),
                     tgeom.signed_distances(p, mode), torch.inf)
    k, kp = torch.argmin(dist, -1), torch.argmin(dp, -1)
    dm = torch.gather(dist, -1, k[:, None])[:, 0]
    nm = torch.gather(n, -2, k[:, None, None].expand(-1, 1, 3))[:, 0]
    dpl = torch.gather(dp, -1, kp[:, None])[:, 0]
    use_mesh = dm < dpl
    d = torch.where(use_mesh, dm, dpl)
    nrm = torch.where(use_mesh[:, None], nm, pn[kp])
    return (p + nrm * (radius - 0.5 - d)[:, None]).numpy()


@pytest.mark.parametrize("mode,mesh", BALL_CASES)
def test_resolve_ball_world_matches_jax(mode, mesh):
    """The merged ball-world contact against the planes and the mesh
    manifold (the 4-slot retention and the internal-edge adjustment), and
    the snowday puck's cylinder support."""
    from reinforcement_learning_tpu.physics import contacts as jcon
    from reinforcement_learning_tpu.physics import world as jworld
    jphys, tphys = both_states(_wall_balls(mode), mode, mesh)
    mut, jmut = _params(mode, mesh).mutators, _params(mode, mesh,
                                                       True).mutators
    jb, tb = jphys.arena.ball, tphys.arena.ball
    puck = mode == "snowday"
    jgrid = jworld.get_grid(mode) if mesh else None
    tgrid = tworld.get_grid(mode, "cpu") if mesh else None
    vpre = np.asarray(jb.vel) * np.float32(0.97)
    want = _jax_eager(lambda b, vp: jcon.resolve_ball_world(
        b, jmut, b.rot[:, 2] if puck else None, mode, vel_pre_uu=vp,
        grid=jgrid), jb, vpre)
    got = tcontacts.resolve_ball_world(
        tb, mut, tb.rot[..., :, 2] if puck else None, mode,
        vel_pre_uu=torch.from_numpy(vpre), grid=tgrid)
    close_tree(got, want, what="resolve_ball_world")
    assert np.asarray(want[3]).sum() >= E // 2


def test_prediction_matches_engine():
    """The ball-only predictor reproduces the full engine's ball
    trajectory exactly when no car interferes."""
    params = tstep.ArenaParams(num_cars=1)
    phys = tstep.make_physics_state(params, batch=(2,), device="cpu")
    ball = phys.arena.ball
    ball.pos = torch.tensor([[800.0, -2000.0, 600.0], [-300.0, 4000.0, 150.0]])
    ball.vel = torch.tensor([[400.0, 900.0, -200.0], [-500.0, 1200.0, 0.0]])
    ball.ang_vel = torch.tensor([[1.0, -2.0, 0.5], [0.0, 3.0, 0.0]])
    # the car parked far from the balls' paths
    phys.arena.cars.pos = torch.tensor([[[-3000.0, 3000.0, 17.01]],
                                        [[3000.0, -3000.0, 17.01]]])
    T = 120
    pred = tpred.predict_ball(ball, params.mutators, T)
    controls = torch.zeros(2, 1, 8)
    r = torch.zeros(2, 8, 1, dtype=torch.int32)
    for i in range(T // 8):
        phys = tstep.arena_step(phys, controls, (0,), r, params)
        torch.testing.assert_close(pred.pos[:, (i + 1) * 8 - 1],
                                   phys.arena.ball.pos, atol=1e-3, rtol=0)


def test_tracker_api():
    params = tstep.ArenaParams(num_cars=1)
    ball = tstep.make_physics_state(params, batch=(3,), device="cpu"
                                    ).arena.ball
    ball.pos = torch.tensor([[0.0, 0.0, 1000.0]] * 3)
    ball.vel = torch.tensor([[0.0, 0.0, -100.0], [10.0, 0.0, -100.0],
                             [0.0, 0.0, 300.0]])
    tr = tpred.BallPredTracker(num_pred_ticks=60)
    pred = tr.update(ball)
    assert pred.pos.shape == (3, 60, 3)
    # predData[0] is the CURRENT state (BallPredTracker.cpp semantics)
    torch.testing.assert_close(pred.pos[:, 0], ball.pos, atol=1e-6, rtol=0)
    s = tr.get_ball_state_for_time(0.0)
    torch.testing.assert_close(s.pos, ball.pos, atol=1e-6, rtol=0)
    s = tr.get_ball_state_for_time(0.25)   # floor(0.25 * 120) = tick 30
    torch.testing.assert_close(s.pos, pred.pos[:, 30], atol=1e-6, rtol=0)
    assert float(pred.pos[0, 30, 2]) < 1000.0   # falling under gravity


@pytest.mark.parametrize("mode", ["soccar", "hoops", "snowday"])
def test_ball_only_tick_matches_jax(mode):
    """``predict_ball`` over 8 balls against the JAX ``ball_only_tick``
    run eagerly, tick by tick, off walls, fillets, the floor and the
    hoops rim."""
    import jax
    from reinforcement_learning_tpu.physics import ball_pred as jpred
    jphys, tphys = both_states(_wall_balls(mode), mode, True)
    mut = _params(mode, True).mutators
    jmut = _params(mode, True, True).mutators
    ticks = 4
    pred = tpred.predict_ball(tphys.arena.ball, mut, ticks, mode)
    jb = jphys.arena.ball
    for t in range(ticks):
        jb = _jax_eager(lambda b: jpred.ball_only_tick(b, jmut, mode), jb)
        got = BallState(**{f.name: getattr(pred, f.name)[:, t]
                           for f in dataclasses.fields(BallState)})
        close_tree(got, jb, 1e-3, 1e-5, f"tick {t}")
    assert jax
