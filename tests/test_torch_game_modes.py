"""Heatseeker and snowday in the port against the JAX package on the CPU:
the mutator defaults and the kickoff, each game-mode hook of the physics
step live against the JAX functions on point batches, and the whole step
against golden ``ctick.step`` traces.

``ctick.step`` at full fidelity is far too slow for a unit test (more than
ten minutes to jit on XLA:CPU, some 150 s per env step of 8 arenas run
eagerly), so its traces for two scenarios are stored in
``tests/data/torch_game_modes_golden.npz``, made eagerly under
``jax.disable_jit`` with a hash of the JAX sources they came from:

* ``heatseeker`` (full fidelity): the ball steering in flight toward
  either goal (arenas 0-1); a blue and an orange car driving into the
  resting ball from both sides so that both touch in the same tick, from
  idle, within the minimum speed-up interval of the last hit and after it
  (2-4); the ball into a back wall beside the goal it seeks, which flips
  its target (5-7);
* ``snowday`` (full fidelity): a tumbling puck dropped on the floor
  (0-3), a tilted puck sliding into a side wall (4-5) and into a corner
  (6-7).

Regenerate with ``python -m tests.test_torch_game_modes`` (two processes,
about 6 minutes on an idle host).

Tolerances: the hooks are the same float32 operations in the same order
as ``ctick``'s, so they agree to 1e-4 or exactly, with one exception: the
JAX kernel's atan2 is a polynomial (``cvec.atan2``, error ~1e-6 rad, a
Mosaic workaround) where the port uses the true atan2, as the JAX XLA
path does (``step._heatseeker_steer``).  The steered angles are quantised
to 4*pi/32768 rad, so where the two atan2s straddle a quantum boundary the
steered velocity differs by one quantum (about 1 uu/s at heatseeker
speeds); ``test_hs_steer_matches_both_jax_twins`` counts those rows.  The
traces are held to ``ops.ctick.TOLERANCES``: tests/test_ctick.py's
``_assert_close`` (:105-134) and its heatseeker tolerances (:334-500),
the hit state (``hs_y_target_dir``) exact, the target speed to 1e-4 and
the time since the hit to 1e-6; the ball velocity to 0.2 uu/s plus 1e-4
of itself, tighter than the 0.5 uu/s of test_ctick's steering and
back-wall tests (:360, :500) since the port follows ``ctick`` itself
(no steered angle straddles a quantum in these scenarios).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs import state_setters as tsetters
from reinforcement_learning_torch.ops import arena_step as arena_step_mod
from reinforcement_learning_torch.ops import ctick as tctick
from reinforcement_learning_torch.physics import state as tstate
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_tpu import constants as JC
from reinforcement_learning_tpu.envs import state_setters as jsetters
from reinforcement_learning_tpu.ops import ctick as jctick
from reinforcement_learning_tpu.physics import state as jstate
from reinforcement_learning_tpu.physics import step as jstep
try:
    from test_torch_physics import (CARS, E, MESH_REFERENCE_SOURCES, TEAMS,
                                    _follow_trace, _from_flat, _load_golden,
                                    _rotmat, _stored, flatten,
                                    random_overrides, reference_hash)
except ModuleNotFoundError:      # python -m tests.test_torch_game_modes
    from tests.test_torch_physics import (CARS, E, MESH_REFERENCE_SOURCES,
                                          TEAMS, _follow_trace, _from_flat,
                                          _load_golden, _rotmat, _stored,
                                          flatten, random_overrides,
                                          reference_hash)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(DATA, "torch_game_modes_golden.npz")
B = 512          # point-batch rows
HS = TC.Heatseeker
QUANTUM = 4.0 * np.pi / 32768.0


def _params(mode, mesh=True):
    return tstep.ArenaParams(num_cars=CARS, use_mesh=mesh,
                             dynamic_wheel_rays=mesh, game_mode=mode)


@functools.lru_cache(maxsize=None)
def _consts(mode, mesh=False):
    """(JAX consts, port consts) of the mode."""
    jp = jstep.ArenaParams(num_cars=CARS, use_mesh=mesh,
                           dynamic_wheel_rays=mesh, game_mode=mode)
    return (jctick.make_consts(jp, np.asarray(TEAMS)),
            tctick.make_consts(_params(mode, mesh), np.asarray(TEAMS)))


def _vec(a):
    """(n, 3) numpy -> (JAX component tuple, port component tuple)."""
    a = np.asarray(a, np.float32)
    return (tuple(jnp.asarray(a[:, i]) for i in range(3)),
            tuple(torch.from_numpy(a[:, i].copy()) for i in range(3)))


def _np(v):
    return np.stack([np.asarray(x) for x in v], -1)


# ---------------------------------------------------------------------------
# mutators and kickoff

@pytest.mark.parametrize("mode", ["soccar", "heatseeker", "snowday",
                                  "hoops"])
def test_mutators_for_mode_match_field_by_field(mode):
    want = jstate.MutatorConfig.for_mode(mode)
    got = tstate.MutatorConfig.for_mode(mode)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for n in names:
        assert getattr(got, n) == getattr(want, n), n


@pytest.mark.parametrize("mode", ["heatseeker", "snowday"])
def test_kickoff_matches_jax(mode):
    """The JAX kickoff of 6 arenas against the port's, the JAX slot
    shuffles and ball sides handed in."""
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    jp = jstep.ArenaParams(num_cars=CARS, game_mode=mode)
    teams = jnp.asarray(TEAMS)
    want = jax.vmap(lambda k: jsetters.kickoff_state()(k, jp, teams))(keys)
    n_slots = (JC.CAR_SPAWN_LOCATION_AMOUNT_HEATSEEKER
               if mode == "heatseeker" else JC.CAR_SPAWN_LOCATION_AMOUNT)
    # the draws kickoff_state and _kickoff_positions take from each key
    orders = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(jax.random.split(k)[0])[0], n_slots))
        for k in keys])
    sides = np.array([bool(jax.random.bernoulli(jax.random.split(k)[1]))
                      for k in keys])
    if mode == "heatseeker":
        assert sides.any() and not sides.all()
    setter = tsetters.kickoff_state(
        order_fn=lambda n, g, d: torch.from_numpy(orders),
        side_fn=lambda n, g, d: torch.from_numpy(sides))
    got = setter(None, _params(mode), torch.tensor(TEAMS), 6, "cpu")
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k, v in w.items():
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(v, np.float64), atol=1e-4,
                                   err_msg=k)


def test_env_runs_the_modes_and_refuses_hoops():
    """The port's env resets and steps heatseeker and snowday through the
    physics step (plane arena, 1 arena); the kernel route refuses hoops,
    and "auto" builds a hoops env on the portable route."""
    for mode in ("heatseeker", "snowday"):
        env = tenv.RocketLeagueEnv(tenv.EnvConfig(
            num_envs=1, team_size=2, game_mode=mode, device="cpu",
            arena=_params(mode, mesh=False)))
        state, obs, _ = env.reset(3)
        if mode == "heatseeker":
            assert abs(float(state.phys.ball.pos[0, 1])) == 2220.0
        state, out = env.step(state, torch.zeros(1, 4, dtype=torch.int64))
        assert torch.isfinite(out.obs).all()
    with pytest.raises(ValueError):
        tenv.RocketLeagueEnv(tenv.EnvConfig(num_envs=1, game_mode="hoops",
                                            device="cpu",
                                            physics_backend="kernel"))
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(num_envs=1, game_mode="hoops",
                                              device="cpu"))
    assert env.portable and env.params.game_mode == "hoops"


# ---------------------------------------------------------------------------
# the hooks on point batches

def test_round_angle_and_wrap_match_bit_for_bit():
    """Negative angles truncate toward zero before the arithmetic shift:
    +-pi, 0, values a hair under and over quantum boundaries, random."""
    edges = np.array([np.pi, -np.pi, 0.0, -0.0, 1e-9, -1e-9], np.float64)
    k = np.arange(-8192, 8193, 97)
    near = np.concatenate([k * QUANTUM * (1 - 1e-6), k * QUANTUM * (1 + 1e-6),
                           k * QUANTUM / 4 * (1 - 1e-6)])
    rng = np.random.RandomState(0)
    x = np.concatenate([edges, near, rng.uniform(-4, 4, 2000)]
                       ).astype(np.float32)
    got = tctick._round_angle_ue3(torch.from_numpy(x)).numpy()
    for want in (jctick._round_angle_ue3_k(jnp.asarray(x)),
                 jstep._round_angle_ue3(jnp.asarray(x))):
        np.testing.assert_array_equal(got, np.asarray(want))
    w = rng.uniform(-20, 20, 4000).astype(np.float32)
    for mm in (np.pi, np.pi / 2):
        np.testing.assert_array_equal(
            tctick._wrap(torch.from_numpy(w), mm).numpy(),
            np.asarray(jctick._wrap_k(jnp.asarray(w), mm)))


def _hs_batch(seed=1):
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.uniform(-4000, 4000, B), rng.uniform(-5000, 5000, B),
                    rng.uniform(100, 1900, B)], -1)
    d = rng.normal(0, 1, (B, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    vel = d * rng.uniform(300, 4500, (B, 1))
    ytd = rng.choice([-1.0, 0.0, 1.0], B)
    tspeed = rng.uniform(2900, 4600, B)
    tsince = rng.uniform(0, 3, B)
    f = np.float32
    return pos.astype(f), vel.astype(f), ytd.astype(f), tspeed.astype(f), \
        tsince.astype(f)


def test_hs_steer_matches_both_jax_twins():
    """``_hs_steer`` against the XLA path's ``step._heatseeker_steer``
    (true atan2, like the port: velocity within 1e-4 relative) and
    against ``ctick._hs_steer`` (polynomial atan2): rows where one
    quantised angle differs by one quantum are counted, and the rest
    agree to 1e-4 relative."""
    pos, vel, ytd, tspeed, tsince = _hs_batch()
    jk, tk = _consts("heatseeker")
    jpos, tpos = _vec(pos)
    jvel, tvel = _vec(vel)
    got = tctick._hs_steer(tk, {
        "ball_pos": tpos, "ball_vel": tvel,
        "ball_hs": tuple(torch.from_numpy(x) for x in (ytd, tspeed,
                                                       tsince))})
    got_v = _np(got["ball_vel"])
    want_k = jctick._hs_steer(jk, {
        "ball_pos": jpos, "ball_vel": jvel,
        "ball_hs": tuple(jnp.asarray(x) for x in (ytd, tspeed, tsince))})
    base = jax.vmap(lambda _: jstate.make_arena_state(CARS).ball)(
        jnp.arange(B))
    ball = base.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                        hs_y_target_dir=jnp.asarray(ytd),
                        hs_target_speed=jnp.asarray(tspeed),
                        hs_time_since_hit=jnp.asarray(tsince))
    want_x = jax.vmap(lambda b: jstep._heatseeker_steer(b, 1 / 120.0))(ball)

    speed = np.linalg.norm(got_v, axis=-1)
    np.testing.assert_allclose(got_v, np.asarray(want_x.vel),
                               atol=0, rtol=1e-4)
    np.testing.assert_allclose(got["ball_hs"][2].numpy(),
                               np.asarray(want_x.hs_time_since_hit),
                               atol=1e-6)
    dev = np.linalg.norm(got_v - _np(want_k["ball_vel"]), axis=-1)
    quantum_rows = dev > 1e-4 * speed
    print(f"rows one quantum apart from ctick's steering: "
          f"{int(quantum_rows.sum())} of {B}")
    assert (dev[quantum_rows] <= 2.5 * QUANTUM * speed[quantum_rows]).all()
    assert quantum_rows.mean() < 0.05
    assert (ytd[quantum_rows] != 0).all()          # only seeking balls turn
    np.testing.assert_array_equal(got_v[ytd == 0], vel[ytd == 0])


def test_hs_on_hit_folds_touches_in_car_order():
    """Every pattern of 4 cars' touches, from idle, within and after the
    minimum speed-up interval: the JAX kernel's and XLA path's folds."""
    rng = np.random.RandomState(2)
    pats = np.array(list(np.ndindex(2, 2, 2, 2)), bool)         # (16, 4)
    n = 16 * 6
    touched = np.tile(pats, (6, 1))
    ytd = np.repeat(np.array([0, 1, -1, 1, -1, 0], np.float32), 16)
    tsince = np.repeat(np.array([0, 0.5, 0.5, 2.0, 2.0, 3.0], np.float32), 16)
    tspeed = rng.uniform(2900, 4600, n).astype(np.float32)
    tspeed[:8] = 4590.0                                  # capped at MAX_SPEED
    jk, tk = _consts("heatseeker")
    hs = (ytd, tspeed, tsince)
    got = tctick._hs_on_hit(tk, {"ball_hs": tuple(
        torch.from_numpy(x) for x in hs)}, list(torch.from_numpy(touched.T)))
    want = jctick._hs_on_hit(jk, {"ball_hs": tuple(
        jnp.asarray(x) for x in hs)}, list(jnp.asarray(touched.T)))
    base = jax.vmap(lambda _: jstate.make_arena_state(CARS).ball)(
        jnp.arange(n))
    ball = base.replace(hs_y_target_dir=jnp.asarray(ytd),
                        hs_target_speed=jnp.asarray(tspeed),
                        hs_time_since_hit=jnp.asarray(tsince))
    want_x = jax.vmap(lambda b, t: jstep._heatseeker_on_hit(
        b, t, jnp.asarray(TEAMS), 1 / 120.0))(ball, jnp.asarray(touched))
    xla = (want_x.hs_y_target_dir, want_x.hs_target_speed,
           want_x.hs_time_since_hit)
    for g, wk, wx in zip(got["ball_hs"], want["ball_hs"], xla):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx))
    # both teams touching in one tick: the later car (orange) sets the
    # target, and the order decides the speed-up
    both = touched[:, 0] & touched[:, 2]
    assert (got["ball_hs"][0].numpy()[both] == -1).all()


def test_hs_wall_bounce_matches_jax():
    rng = np.random.RandomState(3)
    pos, vel, ytd, tspeed, tsince = _hs_batch(3)
    pos[:, 1] = np.sign(pos[:, 1]) * rng.uniform(4700, 5030, B)
    n = rng.normal(0, 1, (B, 3))
    n[: B // 2, 1] = -np.sign(pos[: B // 2, 1]) * 3.0     # off the back wall
    ytd[: B // 2] = np.where(rng.uniform(size=B // 2) > 0.2,
                             np.sign(pos[: B // 2, 1]), ytd[: B // 2])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    touching = rng.uniform(size=B) > 0.2
    n[~touching] = 0.0
    jk, tk = _consts("heatseeker")
    hs = (ytd, tspeed, tsince)
    jpos, tpos = _vec(pos)
    jvel, tvel = _vec(vel)
    jn, tn = _vec(n)
    st_g, dv_g = tctick._hs_wall_bounce(tk, {
        "ball_pos": tpos, "ball_vel": tvel,
        "ball_hs": tuple(torch.from_numpy(x) for x in hs)},
        torch.from_numpy(touching), tn)
    st_w, dv_w = jctick._hs_wall_bounce(jk, {
        "ball_pos": jpos, "ball_vel": jvel,
        "ball_hs": tuple(jnp.asarray(x) for x in hs)},
        jnp.asarray(touching), jn)
    flipped = st_g["ball_hs"][0].numpy() != ytd
    assert flipped.sum() > B // 8
    np.testing.assert_array_equal(st_g["ball_hs"][0].numpy(),
                                  np.asarray(st_w["ball_hs"][0]))
    np.testing.assert_allclose(_np(dv_g), _np(dv_w), atol=1e-4, rtol=1e-6)


def _random_rot(rng, n):
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2).astype(np.float32)


def test_snowday_puck_contact_matches_jax():
    """``_resolve_ball_world_snowday`` on pucks of any attitude near the
    floor, the ceiling, the side and back walls, a corner, the goal's
    posts and net and in open air: dv, dw, push, touching, mean normal."""
    rng = np.random.RandomState(5)
    spots = np.array([[0, 0, 60], [0, 0, 1990], [3990, 0, 300],
                      [0, 5060, 500], [3770, 4130, 150], [880, 5110, 120],
                      [0, 5950, 300], [200, 5300, 630], [0, 0, 1000]],
                     np.float32)
    pick = rng.randint(0, len(spots), B)
    pos = spots[pick] * np.where(rng.uniform(size=(B, 3)) > 0.5, 1, -1) \
        * np.array([1, 1, 0]) + spots[pick] * np.array([0, 0, 1]) \
        + rng.uniform(-60, 60, (B, 3))
    vel = rng.uniform(-1500, 1500, (B, 3)).astype(np.float32)
    ang = rng.uniform(-6, 6, (B, 3)).astype(np.float32)
    pre = (vel + rng.uniform(-20, 20, (B, 3))).astype(np.float32)
    rot = _random_rot(rng, B)
    jk, tk = _consts("snowday")
    vs = [_vec(a) for a in (pos, vel, ang, pre)]
    jrot = tuple(tuple(jnp.asarray(rot[:, i, j]) for j in range(3))
                 for i in range(3))
    trot = tuple(tuple(torch.from_numpy(rot[:, i, j].copy())
                       for j in range(3)) for i in range(3))
    got = tctick._resolve_ball_world_snowday(tk, vs[0][1], vs[1][1],
                                             vs[2][1], trot, vs[3][1])
    want = jctick._resolve_ball_world_snowday(jk, vs[0][0], vs[1][0],
                                              vs[2][0], jrot, vs[3][0])
    touching = got[3].numpy()
    np.testing.assert_array_equal(touching, np.asarray(want[3]))
    assert 0.3 < touching.mean() < 0.95
    for i, (name, tol) in enumerate((("dv", 1e-3), ("dw", 1e-5),
                                     ("push", 1e-5))):
        np.testing.assert_allclose(_np(got[i]), _np(want[i]), atol=tol,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(_np(got[4]), _np(want[4]), atol=1e-6)


# ---------------------------------------------------------------------------
# whole steps against golden ctick traces

def scenarios() -> dict:
    """name -> (game mode, overrides, [controls per env step], respawn_idx
    (E, C))."""
    zero_r = np.zeros((E, CARS), np.int32)
    still = np.zeros((E, CARS, 8), np.float32)
    rng = np.random.RandomState(61)
    f = np.float32

    ov = random_overrides(60, False)
    pos, vel, rot = (ov[f"arena.cars.{n}"].copy()
                     for n in ("pos", "vel", "rot"))
    bpos, bvel = ov["arena.ball.pos"].copy(), ov["arena.ball.vel"].copy()
    ytd = np.zeros(E, f)
    tspeed = np.full(E, HS.INITIAL_TARGET_SPEED, f)
    tsince = np.zeros(E, f)
    # 0-1: in flight, seeking either goal
    for e, d in ((0, 1.0), (1, -1.0)):
        bpos[e] = (rng.uniform(-1500, 1500), rng.uniform(-2000, 2000),
                   rng.uniform(500, 900))
        bvel[e] = (rng.uniform(-800, 800), -d * rng.uniform(500, 1200),
                   rng.uniform(0, 400))
        ytd[e], tsince[e] = d, 0.3
    # 2-4: car 0 (blue) and car 2 (orange) into the resting ball from both
    # sides, touching in the same tick
    for e, (d, ts) in zip((2, 3, 4), ((0.0, 0.0), (-1.0, 0.5), (1.0, 2.0))):
        bx, by = rng.uniform(-300, 300), rng.uniform(-300, 300)
        bpos[e] = (bx, by, 93.15)
        bvel[e] = 0.0
        pos[e, 0] = (bx - 162.0, by, 17.0)
        pos[e, 2] = (bx + 162.0, by, 17.0)
        vel[e, 0] = (1200.0, 0.0, 0.0)
        vel[e, 2] = (-1200.0, 0.0, 0.0)
        rot[e, 0] = np.eye(3, dtype=f)
        rot[e, 2] = np.diag([-1.0, -1.0, 1.0]).astype(f)   # yaw pi
        ytd[e], tsince[e] = d, ts
    # 5-7: into a back wall beside the goal being sought
    for e in (5, 6, 7):
        sy = 1.0 if e != 6 else -1.0
        bpos[e] = (rng.choice([-1, 1]) * rng.uniform(1800, 2800),
                   sy * rng.uniform(4960, 4990), rng.uniform(400, 700))
        bvel[e] = (rng.uniform(-200, 200), sy * 1500.0, 0.0)
        ytd[e], tspeed[e] = sy, 2000.0
    ov.update({"arena.cars.pos": pos, "arena.cars.vel": vel,
               "arena.cars.rot": rot, "arena.ball.pos": bpos,
               "arena.ball.vel": bvel,
               "arena.ball.ang_vel": np.zeros((E, 3), f),
               "arena.ball.hs_y_target_dir": ytd,
               "arena.ball.hs_target_speed": tspeed,
               "arena.ball.hs_time_since_hit": tsince})
    out = {"heatseeker": ("heatseeker", ov, [still, still], zero_r)}

    ov = random_overrides(70, False)
    bpos = np.zeros((E, 3), f)
    bvel = np.zeros((E, 3), f)
    bang = rng.uniform(-3, 3, (E, 3)).astype(f)
    brot = _rotmat(rng.uniform(-3, 3, E).astype(f),
                   rng.uniform(-0.5, 0.5, E).astype(f),
                   rng.uniform(-0.5, 0.5, E).astype(f))
    for e in range(4):            # tumbling onto the floor
        bpos[e] = (rng.uniform(-2000, 2000), rng.uniform(-3000, 3000),
                   rng.uniform(90, 110))
        bvel[e] = (rng.uniform(-500, 500), rng.uniform(-500, 500), -300.0)
    for e in (4, 5):              # into a side wall
        sx = 1.0 if e == 4 else -1.0
        bpos[e] = (sx * 3950.0, rng.uniform(-2000, 2000), 80.0)
        bvel[e] = (sx * 1200.0, rng.uniform(-600, 600), 0.0)
    for e in (6, 7):              # into a corner
        s = 1.0 if e == 6 else -1.0
        bpos[e] = (s * 3780.0, s * 3980.0, 90.0)
        bvel[e] = (s * 900.0, s * 900.0, -50.0)
    ov.update({"arena.ball.pos": bpos, "arena.ball.vel": bvel,
               "arena.ball.ang_vel": bang, "arena.ball.rot": brot})
    out["snowday"] = ("snowday", ov, [still, still], zero_r)
    return out


def _run_jax(name, mode, ov, controls, ridx) -> dict:
    """The JAX ``ctick.step`` trace of one scenario at full fidelity, run
    eagerly."""
    jax.config.update("jax_platforms", "cpu")
    from reinforcement_learning_tpu.ops import pack
    params = jstep.ArenaParams(num_cars=CARS, game_mode=mode)
    k = jctick.make_consts(params, np.asarray(TEAMS))
    base = jax.vmap(lambda _: jstep.make_physics_state(params))(
        jnp.arange(E))

    def build(obj, leaves, prefix=""):
        kw = {}
        for fl in dataclasses.fields(obj):
            v = getattr(obj, fl.name)
            n = prefix + fl.name
            kw[fl.name] = (build(v, leaves, n + ".")
                           if dataclasses.is_dataclass(v)
                           else jnp.asarray(leaves[n]))
        return type(obj)(**kw)

    data = {}
    phys = build(base, {**flatten(base), **ov})
    for n, a in flatten(phys).items():
        data[f"{name}/in/{n}"] = a
    for t, ctl in enumerate(controls):
        nc = tuple(jnp.asarray(ctl[..., c].T) for c in range(8))
        with jax.disable_jit():
            out = jctick.step(k, pack.to_components(phys), nc,
                              jnp.asarray(ridx.T), 8, 7)
        phys = pack.from_components(out, E)
        for n, a in flatten(phys).items():
            data[f"{name}/out/{t}/{n}"] = np.asarray(a)
    print(name, "done", flush=True)
    return data


def regenerate():
    import concurrent.futures
    import multiprocessing
    data = {"reference_sha256": np.array(
        reference_hash(MESH_REFERENCE_SOURCES))}
    ctx = multiprocessing.get_context("spawn")
    cases = scenarios()
    with concurrent.futures.ProcessPoolExecutor(
            len(cases), mp_context=ctx) as pool:
        futs = [pool.submit(_run_jax, name, *case)
                for name, case in cases.items()]
        for fut in futs:
            data.update(fut.result())
    np.savez_compressed(GOLDEN, **data)
    print("wrote", GOLDEN)


@pytest.fixture(scope="module")
def golden():
    return _load_golden(GOLDEN, MESH_REFERENCE_SOURCES)


@pytest.mark.parametrize("name", list(scenarios()))
def test_game_mode_step_matches_jax_ctick(golden, name):
    """The plain version at full fidelity follows the JAX ``ctick.step``
    trace of the scenario step by step."""
    mode, ov, controls, ridx = scenarios()[name]
    _follow_trace(golden, name, ov, controls, ridx, _params(mode))


def test_scenarios_drive_their_events(golden):
    """Each arena reaches the event it is there for, in the reference's
    own trace; the touch arenas' first tick, run by the port, shows both
    teams touching in the same tick."""
    def at(name, t, field):
        return golden[f"{name}/out/{t}/arena.{field}"]
    hin = lambda f: golden[f"heatseeker/in/arena.{f}"]  # noqa: E731
    # steering: seeking, in flight, turning toward the goal
    v0, v1 = hin("ball.vel")[:2], at("heatseeker", 1, "ball.vel")[:2]
    assert (np.abs(v1 - v0).max(-1) > 50).all()
    assert at("heatseeker", 1, "cars.ball_hit_valid")[2:5][:, [0, 2]].all()
    # back wall: the target flipped
    ytd = at("heatseeker", 1, "ball.hs_y_target_dir")
    assert (ytd[5:8] == -hin("ball.hs_y_target_dir")[5:8]).all()
    # the touch arenas' first two ticks, both cars touching first in the
    # second: blue then orange touched, so orange set the target; the speed
    # rose from idle (2) and after the minimum interval (4, on orange's
    # flip), not within it (3)
    mode, ov, _, ridx = scenarios()["heatseeker"]
    phys = _from_flat(_stored(golden, "heatseeker/in/"))
    one = arena_step_mod.arena_step(
        phys, torch.zeros(E, CARS, 8), torch.from_numpy(ridx),
        _params(mode), TEAMS, tick_skip=2, action_delay=0)
    hit = one.arena.cars.ball_hit_tick[2:5][:, [0, 2]]
    assert one.arena.cars.ball_hit_valid[2:5][:, [0, 2]].all()
    assert (hit == 1).all()
    b = one.arena.ball
    assert (b.hs_y_target_dir[2:5] == -1).all()
    s0 = hin("ball.hs_target_speed")
    rose = b.hs_target_speed.numpy() - s0
    assert rose[2] == HS.TARGET_SPEED_INCREMENT and rose[3] == 0
    assert rose[4] == HS.TARGET_SPEED_INCREMENT
    # snowday: the puck bounced off the floor and off the walls
    sv0 = golden["snowday/in/arena.ball.vel"]
    sv1 = at("snowday", 1, "ball.vel")
    assert (sv1[:4, 2] > sv0[:4, 2]).all()
    assert (sv1[4:6, 0] * sv0[4:6, 0] < 0).all()
    assert (np.sign(sv1[6:, :2]) != np.sign(sv0[6:, :2])).any(-1).all()


if __name__ == "__main__":
    regenerate()
