"""The port's env plugins against the JAX package on the CPU: every reward
(with the zero-sum wrapper and the losing-team penalty), the 2v2 kickoff
reward in 2v2 and 1v1, ``score_limit_condition``, DefaultObs and
DefaultObsPadded, the twins' reward stacks, and the state setters
(``kickoff_state(fuzz)`` and ``random_state`` with the JAX draws handed
in, ``combined_state`` by its picks).

The inputs are one numpy-made batch of arenas: random cars (some on the
ground, flipping, demoed, low or out of boost), a ball at rest on the
kickoff spot in some arenas, and events, touches and goals.  The JAX
functions run ``jax.vmap``'d over the arenas, jitted.

Tolerances: rewards 1e-5 (float32 norms, atan2 and sums in XLA's and
torch's orders), observations 1e-6, state setters exact where the same
float32 operations meet (positions, boost) and 1e-6 through sin/cos.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import maths as tm
from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs import kickoff_reward as tkick
from reinforcement_learning_torch.envs import obs as tobs
from reinforcement_learning_torch.envs import rewards as trew
from reinforcement_learning_torch.envs import state_setters as tset
from reinforcement_learning_torch.envs import terminals as tterm
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_tpu import constants as JC
from reinforcement_learning_tpu.envs import env as jenv
from reinforcement_learning_tpu.envs import kickoff_reward as jkick
from reinforcement_learning_tpu.envs import obs as jobs
from reinforcement_learning_tpu.envs import rewards as jrew
from reinforcement_learning_tpu.envs import state_setters as jset
from reinforcement_learning_tpu.envs import terminals as jterm
from reinforcement_learning_tpu.physics import step as jstep
from test_torch_state import flatten

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 24
REWARD_TOL = dict(rtol=1e-5, atol=1e-5)
OBS_TOL = dict(rtol=1e-6, atol=1e-6)
EVENTS = ("goal", "assist", "shot", "save", "bump", "bumped", "demo",
          "demoed")


def to_jax(src, like):
    """The port tree ``src`` as a JAX tree of ``like``'s structure (field
    names), through numpy; leading axes stay as they are."""
    if dataclasses.is_dataclass(like):
        return like.replace(**{f.name: to_jax(getattr(src, f.name),
                                              getattr(like, f.name))
                               for f in dataclasses.fields(like)})
    return jnp.asarray(src.numpy())


def _u(rng, lo, hi, shape):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def random_arena(rng, P, kickoff_every=3):
    """N random arenas of P cars; every ``kickoff_every``-th arena has the
    ball at rest on the kickoff spot."""
    params = tstep.ArenaParams(num_cars=P, use_mesh=False,
                               dynamic_wheel_rays=False)
    arena = tstep.make_physics_state(params, batch=(N,),
                                     device="cpu").arena
    cars, ball, pads = arena.cars, arena.ball, arena.pads
    cars.pos = torch.stack([_u(rng, -3500, 3500, (N, P)),
                            _u(rng, -4800, 4800, (N, P)),
                            _u(rng, 17, 1500, (N, P))], -1)
    cars.rot = tm.euler_to_rotmat(_u(rng, -3, 3, (N, P)),
                                  _u(rng, -1, 1, (N, P)),
                                  _u(rng, -3, 3, (N, P)))
    cars.vel = _u(rng, -2000, 2000, (N, P, 3))
    cars.ang_vel = _u(rng, -5, 5, (N, P, 3))
    boost = rng.uniform(0, 100, (N, P)).astype(np.float32)
    boost[rng.uniform(size=(N, P)) < 0.2] = 0.0
    cars.boost = torch.from_numpy(boost)
    for name in ("is_on_ground", "is_flipping", "is_demoed", "has_flipped",
                 "has_double_jumped", "has_jumped"):
        setattr(cars, name, torch.from_numpy(rng.uniform(size=(N, P))
                                             < 0.5))
    cars.air_time_since_jump = _u(rng, 0, 2, (N, P))
    ball.pos = torch.stack([_u(rng, -3000, 3000, (N,)),
                            _u(rng, -5500, 5500, (N,)),
                            _u(rng, 93, 1500, (N,))], -1)
    ball.vel = _u(rng, -3000, 3000, (N, 3))
    ball.ang_vel = _u(rng, -6, 6, (N, 3))
    kick = torch.arange(N) % kickoff_every == 0
    ball.pos[kick] = torch.tensor([0.0, 0.0, 93.15])
    ball.vel[kick] = 0.0
    pads.is_active = torch.from_numpy(rng.uniform(size=(N, 34)) < 0.6)
    pads.cooldown = torch.where(pads.is_active, 0.0,
                                _u(rng, 0, 10, (N, 34)))
    return arena


def make_ctx(seed, P):
    """(port ``RewardCtx`` batched over N arenas, the same inputs as JAX
    trees with a leading N axis, teams)."""
    rng = np.random.RandomState(seed)
    teams = np.array([0] * (P // 2) + [1] * (P // 2), np.int32)
    cur, prev = random_arena(rng, P), random_arena(rng, P)
    # some arenas where the ball kept its speed (a touch below the strong
    # touch's minimum) and cars that gained boost
    same = torch.arange(N) % 4 == 1
    prev.ball.vel[same] = cur.ball.vel[same] + 1.0
    prev.cars.boost = torch.where(torch.from_numpy(
        rng.uniform(size=(N, P)) < 0.5), cur.cars.boost * 0.5,
        prev.cars.boost)
    ctx = trew.RewardCtx(
        cars=cur.cars, prev_cars=prev.cars, ball=cur.ball,
        prev_ball=prev.ball, teams=torch.from_numpy(teams),
        ball_touched_step=torch.from_numpy(rng.uniform(size=(N, P)) < 0.4),
        goal_scored=torch.from_numpy(rng.uniform(size=N) < 0.3),
        has_prev=torch.arange(N) % 5 != 0,
        is_final=torch.from_numpy(rng.randint(0, 3, N).astype(np.int32)),
        events={k: torch.from_numpy(rng.uniform(size=(N, P)) < 0.3)
                for k in EVENTS},
        blue_score=torch.from_numpy(rng.randint(0, 4, N).astype(np.int32)),
        orange_score=torch.from_numpy(rng.randint(0, 4, N)
                                      .astype(np.int32)))
    like = jstep.make_physics_state(jstep.ArenaParams(
        num_cars=P, use_mesh=False, dynamic_wheel_rays=False)).arena
    j = dict(cars=to_jax(ctx.cars, like.cars),
             prev_cars=to_jax(ctx.prev_cars, like.cars),
             ball=to_jax(ctx.ball, like.ball),
             prev_ball=to_jax(ctx.prev_ball, like.ball),
             ball_touched_step=jnp.asarray(ctx.ball_touched_step.numpy()),
             goal_scored=jnp.asarray(ctx.goal_scored.numpy()),
             has_prev=jnp.asarray(ctx.has_prev.numpy()),
             is_final=jnp.asarray(ctx.is_final.numpy()),
             events={k: jnp.asarray(v.numpy())
                     for k, v in ctx.events.items()},
             blue_score=jnp.asarray(ctx.blue_score.numpy()),
             orange_score=jnp.asarray(ctx.orange_score.numpy()))
    return ctx, j, jnp.asarray(teams)


def jax_reward(fn, j, teams):
    def one(kw):
        return fn(jrew.RewardCtx(teams=teams, **kw))
    return np.asarray(jax.jit(jax.vmap(one))(j))


REWARDS = {
    "player_goal": lambda R: R.player_goal_reward(),
    "assist": lambda R: R.assist_reward(),
    "shot": lambda R: R.shot_reward(),
    "save": lambda R: R.save_reward(),
    "bump": lambda R: R.bump_reward(),
    "bumped": lambda R: R.bumped_penalty(),
    "demo": lambda R: R.demo_reward(),
    "demoed": lambda R: R.demoed_penalty(),
    "goal": lambda R: R.goal_reward(),
    "goal_concede_half": lambda R: R.goal_reward(-0.5),
    "velocity": lambda R: R.velocity_reward(),
    "velocity_negative": lambda R: R.velocity_reward(True),
    "velocity_ball_to_goal": lambda R: R.velocity_ball_to_goal_reward(),
    "velocity_ball_to_own_goal":
        lambda R: R.velocity_ball_to_goal_reward(True),
    "velocity_player_to_ball": lambda R: R.velocity_player_to_ball_reward(),
    "face_ball": lambda R: R.face_ball_reward(),
    "touch_ball": lambda R: R.touch_ball_reward(),
    "speed": lambda R: R.speed_reward(),
    "wavedash": lambda R: R.wavedash_reward(),
    "pickup_boost": lambda R: R.pickup_boost_reward(),
    "save_boost": lambda R: R.save_boost_reward(),
    "save_boost_linear": lambda R: R.save_boost_reward(1.0),
    "air": lambda R: R.air_reward(),
    "touch_accel": lambda R: R.touch_accel_reward(),
    "strong_touch": lambda R: R.strong_touch_reward(),
    "strong_touch_20_120": lambda R: R.strong_touch_reward(20, 120),
    "losing_penalty": lambda R: R.losing_penalty_reward(0.02),
    "zero_sum_ball_to_goal":
        lambda R: R.zero_sum(R.velocity_ball_to_goal_reward(), 1.0),
    "zero_sum_bump_half": lambda R: R.zero_sum(R.bump_reward(), 0.5),
    "zero_sum_speed_scaled":
        lambda R: R.zero_sum(R.speed_reward(), 0.3, 0.7),
}


@pytest.fixture(scope="module")
def ctx2v2():
    return make_ctx(0, 4)


@pytest.mark.parametrize("name", sorted(REWARDS))
def test_reward_matches_jax(ctx2v2, name):
    ctx, j, teams = ctx2v2
    want = jax_reward(REWARDS[name](jrew), j, teams)
    fn = REWARDS[name](trew)
    assert fn.__name__ == REWARDS[name](jrew).__name__
    got = fn(ctx)
    assert got.shape == (N, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **REWARD_TOL)


@pytest.mark.parametrize("P", [4, 2])
def test_kickoff_reward_matches_jax(P):
    """2v2, and 1v1 where no player has a teammate (0 everywhere, as in
    the JAX package)."""
    ctx, j, teams = make_ctx(1, P)
    want = jax_reward(jkick.kickoff_proximity_reward_2v2(), j, teams)
    got = tkick.kickoff_proximity_reward_2v2()(ctx)
    np.testing.assert_allclose(got.numpy(), want, **REWARD_TOL)
    active = (got != 0).any(-1)
    if P == 4:
        assert int(active.sum()) >= N // 4      # the kickoff arenas
    else:
        assert not bool(active.any())


def test_reward_stacks_of_the_twins_match_jax():
    """The twins' stacks (train_2v2: 13 terms, train_1v1: 9) against the
    JAX examples' make_env stacks: names, weights, the weighted total."""
    from reinforcement_learning_torch.examples import train_1v1, train_2v2
    for twin, path, P in ((train_2v2, "examples/train_2v2.py", 4),
                          (train_1v1, "examples/train_1v1.py", 2)):
        spec = importlib.util.spec_from_file_location(
            f"jax_{twin.__name__.rsplit('.', 1)[-1]}", ROOT / path)
        jmod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jmod)
        jenv_ = (jmod.make_env(2, False) if P == 4 else jmod.make_env(2))
        penv = (twin.make_env(2, device="cpu"))
        assert [(w.name, w.weight) for w in penv.reward_fns] == \
            [(w.name, w.weight) for w in jenv_.reward_fns]
        assert len(penv.reward_fns) == (13 if P == 4 else 9)
        ctx, j, teams = make_ctx(2, P)
        want_total = jax_reward(lambda c: jrew.combine_rewards(
            jenv_.reward_fns)(c)[0], j, teams)
        total, per = penv.reward_combined(ctx)
        assert set(per) == {w.name for w in penv.reward_fns}
        np.testing.assert_allclose(total.numpy(), want_total, rtol=1e-5,
                                   atol=1e-4)


def test_score_limit_condition_matches_jax():
    rng = np.random.RandomState(3)
    bs = rng.randint(0, 5, 40).astype(np.int32)
    os_ = rng.randint(0, 5, 40).astype(np.int32)
    goal = rng.uniform(size=40) < 0.5
    j = jax.vmap(lambda b, o, g: jterm.score_limit_condition(3)(
        jenv.TerminalCtx(goal_scored=g, steps_since_touch=jnp.int32(0),
                         steps_since_reset=jnp.int32(0), blue_score=b,
                         orange_score=o)))(bs, os_, goal)
    z = torch.zeros(40, dtype=torch.int32)
    got = tterm.score_limit_condition(3)(tenv.TerminalCtx(
        goal_scored=torch.from_numpy(goal), steps_since_touch=z,
        steps_since_reset=z, blue_score=torch.from_numpy(bs),
        orange_score=torch.from_numpy(os_)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    assert got.dtype == torch.int32 and 0 < int(got.sum()) < 40


# ---------------------------------------------------------------------------
# observation builders

@pytest.mark.parametrize("builder,P,max_players", [
    ("DefaultObs", 4, 0), ("DefaultObs", 2, 0),
    ("DefaultObsPadded", 4, 3), ("DefaultObsPadded", 2, 2)])
def test_default_obs_matches_jax(builder, P, max_players):
    rng = np.random.RandomState(4)
    teams = np.array([0] * (P // 2) + [1] * (P // 2), np.int32)
    arena = random_arena(rng, P)
    prev = torch.from_numpy(rng.uniform(-1, 1, (N, P, 8))
                            .astype(np.float32))
    like = jstep.make_physics_state(jstep.ArenaParams(
        num_cars=P, use_mesh=False, dynamic_wheel_rays=False)).arena
    args = (() if builder == "DefaultObs" else (max_players,))
    jb = getattr(jobs, builder)(P, teams, *args)
    tb = getattr(tobs, builder)(P, teams, *args, device="cpu")
    assert tb.obs_size == jb.obs_size
    want = jax.jit(jax.vmap(lambda c, b, p, a: jb.build(
        c, b, p, a, jnp.asarray(teams))))(
        to_jax(arena.cars, like.cars), to_jax(arena.ball, like.ball),
        to_jax(arena.pads, like.pads), jnp.asarray(prev.numpy()))
    got = tb.build(arena.cars, arena.ball, arena.pads, prev)
    assert got.shape == (N, P, jb.obs_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OBS_TOL)
    if builder == "DefaultObsPadded":
        # the shuffle with the permutations the JAX key draws
        key = jax.random.PRNGKey(5)
        k1, k2 = jax.random.split(key)
        want = jax.jit(jax.vmap(lambda c, b, p, a: jb.build(
            c, b, p, a, jnp.asarray(teams), key=key)))(
            to_jax(arena.cars, like.cars), to_jax(arena.ball, like.ball),
            to_jax(arena.pads, like.pads), jnp.asarray(prev.numpy()))
        perms = [torch.from_numpy(np.array(jax.random.permutation(k, n)))
                 for k, n in ((k1, max_players - 1), (k2, max_players))]
        got = tb.build(arena.cars, arena.ball, arena.pads, prev,
                       perms=perms)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **OBS_TOL)


def test_env_takes_an_obs_builder_and_action_parser():
    from reinforcement_learning_torch.envs.actions import DefaultAction
    teams = np.array([0, 1], np.int32)
    ob = tobs.DefaultObs(2, teams, device="cpu")
    ap = DefaultAction("cpu")
    env = tenv.RocketLeagueEnv(
        tenv.EnvConfig(num_envs=2, team_size=1, device="cpu",
                       arena=tstep.ArenaParams(num_cars=2, use_mesh=False,
                                               dynamic_wheel_rays=False)),
        obs_builder=ob, action_parser=ap)
    assert env.obs_builder is ob and env.action_parser is ap
    assert env.obs_size == ob.obs_size == 89
    _, obs, _ = env.reset(0)
    assert obs.shape == (2, 2, 89)


# ---------------------------------------------------------------------------
# state setters

def _jax_kickoff_draws(keys, P, fuzz):
    """The slot shuffle and the fuzz offsets ``kickoff_state`` draws from
    each arena's key (kickoff_state -> _kickoff_positions)."""
    def one(key):
        kcars, _ = jax.random.split(key)
        kshuf, kfuzz = jax.random.split(kcars)
        order = jax.random.permutation(kshuf, JC.CAR_SPAWN_LOCATION_AMOUNT)
        off = jax.random.uniform(kfuzz, (P, 3), minval=-fuzz, maxval=fuzz)
        return order, off
    order, off = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(order)), \
        torch.from_numpy(np.array(off))


def _assert_state(got, want, name):
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k, v in g.items():
        tol = dict(rtol=0, atol=1e-6) if "rot" in k or "vel" in k else \
            dict(rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(v, np.float64),
                                   np.asarray(w[k], np.float64), **tol,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("fuzz", [0.0, 0.1, 25.0])
def test_kickoff_state_fuzz_with_the_jax_draws(fuzz):
    P = 4
    teams = np.array([0, 0, 1, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(6), N)
    want = jax.vmap(lambda k: jset.kickoff_state(fuzz)(
        k, jstep.ArenaParams(num_cars=P), jnp.asarray(teams)))(keys)
    order, off = _jax_kickoff_draws(keys, P, fuzz)
    setter = tset.kickoff_state(fuzz, order_fn=lambda n, g, d: order,
                                fuzz_fn=lambda n, p, g, d: off)
    got = setter(None, tstep.ArenaParams(num_cars=P),
                 torch.from_numpy(teams), N, "cpu")
    assert setter.__name__ == jset.kickoff_state(fuzz).__name__
    _assert_state(got, want, f"fuzz={fuzz}")
    # the port's own draws: within the fuzz of the unfuzzed spawn
    own = tset.kickoff_state(fuzz, order_fn=lambda n, g, d: order)(
        torch.Generator().manual_seed(0), tstep.ArenaParams(num_cars=P),
        torch.from_numpy(teams), N, "cpu")
    base = tset.kickoff_state(0.0, order_fn=lambda n, g, d: order)(
        None, tstep.ArenaParams(num_cars=P), torch.from_numpy(teams), N,
        "cpu")
    d = (own.arena.cars.pos - base.arena.cars.pos).abs()
    assert float(d.max()) <= fuzz and (fuzz == 0 or float(d.max()) > 0)


def _jax_random_draws(keys, P):
    """The uniforms ``random_state`` draws from each arena's key."""
    X, Y, Z, CZ = tset.RANDOM_STATE_BOUNDS
    pi = jnp.pi

    def one(key):
        k = jax.random.split(key, 12)
        u = jax.random.uniform
        return dict(
            ball_pos=u(k[0], (3,), minval=jnp.array([-X, -Y, 92.75]),
                       maxval=jnp.array([X, Y, Z])),
            ball_dir=u(k[1], (3,), minval=-1, maxval=1),
            ball_speed=u(k[2], (), maxval=4000.0),
            ball_ang=u(k[3], (3,), minval=-4.0, maxval=4.0),
            car_pos=u(k[4], (P, 3), minval=jnp.array([-X, -Y, CZ]),
                      maxval=jnp.array([X, Y, Z])),
            yaw=u(k[5], (P,), minval=-pi, maxval=pi),
            pitch=u(k[6], (P,), minval=-pi / 2, maxval=pi / 2),
            roll=u(k[7], (P,), minval=-pi, maxval=pi),
            car_dir=u(k[8], (P, 3), minval=-1, maxval=1),
            car_speed=u(k[9], (P, 1), maxval=JC.CAR_MAX_SPEED),
            ang_dir=u(k[10], (P, 3), minval=-1, maxval=1),
            ground=u(k[11], (P,)),
            boost=u(jax.random.fold_in(k[11], 1), (P,), maxval=100.0))
    return {k: torch.from_numpy(np.array(v))
            for k, v in jax.vmap(one)(keys).items()}


@pytest.mark.parametrize("kw", [{}, {"cars_on_ground_only": True},
                                {"rand_ball_speed": False,
                                 "rand_car_speed": False}])
def test_random_state_with_the_jax_draws(kw):
    P = 4
    teams = np.array([0, 0, 1, 1], np.int32)
    params_j = jstep.ArenaParams(num_cars=P, use_mesh=False,
                                 dynamic_wheel_rays=False)
    params_t = tstep.ArenaParams(num_cars=P, use_mesh=False,
                                 dynamic_wheel_rays=False)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    want = jax.vmap(lambda k: jset.random_state(**kw)(
        k, params_j, jnp.asarray(teams)))(keys)
    draws = _jax_random_draws(keys, P)
    got = tset.random_state(**kw, draws_fn=lambda *a: draws)(
        None, params_t, torch.from_numpy(teams), N, "cpu")
    _assert_state(got, want, str(kw))
    # the port's own draws stay in the field
    own = tset.random_state(**kw)(torch.Generator().manual_seed(1),
                                  params_t, torch.from_numpy(teams), 512,
                                  "cpu")
    pos = own.arena.cars.pos
    assert float(pos[..., 0].abs().max()) <= 3500
    assert float(pos[..., 2].min()) >= 17
    on = own.arena.cars.is_on_ground
    assert bool((pos[..., 2][on] == 17).all())
    if not kw:
        assert 0.4 < float(on.float().mean()) < 0.6
        assert 0.9 * 4000 < float(tm.norm(own.arena.ball.vel).max()) <= 4000


def test_combined_state_picks_by_weight():
    P = 4
    teams = torch.tensor([0, 0, 1, 1])
    params = tstep.ArenaParams(num_cars=P, use_mesh=False,
                               dynamic_wheel_rays=False)
    order = torch.arange(JC.CAR_SPAWN_LOCATION_AMOUNT).repeat(2000, 1)
    kick = tset.kickoff_state(order_fn=lambda n, g, d: order[:n])
    rand = tset.random_state()
    setter = tset.combined_state([(kick, 1.0), (rand, 3.0)])
    phys = setter(torch.Generator().manual_seed(2), params, teams, 2000,
                  "cpu")
    at_kick = (phys.arena.ball.vel == 0).all(-1)
    assert 0.22 < float(at_kick.float().mean()) < 0.28
    # a given pick: every arena holds its child's state
    idx = torch.tensor([0, 1, 1, 0, 1, 0])
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    picked = tset.combined_state([(kick, 1.0), (rand, 3.0)],
                                 pick_fn=lambda n, g, d: idx)(
        g1, params, teams, 6, "cpu")
    a, b = kick(g2, params, teams, 6, "cpu"), rand(g2, params, teams, 6,
                                                   "cpu")
    for k, v in flatten(picked).items():
        want = np.where(idx.numpy().reshape((-1,) + (1,) * (v.ndim - 1))
                        == 1, flatten(b)[k], flatten(a)[k])
        np.testing.assert_array_equal(v, want, err_msg=k)
