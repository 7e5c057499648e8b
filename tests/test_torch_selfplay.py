"""The port's self-play services against the JAX package on the CPU: the
ELO rule; the version bank's ring, rating inheritance and
``get_version``; the trainer's self-play host decisions over 20
iterations (snapshots, opponent mixing, skill matches) with both
trainers' cores stubbed; ``SkillTracker.run_matches``' ELO and
continuation bookkeeping with both match runs stubbed; the goal
attribution of one skill-match step against the JAX env's XLA step; and
one real self-play iteration of the port against an old version.

The host decisions draw from ``numpy.random.RandomState(random_seed)`` in
the JAX package's order, so they are compared exactly; ratings are
float32 on both sides and compared exactly too.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs import state_setters as tset
from reinforcement_learning_torch.envs import terminals as tterm
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import selfplay as tsp
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_tpu.envs import env as jenv
from reinforcement_learning_tpu.envs import state_setters as jset
from reinforcement_learning_tpu.envs import terminals as jterm
from reinforcement_learning_tpu.learn import ppo as jppo
from reinforcement_learning_tpu.learn import selfplay as jsp
from reinforcement_learning_tpu.learn import trainer as jtrainer
from test_torch_learn import _np_tree, _port_tree
from test_torch_state import jax_to_torch

torch.set_num_threads(1)

SMALL = dict(policy_layers=(8, 8), critic_layers=(8,),
             shared_head_layers=(8,), half_precision=False, batch_size=8,
             epochs=1)


def test_elo_update_matches_jax():
    for w, l, inc in ((0.0, 0.0, 5.0), (400.0, 0.0, 5.0), (-30.5, 12.25,
                                                            7.0)):
        assert tsp.elo_update(w, l, inc) == jsp.elo_update(w, l, inc)


def _plane_envs(N=2, team_size=1):
    P = 2 * team_size
    jparams = jenv.stepmod.ArenaParams(num_cars=P, use_mesh=False,
                                       dynamic_wheel_rays=False)
    tparams = tstep.ArenaParams(num_cars=P, use_mesh=False,
                                dynamic_wheel_rays=False)
    j = jenv.RocketLeagueEnv(jenv.EnvConfig(
        num_envs=N, team_size=team_size, physics_backend="xla",
        arena=jparams))
    t = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=N, team_size=team_size, arena=tparams, device="cpu"))
    return j, t


def _same_learners(obs_size, num_actions):
    jl = jppo.PPOLearner(obs_size, num_actions, jppo.PPOConfig(**SMALL))
    jparams = jl.init(jax.random.PRNGKey(0)).params
    tl = tppo.PPOLearner(obs_size, num_actions, tppo.PPOConfig(**SMALL),
                         device="cpu")
    tl.params_from_jax({k: _np_tree(getattr(jparams, k))
                        for k in ("shared_head", "policy", "critic")})
    return jl, jparams, tl


def _assert_bank(tb, jb):
    assert tb.count == int(jb.count) and tb.next_slot == int(jb.next_slot)
    np.testing.assert_array_equal(tb.ratings.numpy(), np.asarray(jb.ratings))
    np.testing.assert_array_equal(tb.timesteps.numpy(),
                                  np.asarray(jb.timesteps))
    assert float(tsp.current_rating(tb)) == float(jsp.current_rating(jb))


def test_version_bank_matches_jax():
    """A ring of 3 filled 5 times from a learner perturbed between
    snapshots, ratings moved between snapshots (new versions inherit the
    latest); every version's parameters, ratings, timesteps and
    ``get_version``; the bank keeps its own copies."""
    _, jparams, tl = _same_learners(6, 5)
    base = [p.detach().clone() for p in tl.parameters()]
    jb = jsp.VersionBank.make(jparams, 3, 10.0)
    tb = tsp.VersionBank.make(tl, 3, 10.0)
    _assert_bank(tb, jb)
    add = jax.jit(jsp.add_version)
    for i in range(5):
        jp = jax.tree.map(lambda x: x + i, jparams)
        with torch.no_grad():
            for p, q in zip(tl.parameters(), base):
                p.copy_(q + i)
        jb = add(jb, jp, jnp.int32(i * 100))
        tsp.add_version(tb, tl, i * 100)
        _assert_bank(tb, jb)
        last = (tb.next_slot - 1) % 3
        jb = jb.replace(ratings=jb.ratings.at[last].set(7.5 * i - 3.0))
        tb.ratings[last] = 7.5 * i - 3.0
    with torch.no_grad():
        for p in tl.parameters():
            p.add_(100.0)                   # the bank must not see this
    for idx in range(3):
        jpol, jhead = jsp.get_version(jb, idx)
        got = tsp.get_version(tb, idx)
        for model, want in (("policy", jpol), ("shared_head", jhead)):
            view = types.SimpleNamespace(**{
                k: v for k, v in _module_view(getattr(tl, model),
                                              got[model]).items()})
            np.testing.assert_array_equal(
                np.concatenate([np.ravel(x) for x in jax.tree.leaves(
                    _port_tree(view, lambda t: t.numpy()))]),
                np.concatenate([np.ravel(x) for x in jax.tree.leaves(
                    want)]))
    assert sorted(tb.timesteps.tolist()) == [200, 300, 400]


def _module_view(model, params):
    """An object shaped like the port MLP whose parameters are
    ``params`` (name -> tensor), for ``_port_tree``."""
    def lin(prefix):
        return types.SimpleNamespace(weight=params[f"{prefix}.weight"],
                                     bias=params[f"{prefix}.bias"])
    n = len(model.layers)
    return dict(layers=[lin(f"layers.{i}") for i in range(n)],
                norms=[lin(f"norms.{i}") for i in range(n)],
                out=lin("out") if model.out is not None else None)


# ---------------------------------------------------------------------------
# the trainer's host decisions

SP_KW = dict(save_versions=True, ts_per_version=12, max_versions=4,
             train_against_old=True, train_against_old_chance=0.5)
SKILL_KW = dict(enabled=True, num_arenas=4, update_interval=2,
                rating_inc=5.0, sim_time=2.0, max_sim_time=5.0)
# goals (new, old) each stubbed match run returns, in turn
GOALS = [(0, 1), (2, 0), (3, 3), (0, 0), (5, 0), (1, 1), (0, 4), (2, 2),
         (0, 0), (6, 1)]


def _stub_selfplay(trainer, log, goals):
    steps = trainer.steps_per_itr * trainer.players_per_step

    def core(state, *args, use_old=False, **kw):
        old_team = (args[-1] if args else kw.get("old_team", 0))
        log.append(("core", bool(use_old), int(old_team) if use_old
                    else None))
        nxt = types.SimpleNamespace(**vars(state))
        nxt.total_timesteps = state.total_timesteps + steps
        return nxt, {}

    def run(*args):
        # JAX: (cur, old policy, old head, states, new_team, key); the
        # port: (learner, old params, states, new_team, seed)
        log.append(("match", int(args[-2])))
        n, o = goals.pop(0)
        return args[-3], n, o

    trainer._train_iteration = core
    trainer.skill_tracker._run = run
    trainer.skill_tracker.env.reset = lambda key: ("states",)


def test_selfplay_host_decisions_match_jax(monkeypatch):
    """20 iterations with both cores and both match runs stubbed: the
    snapshots, whether to train against an old version, which version and
    team, which version and team the skill matches take, the ratings and
    the match continuation, after every iteration."""
    jenv_, tenv_ = _plane_envs()
    jl, jparams, tl = _same_learners(tenv_.obs_size, tenv_.num_actions)
    jt = jtrainer.Trainer(
        jenv_, jppo.PPOConfig(**SMALL),
        jtrainer.TrainerConfig(ts_per_itr=8, random_seed=7),
        selfplay=jsp.SelfPlayConfig(
            **SP_KW, skill=jsp.SkillTrackerConfig(**SKILL_KW)))
    tt = ttrainer.Trainer(
        tenv_, tppo.PPOConfig(**SMALL),
        ttrainer.TrainerConfig(ts_per_itr=8, random_seed=7), learner=tl,
        selfplay=tsp.SelfPlayConfig(
            **SP_KW, skill=tsp.SkillTrackerConfig(**SKILL_KW)))
    logs = {"jax": [], "port": []}
    for kind, mod in (("jax", jsp), ("port", tsp)):
        real = mod.get_version

        def spy(bank, idx, real=real, kind=kind):
            logs[kind].append(("version", int(idx)))
            return real(bank, idx)
        monkeypatch.setattr(mod, "get_version", spy)
    _stub_selfplay(jt, logs["jax"], list(GOALS))
    _stub_selfplay(tt, logs["port"], list(GOALS))

    js = types.SimpleNamespace(ppo=types.SimpleNamespace(params=jparams),
                               total_timesteps=jnp.int32(0))
    ts = types.SimpleNamespace(total_timesteps=0)
    for it in range(20):
        js, _ = jt.train_iteration(js)
        ts, _ = tt.train_iteration(ts)
        assert logs["port"] == logs["jax"], it
        assert tt.last_selfplay_metrics == pytest.approx(
            jt.last_selfplay_metrics, rel=0, abs=0), it
        _assert_bank(tt.bank, jt.bank)
        for f in ("continuation", "cur_goals", "prev_old_idx",
                  "prev_new_team", "prev_sim_time", "iterations_since_ran"):
            assert getattr(tt.skill_tracker, f) == \
                getattr(jt.skill_tracker, f), (it, f)
    kinds = [e[0] for e in logs["port"]]
    assert kinds.count("match") == len(GOALS)
    assert any(e[:2] == ("core", True) for e in logs["port"])
    assert any(e[:2] == ("core", False) for e in logs["port"])
    assert tt.bank.count == 4                  # the ring wrapped


def test_run_matches_bookkeeping_matches_jax():
    """``run_matches`` on a bank of three versions, both match runs
    stubbed to the same goal counts: the ELO updates, the write-back of
    both ratings, the continuation while goals are few and the sim time
    short, and the info."""
    jenv_, tenv_ = _plane_envs()
    jl, jparams, tl = _same_learners(tenv_.obs_size, tenv_.num_actions)
    cfg = dict(num_arenas=4, sim_time=2.0, max_sim_time=5.0, rating_inc=5.0)
    jtr = jsp.SkillTracker(jl, 1, jsp.SkillTrackerConfig(**cfg))
    ttr = tsp.SkillTracker(tl, 1, tsp.SkillTrackerConfig(**cfg),
                           device="cpu")
    jb = jsp.VersionBank.make(jparams, 4, 0.0)
    tb = tsp.VersionBank.make(tl, 4, 0.0)
    for i in range(3):
        jb = jsp.add_version(jb, jparams, jnp.int32(i))
        tsp.add_version(tb, tl, i)
    logs = {"jax": [], "port": []}
    for tr, kind in ((jtr, "jax"), (ttr, "port")):
        goals = list(GOALS)

        def run(*args, goals=goals, kind=kind):
            logs[kind].append(int(args[-2]))
            return (args[-3], *goals.pop(0))
        tr._run = run
        tr.env.reset = lambda key: ("states",)
    jrng, trng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(len(GOALS)):
        jb, jcur, jinfo = jtr.run_matches(jparams, jb, jrng)
        tb, tcur, tinfo = ttr.run_matches(tl, tb, trng)
        assert tcur == jcur and tinfo == jinfo
        _assert_bank(tb, jb)
        assert (ttr.continuation, ttr.cur_goals, ttr.prev_sim_time) == \
            (jtr.continuation, jtr.cur_goals, jtr.prev_sim_time)
    assert logs["port"] == logs["jax"]
    assert float(tsp.current_rating(tb)) != 0.0


# ---------------------------------------------------------------------------
# goal attribution in a skill match, against the JAX env's XLA step

def _skill_env_jax(N):
    params = jenv.stepmod.ArenaParams(num_cars=4, use_mesh=False,
                                      dynamic_wheel_rays=False)
    return jenv.RocketLeagueEnv(
        jenv.EnvConfig(num_envs=N, team_size=2, physics_backend="xla",
                       arena=params, max_episode_seconds=1e9,
                       no_touch_timeout=1e9),
        reward_fns=[], terminal_conds=[jterm.goal_score_condition()],
        state_setter=jset.kickoff_state(fuzz=0.1))


def _skill_env_port(N):
    params = tstep.ArenaParams(num_cars=4, use_mesh=False,
                               dynamic_wheel_rays=False)
    return tenv.RocketLeagueEnv(
        tenv.EnvConfig(num_envs=N, team_size=2, arena=params,
                       max_episode_seconds=1e9, no_touch_timeout=1e9,
                       device="cpu"),
        reward_fns=[], terminal_conds=[tterm.goal_score_condition()],
        state_setter=tset.kickoff_state(fuzz=0.1))


def test_skill_match_goal_attribution_matches_jax():
    """One eval step with the ball crossing the blue goal line in arena 0
    and the orange one in arena 1 (arenas 2 and 3 play on): the goals
    each side is credited with, for the current policy on either team.
    As in the JAX package, the net is read from ``prev_arena`` after the
    goal's auto-reset, the kickoff ball at y = 0, so both goals go to
    blue."""
    N = 4
    jenv_, tenv_ = _skill_env_jax(N), _skill_env_port(N)
    jl, jparams, tl = _same_learners(tenv_.obs_size, tenv_.num_actions)
    cfg = dict(num_arenas=N, sim_time=8 / 120)
    jtr = jsp.SkillTracker(jl, 2, jsp.SkillTrackerConfig(**cfg))
    ttr = tsp.SkillTracker(tl, 2, tsp.SkillTrackerConfig(**cfg),
                           device="cpu")
    assert jtr.steps_per_run == ttr.steps_per_run == 1
    jtr.env, ttr.env = jenv_, tenv_

    jstates, jobs, jmasks = jax.jit(jenv_.reset)(jax.random.PRNGKey(2))
    ball = jstates.phys.arena.ball
    ball = ball.replace(
        pos=ball.pos.at[0].set(jnp.array([0.0, -5300.0, 300.0]))
        .at[1].set(jnp.array([0.0, 5300.0, 300.0])),
        vel=ball.vel.at[0].set(jnp.array([0.0, -1000.0, 0.0]))
        .at[1].set(jnp.array([0.0, 1000.0, 0.0])))
    jstates = jstates.replace(phys=jstates.phys.replace(
        arena=jstates.phys.arena.replace(ball=ball)))
    like = tenv_.reset(0)[0]
    tstates = jax_to_torch(jstates, like)
    tobs = torch.from_numpy(np.array(jobs))
    tmasks = torch.from_numpy(np.array(jmasks))
    jpol, jhead = jsp.get_version(jsp.add_version(
        jsp.VersionBank.make(jparams, 2, 0.0), jparams, jnp.int32(0)), 0)
    tb = tsp.add_version(tsp.VersionBank.make(tl, 2, 0.0), tl, 0)
    run = jax.jit(jtr._run_impl)
    for new_team in (0, 1):
        (js2, _, _), jn, jo = run(jparams, jpol, jhead,
                                  (jstates, jobs, jmasks),
                                  jnp.int32(new_team),
                                  jax.random.PRNGKey(4))
        (ts2, _, _), tn, to = ttr._run(tl, tsp.get_version(tb, 0),
                                       (tstates, tobs, tmasks), new_team,
                                       4)
        assert (int(tn), int(to)) == (int(jn), int(jo)), new_team
        assert (int(tn), int(to)) == ((2, 0) if new_team == 0 else (0, 2))
        np.testing.assert_array_equal(
            ts2.prev_arena.ball.pos[:2, 1].numpy(),
            np.asarray(js2.prev_arena.ball.pos[:2, 1]))


# ---------------------------------------------------------------------------
# a real self-play iteration of the port

def test_selfplay_iteration_against_an_old_version():
    """Two iterations of the port's trainer on the CPU with self-play and
    deterministic actions: the first snapshots a version, and both train
    against it (chance 1).  In the second, the old team's rows have weight
    0, its actions are the version's, and the bank's copy is the
    parameters from before the first update while the learner moved on."""
    _, tenv_ = _plane_envs()
    cfg = tsp.SelfPlayConfig(ts_per_version=10 ** 9,
                             train_against_old_chance=1.0,
                             skill=tsp.SkillTrackerConfig(enabled=False))
    tr = ttrainer.Trainer(tenv_, tppo.PPOConfig(**SMALL, deterministic=True),
                          ttrainer.TrainerConfig(ts_per_itr=4,
                                                 random_seed=11),
                          selfplay=cfg)
    seen = {}
    learn = tr.learn

    def spy(state, traj, perms=None, weight=None):
        seen["weight"], seen["traj"] = weight, traj
        return learn(state, traj, perms=perms, weight=weight)
    tr.learn = spy
    before = [p.detach().clone() for p in tr.learner.policy.parameters()]
    state, _ = tr.train_iteration(tr.init(0))
    assert tr.bank.count == 1 and seen["weight"] is not None
    state, metrics = tr.train_iteration(state)
    assert tr.last_selfplay_metrics == {"trained_against_old": 1.0}
    assert all(np.isfinite(float(v)) for v in metrics.values())

    traj = seen["traj"]
    w = seen["weight"].reshape(traj["action"].shape)
    per_player = w[0, 0]
    assert torch.equal(w, per_player.expand_as(w))
    old = per_player == 0
    assert int(old.sum()) == 1                 # one player a team in 1v1
    version = tsp.get_version(tr.bank, 0)
    T, N, P = traj["action"].shape
    obs = traj["obs"].reshape(T * N * P, -1)
    mask = traj["mask"].reshape(T * N * P, -1)
    want_old = tr.learner.sample_actions(obs, mask, deterministic=True,
                                         params=version)[0]
    assert torch.equal(traj["action"][..., old].reshape(-1),
                       want_old.reshape(T, N, P)[..., old].reshape(-1))
    assert all(torch.equal(a, b) for a, b in zip(version["policy"].values(),
                                                 before))
    assert not all(torch.equal(a, b) for a, b in zip(
        tr.learner.policy.parameters(), before))
