"""Standard 3v3, the example's training program at three a team
(``examples/train_3v3.py``), against the JAX package on the CPU at
``team_size=3``: AdvancedObs at six players (225 floats), the example's 13
reward terms (the 2v2 kickoff reward pairing each player with its first
teammate), its terminals, and the rows that old-opponent mixing leaves to
the update.  The JAX side is the JAX example's own reward stack and
terminals (``examples/train_2v2.py``, whose functions take any team size)
in a JAX env built at three a team.

The inputs are ``test_torch_rewards``' numpy-made arenas at six cars.  The
JAX functions run ``jax.vmap``'d over the arenas, jitted once each.

Tolerances: observations 1e-6 (the same float32 operations in XLA's and
torch's orders; rotations and dot products round alike); each reward term
1e-5 (float32 norms, atan2 and sums in either order, as
``test_torch_rewards``); the weighted total 1e-5 relative and 1e-4
absolute (weights up to 150 scale a term's rounding); terminals and the
update's row weights exact (integer and boolean logic).
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

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.examples import train_3v3
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_tpu.envs import env as jenv
from reinforcement_learning_tpu.envs import rewards as jrew
from reinforcement_learning_tpu.physics import step as jstep
from test_torch_rewards import N, make_ctx, random_arena, to_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P = 6
OBS_TOL = dict(rtol=1e-6, atol=1e-6)
REWARD_TOL = dict(rtol=1e-5, atol=1e-5)
TOTAL_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def envs():
    """(the port's 3v3 example env on the CPU, the JAX example's env
    rebuilt at three a team with the example's rewards and terminals)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_2v2_for_3v3", ROOT / "examples" / "train_2v2.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jex = jmod.make_env(2, False)
    j3 = jenv.RocketLeagueEnv(
        dataclasses.replace(jex.config, team_size=3, arena=None),
        reward_fns=jex.reward_fns)
    j3.terminal_fn = jex.terminal_fn
    port = train_3v3.make_env(2, device="cpu")
    return port, j3


def test_the_env_is_the_example_at_three_a_team(envs):
    port, j3 = envs
    assert port.config.team_size == 3 and port.config.cars_per_arena == P
    assert port.teams_np.tolist() == j3.teams_np.tolist() == [0, 0, 0, 1,
                                                              1, 1]
    assert port.obs_size == j3.obs_size == 9 + 8 + 34 + 29 * P == 225
    assert port.num_actions == j3.num_actions == 90
    assert [(w.name, w.weight) for w in port.reward_fns] == \
        [(w.name, w.weight) for w in j3.reward_fns]
    assert len(port.reward_fns) == 13
    assert not port.portable            # "auto" picks the kernel route
    assert (port.params.use_mesh, port.params.dynamic_wheel_rays) == (
        True, True)


def test_advanced_obs_at_six_players(envs):
    port, j3 = envs
    rng = np.random.RandomState(6)
    arena = random_arena(rng, P)
    prev = torch.from_numpy(rng.uniform(-1, 1, (N, P, 8))
                            .astype(np.float32))
    like = jstep.make_physics_state(jstep.ArenaParams(
        num_cars=P, use_mesh=False, dynamic_wheel_rays=False)).arena
    teams = jnp.asarray(j3.teams_np)
    want = jax.jit(jax.vmap(lambda c, b, p, a: j3.obs_builder.build(
        c, b, p, a, teams)))(
        to_jax(arena.cars, like.cars), to_jax(arena.ball, like.ball),
        to_jax(arena.pads, like.pads), jnp.asarray(prev.numpy()))
    got = port.obs_builder.build(arena.cars, arena.ball, arena.pads, prev)
    assert got.shape == (N, P, 225)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OBS_TOL)


def test_the_13_reward_terms_at_three_a_team(envs):
    port, j3 = envs
    ctx, j, teams = make_ctx(7, P)
    assert torch.equal(ctx.teams, port.teams)
    combined = jrew.combine_rewards(j3.reward_fns)
    want_total, want = jax.jit(jax.vmap(
        lambda kw: combined(jrew.RewardCtx(teams=teams, **kw))))(j)
    total, per = port.reward_combined(ctx)
    assert list(per) == [w.name for w in port.reward_fns]
    for name, got in per.items():
        assert got.shape == (N, P), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]),
                                   err_msg=name, **REWARD_TOL)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total),
                               **TOTAL_TOL)
    # the kickoff reward is live in the kickoff arenas, for all six
    # players: each has a teammate at three a team
    kick = per["KickoffProximityReward2v2Enhanced"]
    assert int((kick != 0).any(-1).sum()) >= N // 4
    assert bool(((kick != 0).sum(0) > 0).all())


def test_terminals_at_three_a_team(envs):
    port, j3 = envs
    rng = np.random.RandomState(8)
    n = 64
    no_touch = round(8.0 / port.config.step_seconds)       # 60 env steps
    timeout = round(300.0 / port.config.step_seconds)      # 4500
    ints = {
        "steps_since_touch": rng.randint(no_touch - 3, no_touch + 3, n),
        "steps_since_reset": rng.randint(timeout - 3, timeout + 3, n),
        "blue_score": rng.randint(0, 4, n),
        "orange_score": rng.randint(0, 4, n)}
    ints = {k: v.astype(np.int32) for k, v in ints.items()}
    goal = rng.uniform(size=n) < 0.3
    want = jax.vmap(lambda g, kw: j3.terminal_fn(jenv.TerminalCtx(
        goal_scored=g, **kw)))(jnp.asarray(goal),
                               {k: jnp.asarray(v) for k, v in ints.items()})
    got = port.terminal_fn(tenv.TerminalCtx(
        goal_scored=torch.from_numpy(goal),
        **{k: torch.from_numpy(v) for k, v in ints.items()}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) >= 3        # every kind of end, and none


@pytest.mark.parametrize("old_team", [0, 1])
def test_old_opponent_leaves_the_new_team_to_the_update(envs, old_team,
                                                        monkeypatch):
    """An iteration against an old version on team ``old_team``: the
    update weighs the three players of the other team in every arena and
    env step, and none of the old team's, as the JAX trainer's
    ``~is_old_player`` rows.  The physics is a stand-in that returns the
    state it is given: the rows, not the physics, are under test."""
    _, j3 = envs
    monkeypatch.setattr(tenv, "arena_step", lambda phys, *a, **kw: phys)
    env = train_3v3.make_env(2, device="cpu")
    T = 2
    ppo = tppo.PPOConfig(policy_layers=(8,), critic_layers=(8,),
                         shared_head_layers=(8,), half_precision=False,
                         batch_size=T * 2 * P, epochs=1)
    trainer = ttrainer.Trainer(env, ppo, ttrainer.TrainerConfig(
        ts_per_itr=T * 2 * P, random_seed=3))
    seen = {}
    learn = trainer.learn

    def spy(state, traj, perms=None, weight=None):
        seen["weight"], seen["shape"] = weight, traj["action"].shape
        return learn(state, traj, perms=perms, weight=weight)
    trainer.learn = spy
    old = {k: v.detach().clone() for k, v in
           trainer.learner.named_parameters()}
    version = {"policy": {k[len("policy."):]: v for k, v in old.items()
                          if k.startswith("policy.")},
               "shared_head": {k[len("shared_head."):]: v
                               for k, v in old.items()
                               if k.startswith("shared_head.")}}
    trainer._train_iteration(trainer.init(0), version, old_team,
                             use_old=True)
    assert seen["shape"] == (T, 2, P)
    is_old_player = np.asarray(j3.teams) == old_team
    want = np.broadcast_to((~is_old_player).astype(np.float32)[None, None],
                           (T, 2, P)).reshape(-1)
    np.testing.assert_array_equal(seen["weight"].numpy(), want)
    assert seen["weight"].reshape(T, 2, P).sum(-1).eq(3).all()
