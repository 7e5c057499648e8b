"""The slice as a whole: ``Trainer.collect`` of the port against a loop of
the JAX env step (XLA physics, plane arena) and the JAX learner's
deterministic ``sample_actions``, with the same weights and the same start
state: 2 arenas, 2v2, a 32-wide MLP, fp32, 3 env steps."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_tpu.envs import env as jenv
from reinforcement_learning_tpu.learn import ppo as jppo
from test_torch_state import jax_to_torch, plane_params_jax, \
    plane_params_torch

torch.set_num_threads(1)

N, TEAM, T = 2, 2, 3
P = 2 * TEAM
ATOL = 2e-3   # tests/test_env_pallas.py:48-51
PPO = dict(policy_layers=(32, 32), critic_layers=(32, 32),
           shared_head_layers=(32,), half_precision=False,
           deterministic=True)


@pytest.fixture(scope="module")
def rollouts():
    jax_env = jenv.RocketLeagueEnv(jenv.EnvConfig(
        num_envs=N, team_size=TEAM, physics_backend="xla",
        arena=plane_params_jax(P)))
    jl = jppo.PPOLearner(jax_env.obs_size, jax_env.num_actions,
                         jppo.PPOConfig(**PPO))
    params = jl.init(jax.random.PRNGKey(1)).params
    jstate, jobs, jmask = jax_env.reset(jax.random.PRNGKey(2))

    port_env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=N, team_size=TEAM, arena=plane_params_torch(P),
        device="cpu"))
    trainer = ttrainer.Trainer(port_env, tppo.PPOConfig(**PPO),
                               ttrainer.TrainerConfig(ts_per_itr=N * P * T))
    tree = jax.tree.map(np.asarray, {"shared_head": params.shared_head,
                                     "policy": params.policy,
                                     "critic": params.critic})
    trainer.learner.params_from_jax(tree)
    start = ttrainer.TrainState(
        env_states=jax_to_torch(jstate, port_env.reset(0)[0]),
        obs=torch.from_numpy(np.array(jobs)),
        masks=torch.from_numpy(np.array(jmask)))
    _, got = trainer.collect(start, T)

    step = jax.jit(jax_env.step)
    want = []
    obs, masks = jobs, jmask
    for _ in range(T):
        actions, logp = jl.sample_actions(
            params, obs.reshape(N * P, -1), masks.reshape(N * P, -1),
            jax.random.PRNGKey(0), deterministic=True)
        act = actions.reshape(N, P).astype(jnp.int32)
        jstate, out = step(jstate, act)
        want.append(dict(
            obs=obs, mask=masks, action=act, old_logp=logp.reshape(N, P),
            reward=out.reward, terminal=out.terminal_type,
            final_obs=out.final_obs, goal=out.goal_scored,
            touch=out.ball_touched,
            reward_components={k: jnp.mean(v) for k, v in
                               out.reward_components.items()}))
        obs, masks = out.obs, out.action_mask
    return got, want


def test_traj_has_the_jax_keys_and_shapes(rollouts):
    got, want = rollouts
    assert set(got) == set(want[0])
    for k, v in want[0].items():
        if k != "reward_components":
            assert tuple(got[k].shape) == (T,) + tuple(np.shape(v)), k
    assert set(got["reward_components"]) == set(want[0]["reward_components"])


@pytest.mark.parametrize("key", ["obs", "final_obs", "reward", "old_logp"])
def test_float_traj_entries_match(rollouts, key):
    got, want = rollouts
    for t in range(T):
        np.testing.assert_allclose(got[key][t].numpy(),
                                   np.asarray(want[t][key]), atol=ATOL,
                                   err_msg=f"{key} step {t}")


@pytest.mark.parametrize("key", ["mask", "action", "terminal", "goal",
                                 "touch"])
def test_discrete_traj_entries_match(rollouts, key):
    got, want = rollouts
    for t in range(T):
        np.testing.assert_array_equal(got[key][t].numpy(),
                                      np.asarray(want[t][key]),
                                      err_msg=f"{key} step {t}")


def test_reward_components_match(rollouts):
    got, want = rollouts
    for name, v in got["reward_components"].items():
        np.testing.assert_allclose(
            v.numpy(), [float(w["reward_components"][name]) for w in want],
            atol=ATOL, err_msg=name)
