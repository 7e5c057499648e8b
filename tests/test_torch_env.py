"""The port's env (plane arena, 2v2) against the JAX ``RocketLeagueEnv``
on its XLA physics path, from the same reset state carried across.

Three steps with the same actions; arena 1 starts with the ball past the
orange goal line, so its first step scores and auto-resets.  The port's
kickoff draws its spawn-slot shuffle from its own generator, so the test
hands it the shuffle the JAX env draws for the same step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs import state_setters as tsetters
from reinforcement_learning_tpu import constants as JC
from reinforcement_learning_tpu.envs import env as jenv
from reinforcement_learning_tpu.envs import state_setters as jsetters
from test_torch_state import (flatten, jax_to_torch, plane_params_jax,
                              plane_params_torch)

torch.set_num_threads(1)

N, TEAM = 4, 2
P = 2 * TEAM
ATOL = 2e-3   # tests/test_env_pallas.py:48-51


def kickoff_orders(keys) -> np.ndarray:
    """The spawn-slot shuffle the JAX env's auto-reset draws this step
    (env._step_one -> _reset_one -> kickoff_state -> _kickoff_positions)."""
    def one(key):
        _, _, kreset = jax.random.split(key, 3)
        kset, _ = jax.random.split(kreset)
        kcars, _ = jax.random.split(kset)
        kshuf, _ = jax.random.split(kcars)
        return jax.random.permutation(kshuf, JC.CAR_SPAWN_LOCATION_AMOUNT)
    return np.asarray(jax.vmap(one)(keys))


@pytest.fixture(scope="module")
def envs():
    jax_env = jenv.RocketLeagueEnv(jenv.EnvConfig(
        num_envs=N, team_size=TEAM, physics_backend="xla",
        arena=plane_params_jax(P)))
    orders = {"now": np.tile(np.arange(JC.CAR_SPAWN_LOCATION_AMOUNT),
                             (N, 1))}
    port_env = tenv.RocketLeagueEnv(
        tenv.EnvConfig(num_envs=N, team_size=TEAM,
                       arena=plane_params_torch(P), device="cpu"),
        state_setter=tsetters.kickoff_state(
            order_fn=lambda n, g, d: torch.tensor(orders["now"])))
    return jax_env, port_env, orders


@pytest.fixture(scope="module")
def trace(envs):
    """Both envs from the JAX reset state: the reset observations, then
    three steps with the same actions."""
    jax_env, port_env, orders = envs
    like = port_env.reset(0)[0]
    jstate, jobs, jmask = jax_env.reset(jax.random.PRNGKey(3))
    pstate = jax_to_torch(jstate, like)
    init = (np.asarray(jobs), port_env.obs(pstate).numpy(),
            np.asarray(jmask), port_env.action_mask(pstate).numpy())
    ball = jstate.phys.arena.ball
    ball = ball.replace(pos=ball.pos.at[1].set(jnp.array([0.0, 5300.0,
                                                           300.0])))
    jstate = jstate.replace(phys=jstate.phys.replace(
        arena=jstate.phys.arena.replace(ball=ball)))
    pstate = jax_to_torch(jstate, like)
    step = jax.jit(jax_env.step)
    rng = np.random.RandomState(0)
    outs = []
    for _ in range(3):
        actions = rng.randint(0, 90, (N, P)).astype(np.int32)
        orders["now"] = kickoff_orders(jstate.key)
        jstate, jout = step(jstate, jnp.asarray(actions))
        pstate, pout = port_env.step(pstate, torch.from_numpy(actions))
        outs.append((jout, pout))
    return init, outs, jstate, pstate


def test_reset_obs_and_masks_match(trace):
    (jobs, pobs, jmask, pmask), _, _, _ = trace
    np.testing.assert_allclose(pobs, jobs, atol=1e-5)
    np.testing.assert_array_equal(pmask, jmask)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_step_outputs_match(trace, t):
    jout, pout = trace[1][t]
    for name in ("obs", "final_obs", "reward"):
        np.testing.assert_allclose(getattr(pout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=ATOL, err_msg=name)
    for name in ("terminal_type", "action_mask", "ball_touched",
                 "goal_scored"):
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=name)
    assert set(pout.reward_components) == set(jout.reward_components)
    for name, v in jout.reward_components.items():
        np.testing.assert_allclose(pout.reward_components[name].numpy(),
                                   np.asarray(v), atol=ATOL, err_msg=name)


def test_forced_goal_resets_the_arena(trace):
    jout, pout = trace[1][0]
    assert pout.goal_scored.tolist() == [False, True, False, False]
    assert pout.terminal_type.tolist() == [0, 1, 0, 0]
    # the final obs still sees the ball in the net; the obs after reset
    # sees it back at the centre
    assert pout.final_obs[1, 0, 1] > 2.0
    assert abs(float(pout.obs[1, 0, 1])) < 1e-6


def test_env_state_matches_after_three_steps(trace):
    _, _, jstate, pstate = trace
    want, got = flatten(jstate), flatten(pstate)
    for name, g in got.items():
        w = want[name]
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=0.2, rtol=1e-3,
                                       err_msg=name)


@pytest.mark.parametrize("teams", [[0, 0, 1, 1], [0, 1],
                                   [0, 0, 0, 1, 1, 1]])
def test_kickoff_given_the_jax_permutation(teams):
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    want = jax.vmap(lambda k: jsetters._kickoff_positions(
        k, jnp.asarray(teams)))(keys)
    # the shuffle _kickoff_positions draws from its key
    orders = jax.vmap(lambda k: jax.random.permutation(
        jax.random.split(k)[0], JC.CAR_SPAWN_LOCATION_AMOUNT))(keys)
    pos, yaw = tsetters.kickoff_positions(
        torch.from_numpy(np.asarray(orders)), torch.tensor(teams))
    np.testing.assert_allclose(pos.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(yaw.numpy(), np.asarray(want[1]), atol=1e-6)
