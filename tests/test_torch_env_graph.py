"""Post-physics replayed from a CUDA graph (``RocketLeagueEnv.post_physics``,
``utils/cuda_graph.py``) against the same code run eagerly.

On the card (marked ``card``; skip without one; ``tests/torch_card.py``
has the command): every env the programs step (the 3v3 example's and its
skill match's at six cars among them), 48 env steps each with the kernel's
physics and auto-resets forced by a short no-touch timeout that each arena
starts at another count, the graphed call against the eager one on the
same inputs and generator state, bit for bit, and the generator's state
after; what a call returned is not changed by the next; a re-seed after
the capture draws what the eager path draws; ``Trainer.collect`` collects
the same trajectories either way.

On the CPU: every call runs eagerly and counts as such, and post-physics
builds no tensor from host data, which a graph could not replay.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from reinforcement_learning_torch.envs import state_setters
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.envs.shard import EnvShard
from reinforcement_learning_torch.examples import train_2v2
from reinforcement_learning_torch.utils import cuda_graph, tracing
from torch_card import (assert_same, bench_env, card, copy_tree,
                        example_env, goal_and_timeout, heatseeker_env,
                        match_env, one_v_one_env, short_timeout, staggered,
                        three_v_three_env)

STEPS = 48


@pytest.fixture(autouse=True)
def counters():
    tracing.reset()
    yield
    tracing.reset()


def match_3v3_env(device, n=16):
    """The 3v3 example's skill match: the 6-car kernel at 16 arenas."""
    return match_env(device, n, team_size=3)


def block_env(device, n=1024):
    """The second of two data-parallel blocks of the bench env."""
    env = bench_env(device, n)
    env.shard = EnvShard(n, offset=n // 2, local_envs=n // 2)
    return env


def combined_env(device, n=2):
    """The kickoff or a random state, picked per arena."""
    env = RocketLeagueEnv(
        EnvConfig(num_envs=n, team_size=1, device=device),
        state_setter=state_setters.combined_state(
            [(state_setters.kickoff_state(), 1.0),
             (state_setters.random_state(), 2.0)]))
    return short_timeout(env, *goal_and_timeout(env))


def _compare_steps(env, state, steps: int, actions: torch.Generator):
    """``steps`` env steps, each post-physics graphed and eager on the same
    inputs and generator state.  Returns (state, steps with some arenas
    terminal and some not)."""
    n, p = state.steps_since_touch.shape[0], env.config.cars_per_arena
    kept = None
    mixed = 0
    for _ in range(steps):
        idx = torch.randint(0, env.num_actions, (n, p), generator=actions,
                            device=env.device)
        controls = env.action_parser.parse(idx)
        phys = env.physics_step(state, controls)
        before = env.generator.get_state()
        got = env.post_physics(state, phys, controls)
        after = env.generator.get_state()
        env.generator.set_state(before)
        want = env._post_physics(state, phys, controls)
        assert torch.equal(env.generator.get_state(), after)
        assert_same(got, want)
        if kept is not None:       # the last call's outputs stay as they were
            assert_same(kept[0], kept[1])
        kept = (got, copy_tree(got))
        terminal = int((got[1].terminal_type != 0).sum())
        mixed += 0 < terminal < n
        state = got[0]
    return state, mixed


ENVS = {"example": example_env, "bench": bench_env, "match": match_env,
        "1v1": one_v_one_env, "block": block_env, "3v3": three_v_three_env,
        "match3v3": match_3v3_env}


@pytest.mark.card
@pytest.mark.parametrize("which", sorted(ENVS))
def test_graph_equals_eager_on_the_card(card, which):
    env = ENVS[which](card)
    actions = torch.Generator(device=card).manual_seed(5)
    state, _, _ = env.reset(2147483711)
    state, mixed = _compare_steps(env, staggered(state), STEPS,
                                  actions)
    assert mixed >= STEPS // 2
    c = tracing.summary()["counters"]
    assert (c["env.post.eager"], c["env.post.graph_captures"],
            c["env.post.graph_replays"]) == (1, 1, STEPS - 1)
    # a re-seed after the capture: the replay draws what eager draws
    state, _, _ = env.reset(17)
    _compare_steps(env, staggered(state), 4, actions)
    c = tracing.summary()["counters"]
    assert (c["env.post.eager"], c["env.post.graph_captures"],
            c["env.post.graph_replays"]) == (1, 1, STEPS + 3)


@pytest.mark.card
def test_collect_graphed_equals_eager(card):
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    ppo = PPOConfig(shared_head_layers=(64,), policy_layers=(64,),
                    critic_layers=(64,))
    trajs = []
    for graphed in (True, False):
        env = example_env(card, 64)
        trainer = Trainer(env, ppo, TrainerConfig(ts_per_itr=64 * 4 * 8),
                          step_metrics_fn=train_2v2.step_metrics)
        if not graphed:
            env.post_physics = env._post_physics
        state = trainer.init(3)
        state = dataclasses.replace(
            state, env_states=staggered(state.env_states))
        state, traj = trainer.collect(state, T=16)
        trajs.append((state.env_states, state.obs, traj))
    assert_same(trajs[0], trajs[1])
    assert tracing.summary()["counters"]["env.post.graph_replays"] == 15


# --- the CPU ---------------------------------------------------------------

CPU_ENVS = {"example": example_env, "match": match_env, "1v1": one_v_one_env,
            "block": block_env, "heatseeker": heatseeker_env,
            "combined": combined_env, "3v3": three_v_three_env,
            "match3v3": match_3v3_env}


def _cpu_env(which):
    n = 4 if which == "block" else 2
    env = CPU_ENVS[which]("cpu", n)
    state, _, _ = env.reset(3)
    p = env.config.cars_per_arena
    controls = env.action_parser.parse(torch.zeros(
        state.steps_since_touch.shape[0], p, dtype=torch.int64))
    # the reset state stands in for the physics' next state, with a goal
    # in the first arena
    phys = copy_tree(state.phys)
    phys.arena.goal_scored[0] = True
    return env, staggered(state), phys, controls


def test_cpu_runs_every_call_eagerly():
    env, state, phys, controls = _cpu_env("example")
    for _ in range(3):
        before = env.generator.get_state()
        got = env.post_physics(state, phys, controls)
        env.generator.set_state(before)
        assert_same(got, env._post_physics(state, phys, controls))
    assert tracing.summary()["counters"] == {"env.post.eager": 3}


@pytest.mark.parametrize("which", sorted(CPU_ENVS))
def test_post_physics_builds_no_tensor_from_host_data(which, monkeypatch):
    env, state, phys, controls = _cpu_env(which)
    built = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        def counting(*args, _orig=getattr(torch, name), _name=name, **kw):
            built.append(_name)
            return _orig(*args, **kw)
        monkeypatch.setattr(torch, name, counting)
    _, out = env.post_physics(state, phys, controls)
    assert built == []
    assert bool(out.goal_scored[0])


def test_flatten_round_trip():
    env, state, phys, controls = _cpu_env("match")
    tree = env.post_physics(state, phys, controls)
    leaves = []
    spec = cuda_graph.flatten(tree, leaves)
    hash(spec)                                # a graph's key holds it
    assert tree[1].reward is None             # no rewards: a constant
    back = cuda_graph.unflatten(spec, iter(leaves))
    assert back[1].reward is None
    again = []
    assert cuda_graph.flatten(back, again) == spec
    assert all(a is b for a, b in zip(again, leaves))
    assert len(leaves) == len(again) > 100
