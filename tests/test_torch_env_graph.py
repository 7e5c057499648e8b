"""Post-physics replayed from a CUDA graph (``RocketLeagueEnv.post_physics``,
``utils/cuda_graph.py``) against the same code run eagerly.

On the card (marked ``card``; skip without one; run them there with
``python -m pytest tests/test_torch_env_graph.py -q --noconftest``, as
this repository's ``tests/conftest.py`` imports JAX): every env the
programs step (the 3v3 example's and its skill match's at six cars among
them), 48 env steps each with the kernel's physics and auto-resets forced
by a short no-touch timeout that each arena starts at another count, the
graphed call against the eager one on the same inputs and generator
state, bit for bit, and the generator's state after; what a call returned
is not changed by the next; a re-seed after the capture draws what the
eager path draws; ``Trainer.collect`` collects the same trajectories
either way.

On the CPU: every call runs eagerly and counts as such, and post-physics
builds no tensor from host data, which a graph could not replay.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from reinforcement_learning_torch.envs import state_setters, terminals
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.envs.shard import EnvShard
from reinforcement_learning_torch.examples import (train_1v1, train_2v2,
                                                   train_3v3)
from reinforcement_learning_torch.utils import cuda_graph, tracing

STEPS = 48
NO_TOUCH_STEPS = 12     # the forced auto-reset: 0.8 s without a touch


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def counters():
    tracing.reset()
    yield
    tracing.reset()


def _short_timeout(env, *others):
    """``env`` with its no-touch timeout cut to ``NO_TOUCH_STEPS`` env
    steps, beside its other terminal conditions ``others``."""
    step_s = env.config.step_seconds
    env.terminal_fn = terminals.combine_conditions(
        [terminals.no_touch_condition(NO_TOUCH_STEPS * step_s, step_s)]
        + list(others))
    return env


def _goal_and_timeout(env):
    return (terminals.goal_score_condition(),
            terminals.timeout_condition(env.config.max_episode_seconds,
                                        env.config.step_seconds))


def example_env(device, n=512):
    """train_2v2's env: 2v2, AdvancedObs, the 13-term rewards, the score
    limit."""
    env = train_2v2.make_env(n, device=device)
    return _short_timeout(env, terminals.score_limit_condition(3),
                          _goal_and_timeout(env)[1])


def three_v_three_env(device, n=512):
    """train_3v3's env: six cars an arena, AdvancedObs 225, the 13-term
    rewards at three a team, the score limit."""
    env = train_3v3.make_env(n, device=device)
    return _short_timeout(env, terminals.score_limit_condition(3),
                          _goal_and_timeout(env)[1])


def bench_env(device, n=1024):
    """The main path's env at bench shape: the default rewards."""
    env = RocketLeagueEnv(EnvConfig(num_envs=n, team_size=2, device=device))
    return _short_timeout(env, *_goal_and_timeout(env))


def match_env(device, n=16, team_size=2):
    """A skill match's env (``selfplay.SkillTracker``): no rewards, the
    goal terminal, the kickoff fuzzed by 0.1."""
    env = RocketLeagueEnv(
        EnvConfig(num_envs=n, team_size=team_size, max_episode_seconds=1e9,
                  no_touch_timeout=1e9, device=device),
        reward_fns=[], state_setter=state_setters.kickoff_state(fuzz=0.1))
    return _short_timeout(env, terminals.goal_score_condition())


def match_3v3_env(device, n=16):
    """The 3v3 example's skill match: the 6-car kernel at 16 arenas."""
    return match_env(device, n, team_size=3)


def one_v_one_env(device, n=256):
    env = train_1v1.make_env(n, device=device)
    return _short_timeout(env, *_goal_and_timeout(env))


def block_env(device, n=1024):
    """The second of two data-parallel blocks of the bench env."""
    env = bench_env(device, n)
    env.shard = EnvShard(n, offset=n // 2, local_envs=n // 2)
    return env


def heatseeker_env(device, n=2):
    env = RocketLeagueEnv(EnvConfig(num_envs=n, team_size=2,
                                    game_mode="heatseeker", device=device))
    return _short_timeout(env, *_goal_and_timeout(env))


def combined_env(device, n=2):
    """The kickoff or a random state, picked per arena."""
    env = RocketLeagueEnv(
        EnvConfig(num_envs=n, team_size=1, device=device),
        state_setter=state_setters.combined_state(
            [(state_setters.kickoff_state(), 1.0),
             (state_setters.random_state(), 2.0)]))
    return _short_timeout(env, *_goal_and_timeout(env))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    """Equal trees, every tensor leaf equal bit for bit."""
    lg, lw = [], []
    assert cuda_graph.flatten(got, lg) == cuda_graph.flatten(want, lw)
    for a, b in zip(lg, lw):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert torch.equal(_bits(a), _bits(b))


def _copy(tree):
    leaves = []
    spec = cuda_graph.flatten(tree, leaves)
    return cuda_graph.unflatten(spec, iter([t.clone() for t in leaves]))


def _staggered(state):
    """Each arena starts its no-touch count at another step, so that some
    arenas reset on most steps and the others do not."""
    n = state.steps_since_touch.shape[0]
    start = torch.arange(n, device=state.steps_since_touch.device)
    return dataclasses.replace(
        state, steps_since_touch=(start % NO_TOUCH_STEPS).to(torch.int32))


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
        kept = (got, _copy(got))
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
    state, mixed = _compare_steps(env, _staggered(state), STEPS,
                                  actions)
    assert mixed >= STEPS // 2
    c = tracing.summary()["counters"]
    assert (c["env.post.eager"], c["env.post.graph_captures"],
            c["env.post.graph_replays"]) == (1, 1, STEPS - 1)
    # a re-seed after the capture: the replay draws what eager draws
    state, _, _ = env.reset(17)
    _compare_steps(env, _staggered(state), 4, actions)
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
            state, env_states=_staggered(state.env_states))
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
    phys = _copy(state.phys)
    phys.arena.goal_scored[0] = True
    return env, _staggered(state), phys, controls


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
