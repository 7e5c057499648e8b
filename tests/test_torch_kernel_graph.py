"""The kernel wrapper (``ops/arena_step.py``: pack, launch, unpack) replayed
from a CUDA graph (``utils/cuda_graph.py``) against the same wrapper run
eagerly.

On the card (marked ``card``; skip without one; ``tests/torch_card.py``
has the command): the envs the programs step (the example's at 4 and 6
cars, the main path's, a skill match's at 16 arenas, 1v1), 48 env steps
each of played states with auto-resets forced at staggered counts,
``arena_step`` against ``_launch`` on the same state, controls and respawn
draws, every output leaf bit for bit; what a call returned is not changed
by the next; the counters read one eager call, one capture and a replay
for every later call, the capture's own included, per key; a training key
and a match key interleave in one process; heatseeker's and snowday's
params capture graphs of their own; ``Trainer.train`` with a skill match
replays every wrapper call but the first of each key.

On the CPU: ``GraphedFn`` without a generator runs every call eagerly and
counts it, and the wrapper builds no tensor from host data, which a graph
could not replay.
"""

from __future__ import annotations

import ctypes

import pytest
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.utils import cuda_graph, tracing
from torch_card import (assert_same, bench_env, card, copy_tree,
                        example_env, goal_and_timeout, heatseeker_env,
                        match_env, one_v_one_env, short_timeout, staggered,
                        three_v_three_env)

STEPS = 48


@pytest.fixture(autouse=True)
def fresh():
    """Counters from zero and no graph of an earlier test."""
    tracing.reset()
    A._graphed.cache_clear()
    yield
    tracing.reset()
    A._graphed.cache_clear()


def snowday_env(device, n=2):
    env = RocketLeagueEnv(EnvConfig(num_envs=n, team_size=2,
                                    game_mode="snowday", device=device))
    return short_timeout(env, *goal_and_timeout(env))


def _teams(env) -> tuple:
    return tuple(int(t) for t in env.teams_np)


def _inputs(env, state, gen: torch.Generator):
    n, p = state.steps_since_touch.shape[0], env.config.cars_per_arena
    idx = torch.randint(0, env.num_actions, (n, p), generator=gen,
                        device=env.device)
    controls = env.action_parser.parse(idx)
    respawn_idx = torch.randint(0, C.CAR_RESPAWN_LOCATION_AMOUNT, (n, p),
                                generator=gen, device=env.device,
                                dtype=torch.int32)
    return controls, respawn_idx


class _Stepper:
    """One env's state stepped by the graphed wrapper, each step checked
    against the eager wrapper on the same inputs."""

    def __init__(self, env, seed: int):
        self.env = env
        self.gen = torch.Generator(device=env.device).manual_seed(seed)
        state, _, _ = env.reset(2147483711 + seed)
        self.state = staggered(state)
        self.kept = None
        self.mixed = 0

    def step(self):
        env, cfg = self.env, self.env.config
        controls, respawn_idx = _inputs(env, self.state, self.gen)
        phys = self.state.phys
        got = A.arena_step(phys, controls, respawn_idx, env.params,
                           env.teams_np, cfg.tick_skip, cfg.action_delay)
        want = A._launch(A._library(), phys, controls, respawn_idx,
                         env.params, _teams(env), cfg.tick_skip,
                         cfg.action_delay,
                         torch.cuda.current_stream().cuda_stream)
        assert_same(got, want)
        if self.kept is not None:  # the last call's outputs stay as they were
            assert_same(self.kept[0], self.kept[1])
        self.kept = (got, copy_tree(got))
        self.state, out = env.post_physics(self.state, got, controls)
        n = out.terminal_type.shape[0]
        self.mixed += 0 < int((out.terminal_type != 0).sum()) < n


def _counts() -> tuple:
    c = tracing.summary()["counters"]
    return (c.get("kernel.eager", 0), c.get("kernel.graph_captures", 0),
            c.get("kernel.graph_replays", 0), c.get("kernel.launches", 0))


ENVS = {"example": example_env, "bench": bench_env, "match": match_env,
        "3v3": three_v_three_env, "1v1": one_v_one_env}


@pytest.mark.card
@pytest.mark.parametrize("which", sorted(ENVS))
def test_wrapper_graph_equals_eager_on_the_card(card, which):
    s = _Stepper(ENVS[which](card), 0)
    for _ in range(STEPS):
        s.step()
    assert s.mixed >= STEPS // 2
    # the capturing call replays too
    assert _counts() == (1, 1, STEPS - 1, STEPS)


@pytest.mark.card
def test_training_and_match_keys_interleave(card):
    train = _Stepper(example_env(card), 1)
    match = _Stepper(match_env(card), 2)
    for _ in range(STEPS // 2):
        train.step()
        match.step()
        match.step()
    n = STEPS // 2 * 3
    assert _counts() == (2, 2, n - 2, n)


@pytest.mark.card
def test_game_modes_capture_their_own_graphs(card):
    steppers = [_Stepper(make(card, 64), i) for i, make in enumerate(
        (bench_env, heatseeker_env, snowday_env))]
    shapes = {tuple(s.state.phys.arena.cars.boost.shape) for s in steppers}
    assert len(shapes) == 1
    assert len({s.env.params for s in steppers}) == 3
    for _ in range(6):
        for s in steppers:
            s.step()
    assert _counts() == (3, 3, 15, 18)
    assert A._graphed.cache_info().currsize == 3


@pytest.mark.card
def test_trainer_train_replays_the_wrapper(card):
    from reinforcement_learning_torch.examples import train_2v2
    from reinforcement_learning_torch.learn import selfplay as sp
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    n, steps, match_steps = 64, 8, 30
    env = train_2v2.make_env(n, device=card)
    skill = sp.SkillTrackerConfig(
        enabled=True, num_arenas=16, update_interval=1,
        sim_time=match_steps * env.config.step_seconds)
    trainer = Trainer(
        env, PPOConfig(shared_head_layers=(64,), policy_layers=(64,),
                       critic_layers=(64,)),
        TrainerConfig(ts_per_itr=n * 4 * steps),
        selfplay=sp.SelfPlayConfig(train_against_old_chance=0.0,
                                   skill=skill),
        step_metrics_fn=train_2v2.step_metrics)
    seen = []
    tracing.enable()
    try:
        tracing.reset()
        trainer.train(trainer.init(3), 2,
                      log_fn=lambda _, m: seen.append(m))
    finally:
        tracing.disable()
    counts = [tuple(m.get(f"count/kernel.{k}", 0.0) for k in (
        "eager", "graph_captures", "graph_replays", "launches"))
        for m in seen]
    calls = steps + match_steps
    assert counts == [(2, 2, calls - 2, calls), (0, 0, calls, calls)]


# --- the CPU ---------------------------------------------------------------

def test_graphed_fn_without_a_generator_runs_eagerly_on_the_cpu():
    graphed = cuda_graph.GraphedFn(lambda x, y: {"sum": x + y}, "add", "cpu")
    x, y = torch.arange(4.0), torch.ones(4)
    for _ in range(3):
        assert torch.equal(graphed(x, y, key=None)["sum"], x + y)
    assert tracing.summary()["counters"] == {"add.eager": 3}


class _IdentityLib:
    """The kernel's library as ``_launch`` binds it, with a launch that
    copies each input buffer to its output: the state comes back as it
    went in."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.streams = []

    def arena_step_params_bytes(self):
        return self.nbytes

    def arena_step_launch(self, prm, nbytes, f_in, i_in, u_in, f_out, i_out,
                          u_out, ctl, ridx, E, Cn, tick_skip, action_delay,
                          stream):
        for dst, src, rows, size in (
                (f_out, f_in, A.CAR_F * Cn + A.BALL_F + A.NPADS, 4),
                (i_out, i_in, A.CAR_I * Cn + 1 + A.NPADS, 4),
                (u_out, u_in, A.CAR_U * Cn + 1 + A.NPADS, 1)):
            ctypes.memmove(dst, src, rows * E * size)
        self.streams.append(stream)
        return 0


CPU_ENVS = {"example": example_env, "bench": bench_env, "match": match_env,
            "1v1": one_v_one_env, "3v3": three_v_three_env,
            "heatseeker": heatseeker_env, "snowday": snowday_env}


@pytest.mark.parametrize("which", sorted(CPU_ENVS))
def test_wrapper_builds_no_tensor_from_host_data(which, monkeypatch):
    env = CPU_ENVS[which]("cpu", 2)
    state, _, _ = env.reset(3)
    cfg = env.config
    controls, respawn_idx = _inputs(env, state,
                                    torch.Generator().manual_seed(4))
    lib = _IdentityLib(A.pack_params(env.params, _teams(env)).nbytes)
    for name in ("tensor", "as_tensor", "from_numpy"):
        def refuse(*args, _name=name, **kw):
            raise AssertionError(f"torch.{_name} in the graphed wrapper")
        monkeypatch.setattr(torch, name, refuse)
    out = A._launch(lib, state.phys, controls, respawn_idx, env.params,
                    _teams(env), cfg.tick_skip, cfg.action_delay, None)
    assert lib.streams == [None]
    assert_same(out, state.phys)
