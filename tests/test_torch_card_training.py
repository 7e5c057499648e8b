"""The training programs on the card: collection, the main path's
``train_iteration``, the game modes, the train_2v2 and train_1v1 twins.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).  The kernel's launches are counted by the port's tracer
(``kernel.launches``, zeroed before and read after); each path's end state
is stepped by the kernel and by the plain version (``ops/ctick.py``) and
held to ``ops.ctick.TOLERANCES`` with one arena allowed a differing flag.

- ``Trainer.collect`` of 24 env steps at the bench widths, 1024 x 2v2, on
  the plane arena and at full fidelity: 24 launches, the trajectory's
  shapes, finite, legal actions;
- the main path, ``Trainer.train_iteration`` at bench.py's shape: after a
  warm-up, 24 launches an iteration over 3, every metric finite, every
  parameter changed (``torch_card.bench_run``); one iteration each of
  heatseeker and snowday;
- the train_2v2 twin's own configuration (``torch_card.twin``: 512 x 2v2,
  the 13-term rewards, the 768-wide model, self-play), skill matches
  every iteration and the second of 3 iterations against an old version
  for certain: version 0 is the parameters before the first update, the
  old team's rows weigh 0, the ratings follow the ELO rule on the goals
  counted, the launches of the iterations and the matches, the kernel on
  the end state and the match's, one env step on the card against the
  CPU, a checkpoint resumed bit-equal through ``init_or_resume``;
- one train_1v1 iteration; 3 deterministic env steps of 8 arenas on the
  card against the CPU.
"""

from __future__ import annotations

import math

import pytest
import torch

from bench_torch import bench_trainer
from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs import state_setters
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.examples import train_1v1
from reinforcement_learning_torch.examples import train_2v2 as twin_example
from reinforcement_learning_torch.learn.ppo import PPOConfig
from reinforcement_learning_torch.learn.trainer import Trainer, TrainerConfig
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.physics.step import ArenaParams
from reinforcement_learning_torch.utils import checkpoint as ckpt
from reinforcement_learning_torch.utils import tracing
from torch_card import (CARS, E, SEED, T, bench_run, card, check_metrics,
                        check_traj, collect_at_bench_width, counter,
                        kernel_agrees_at, parameters, sampled_actions, twin)

ARENAS = {"plane": ArenaParams(num_cars=CARS, use_mesh=False,
                               dynamic_wheel_rays=False),
          "full": None}            # the default: full fidelity


@pytest.mark.card
@pytest.mark.parametrize("arena", list(ARENAS))
def test_collection(card, arena):
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, device=card,
                                    arena=ARENAS[arena]))
    run = collect_at_bench_width(env)
    assert run["trainer"].steps_per_itr == T
    assert run["launches"] == T
    check_traj(env, run["traj"], T)
    gen = torch.Generator(device=card).manual_seed(SEED)
    kernel_agrees_at(env, run["state"].env_states.phys,
                     run["traj"]["action"][-1], gen)


@pytest.mark.card
def test_train_iteration_at_bench_shape(bench_run):
    trainer = bench_run["trainer"]
    assert trainer.steps_per_itr == T
    assert trainer.env.params.use_mesh and trainer.env.params.dynamic_wheel_rays
    assert bench_run["launches"] == 3 * T
    check_metrics(bench_run["metrics"], bench_run["before"],
                  bench_run["after"])


@pytest.mark.card
@pytest.mark.parametrize("mode", ["heatseeker", "snowday"])
def test_game_mode_iteration(card, mode):
    trainer = bench_trainer(E, mode, SEED)
    before = parameters(trainer.learner)
    state = trainer.init(SEED)
    tracing.reset()
    state, metrics = trainer.train_iteration(state)
    assert counter("kernel.launches") == T
    check_metrics(metrics, before, trainer.learner.parameters())
    gen = torch.Generator(device=card).manual_seed(SEED)
    kernel_agrees_at(trainer.env, state.env_states.phys,
                     sampled_actions(trainer, state, gen), gen)


# --- the train_2v2 twin (``torch_card.twin``) -----------------------------

@pytest.mark.card
def test_train_2v2_is_the_example(twin):
    trainer, ppo = twin["trainer"], twin["ppo"]
    assert twin["scale"] == 1.5
    assert trainer.learner.param_counts()["total"] == 4_345_435
    assert trainer.steps_per_itr == 48
    assert (ppo.optim, ppo.activation) == ("adamw", "leaky_relu")
    assert len(trainer.env.reward_fns) == 13


@pytest.mark.card
def test_train_2v2_snapshots_version_0(twin):
    assert twin["bank_count"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        twin["version0"].values(), twin["first"]))


@pytest.mark.card
def test_train_2v2_weighs_the_old_team_0(twin):
    trained_against_old, (w, shape) = twin["old"]
    assert trained_against_old == 1.0 and w is not None
    w = w.reshape(shape)
    per_player = w[0, 0]
    old = per_player == 0
    teams = twin["trainer"].env.teams
    assert torch.equal(w, per_player.expand_as(w))
    assert int(old.sum()) == shape[-1] // 2
    assert len(set(teams[old].tolist())) == 1


@pytest.mark.card
def test_train_2v2_ratings_follow_the_elo_rule(twin):
    assert twin["matches"]
    assert [info for ok, info in twin["matches"] if not ok] == []


@pytest.mark.card
def test_train_2v2_launches(twin):
    trainer = twin["trainer"]
    assert twin["timed_matches"] == 3
    assert twin["launches"] == (3 * trainer.steps_per_itr + 3
                                * trainer.skill_tracker.steps_per_run)


@pytest.mark.card
def test_train_2v2_metrics(twin):
    trainer, logged = twin["trainer"], twin["metrics"]
    assert not all(torch.equal(a, b) for a, b in zip(
        trainer.learner.policy.parameters(), twin["version0"].values())), (
        "the bank's version follows the trained parameters")
    assert [w.name for w in trainer.env.reward_fns
            if f"reward/{w.name}" not in logged] == []
    assert len([k for k in logged if k.startswith(("Player/", "Game/"))]) == 8
    check_metrics(logged, twin["before"], trainer.learner.parameters())


@pytest.mark.card
def test_train_2v2_kernel_at_end_states(twin, card):
    trainer, state = twin["trainer"], twin["state"]
    gen = torch.Generator(device=card).manual_seed(SEED)
    kernel_agrees_at(trainer.env, state.env_states.phys,
                     sampled_actions(trainer, state, gen), gen)
    # the last skill match's state, E=16
    tracker = trainer.skill_tracker
    sst, sobs, smasks = tracker.env_states
    actions = trainer.learner.sample_actions(
        sobs.reshape(-1, sobs.shape[-1]), smasks.reshape(
            -1, smasks.shape[-1]), generator=gen)[0].reshape(sobs.shape[:2])
    kernel_agrees_at(tracker.env, sst.phys, actions, gen)


@pytest.mark.card
def test_train_2v2_step_on_the_card_equals_the_cpu(twin, card):
    """One env step of the twin's config from the played state's first 32
    arenas: the kernel on the card against the plain version on the CPU,
    the same actions, respawn draws and kickoff shuffles."""
    trainer, state, sub = twin["trainer"], twin["state"], 32
    states = tree_map(lambda t: t[:sub], state.env_states)
    obs, masks = state.obs[:sub], state.masks[:sub]
    p = obs.shape[1]
    actions = trainer.learner.sample_actions(
        obs.reshape(sub * p, -1), masks.reshape(sub * p, -1),
        deterministic=True)[0].reshape(sub, p)
    gen = torch.Generator().manual_seed(SEED)
    order = torch.randperm(C.CAR_SPAWN_LOCATION_AMOUNT,
                           generator=gen).repeat(sub, 1)
    r = torch.randint(0, 4, (sub, p), generator=gen, dtype=torch.int32)
    outs = {}
    for where in (card, "cpu"):
        env = twin_example.make_env(sub, device=where)
        env.state_setter = state_setters.kickoff_state(
            order_fn=lambda n, g, d: order[:n].to(d))
        st = tree_map(lambda t: t.to(where), states)
        ctl = env.action_parser.parse(actions.to(where))
        phys = A.arena_step(st.phys, ctl, r.to(where), env.params,
                            env.teams_np)
        outs[where] = env.post_physics(st, phys, ctl)[1]
    kern, plain = outs[card], outs["cpu"]
    floats = {"obs": (kern.obs, plain.obs),
              "final_obs": (kern.final_obs, plain.final_obs),
              "reward": (kern.reward, plain.reward)}
    floats.update({f"reward/{k}": (v, plain.reward_components[k])
                   for k, v in kern.reward_components.items()})
    for k, (a, b) in floats.items():
        assert float((a.cpu() - b).abs().max()) <= 2e-3, k
    for k in ("terminal_type", "action_mask", "goal_scored", "ball_touched"):
        assert torch.equal(getattr(kern, k).cpu(), getattr(plain, k)), k


@pytest.mark.card
def test_train_2v2_checkpoint_resumes_bit_equal(twin):
    trainer, state = twin["trainer"], twin["state"]
    trainer.save(state)
    saved = ckpt.flatten(ckpt.snapshot(trainer, state))
    fresh = twin["make_trainer"]()
    resumed = fresh.init_or_resume()
    got = ckpt.flatten(ckpt.snapshot(fresh, resumed))
    assert set(got) == set(saved)
    for k, v in saved.items():
        w = got[k]
        if isinstance(v, torch.Tensor):
            assert (v.dtype, v.shape) == (w.dtype, w.shape), k
            assert torch.equal(v.cpu(), w.cpu()), k
        else:
            assert v == w, k
    assert resumed.total_timesteps == state.total_timesteps
    _, metrics = fresh.train_iteration(resumed)
    assert all(math.isfinite(float(v)) for v in metrics.values())


# --- train_1v1; the card against the CPU -----------------------------------

@pytest.mark.card
def test_train_1v1(card):
    trainer = Trainer(train_1v1.make_env(device=card),
                      train_1v1.ppo_config(), train_1v1.trainer_config())
    state = trainer.init(SEED)
    before = parameters(trainer.learner)
    tracing.reset()
    state, metrics = trainer.train_iteration(state)
    assert counter("kernel.launches") == trainer.steps_per_itr
    check_metrics(metrics, before, trainer.learner.parameters())
    gen = torch.Generator(device=card).manual_seed(SEED)
    kernel_agrees_at(trainer.env, state.env_states.phys,
                     sampled_actions(trainer, state, gen), gen)


@pytest.mark.card
def test_collection_on_the_card_equals_the_cpu(card):
    """3 deterministic env steps at 8 arenas, full fidelity, fp32: the
    kernel path on the card against the plain path on the CPU, from the
    same kickoff and weights."""
    small = PPOConfig(policy_layers=(64, 64), critic_layers=(64, 64),
                      shared_head_layers=(64,), half_precision=False,
                      deterministic=True)
    trainers = {where: Trainer(
        RocketLeagueEnv(EnvConfig(num_envs=8, team_size=2, device=where)),
        small, TrainerConfig(ts_per_itr=32, random_seed=SEED))
        for where in ("cpu", card)}
    trainers[card].learner.load_state_dict(trainers["cpu"].learner.state_dict())
    start = trainers["cpu"].init(SEED)
    plain = trainers["cpu"].collect(start, 3)[1]
    kern = trainers[card].collect(tree_map(lambda t: t.to(card), start),
                                  3)[1]
    for k in ("obs", "final_obs", "reward", "old_logp"):
        assert float((kern[k].cpu() - plain[k]).abs().max()) <= 2e-3, k
    for k in ("action", "terminal", "mask"):
        assert torch.equal(kern[k].cpu(), plain[k]), k
