"""The port's learning services against the JAX package on the CPU: the MLP
activations, the AdamW, Adagrad and RMSprop optimisers, the PPO loss with
a policy temperature and a guiding policy, the update with a ``weight``
column, ``TransferLearner.update``, ``Report`` and ``RenderSender``'s
datagram; then port-only checks: a checkpoint resume continuing bit-equal
to an uninterrupted run, keep-N retention and the RUNNING_STATS keys, the
env-state snapshot, ``MetricSender`` and ``KeyPressDetector``, and a smoke
of both example twins.

Inputs are numpy-made from fixed seeds; JAX parameters go into the port
through ``params_from_jax``, the JAX minibatch permutations into
``update``.  Tolerances: the MLP forward, the optimiser steps, the loss
and the updated parameters 1e-6 (fp32, the same operations in another
summation order); the grads rtol 1e-4 as in tests/test_torch_learn.py;
the distillation's parameters after five steps 1e-5.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_torch.learn import transfer as ttransfer
from reinforcement_learning_torch.models import mlp as tmlp
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.utils import checkpoint as tckpt
from reinforcement_learning_tpu.learn import ppo as jppo
from reinforcement_learning_tpu.learn import transfer as jtransfer
from reinforcement_learning_tpu.learn import welford as jwelford
from reinforcement_learning_tpu.models import mlp as jmlp
from reinforcement_learning_tpu.utils import checkpoint as jckpt
from test_torch_learn import (GRAD, MODELS, _assert_trees, _batch, _cfg,
                              _jax_perms, _np_tree, _port_tree)
from test_torch_state import flatten

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=1e-6, atol=1e-6)
PARAMS = dict(rtol=0, atol=1e-6)
OBS, ACTIONS = 12, 9


def _learners(seed=0, **kw):
    jl = jppo.PPOLearner(OBS, ACTIONS, jppo.PPOConfig(**_cfg(**kw)))
    jstate = jl.init(jax.random.PRNGKey(seed))
    tl = tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_cfg(**kw)),
                         device="cpu")
    tl.params_from_jax(_tree(jstate.params))
    return jl, jstate, tl


def _tree(params):
    return {"shared_head": _np_tree(params.shared_head),
            "policy": _np_tree(params.policy),
            "critic": _np_tree(params.critic)}


# ---------------------------------------------------------------------------
# the MLP's activations

@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "sigmoid",
                                        "tanh"])
def test_mlp_activation_matches_jax(activation):
    cfg = dict(num_inputs=OBS, layer_sizes=(24, 16), num_outputs=5,
               activation=activation)
    jcfg = jmlp.MLPConfig(**cfg)
    params = jmlp.init_mlp(jax.random.PRNGKey(1), jcfg)
    model = tmlp.MLP(tmlp.MLPConfig(**cfg), device="cpu").load_jax(
        _np_tree(params))
    x = np.random.RandomState(2).normal(0, 2, (40, OBS)).astype(np.float32)
    want = jmlp.apply_mlp(params, jcfg, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **EXACT)
    # bf16 inference takes the activation too
    half = model(torch.from_numpy(x), half_precision=True)
    np.testing.assert_allclose(half.detach().numpy(), np.asarray(want),
                               atol=0.1)


# ---------------------------------------------------------------------------
# optimisers

@pytest.mark.parametrize("optim", ["adamw", "adagrad", "rmsprop"])
def test_optimizer_steps_match_optax(optim):
    """Four steps of the port's optimiser after the 0.5 global-norm clip
    against optax.chain(clip_by_global_norm(0.5), optax.<optim>(lr)) on
    the same grads: some below the clip, some above it."""
    _, jstate, tl = _learners(optim=optim)
    lr = tl.config.policy_lr
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     getattr(optax, optim)(lr))
    params = jstate.params.policy
    opt_state = tx.init(params)
    tx_update = jax.jit(tx.update)
    rng = np.random.RandomState(3)
    for step, scale in enumerate((0.01, 1.0, 0.02, 5.0)):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(
            0, scale, p.shape).astype(np.float32)), params)
        updates, opt_state = tx_update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for lin, d in zip(tl.policy.layers, grads["layers"]):
            lin.weight.grad = torch.from_numpy(np.asarray(d["w"]).T.copy())
            lin.bias.grad = torch.from_numpy(np.array(d["b"]))
        for norm, d in zip(tl.policy.norms, grads["layers"]):
            norm.weight.grad = torch.from_numpy(np.array(d["ln_scale"]))
            norm.bias.grad = torch.from_numpy(np.array(d["ln_bias"]))
        tl.policy.out.weight.grad = torch.from_numpy(
            np.asarray(grads["out"]["w"]).T.copy())
        tl.policy.out.bias.grad = torch.from_numpy(
            np.array(grads["out"]["b"]))
        tl._step_model("policy")
        _assert_trees(_port_tree(tl.policy, lambda p: p.detach().numpy()),
                      params, PARAMS, f"{optim} step {step}")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_cfg(optim="sgd")),
                        device="cpu")


# ---------------------------------------------------------------------------
# loss and update with temperature, guiding policy and weights

def test_loss_with_temperature_and_guiding_matches_jax():
    kw = dict(policy_temperature=0.7, guiding_strength=0.3)
    jl, jstate, tl = _learners(**kw)
    guide = jl.init(jax.random.PRNGKey(5)).params
    b = _batch(40, weight=True)
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(
        jl._loss, has_aux=True))(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()}, guide)
    total, aux = tl.loss({k: torch.from_numpy(v) for k, v in b.items()},
                         tl.guide(_tree(guide)))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               **EXACT)
    assert float(aux["guiding_loss"]) > 0
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **EXACT,
                                   err_msg=k)
    for name in MODELS:
        _assert_trees(_port_tree(getattr(tl, name),
                                 lambda p: p.grad.numpy()),
                      getattr(jgrads, name), GRAD, f"grad {name}")


@pytest.mark.parametrize("optim", ["adamw", "rmsprop"])
def test_update_with_weights_guiding_and_temperature_matches_jax(optim):
    """Two epochs x two minibatches with a weight column, a temperature
    and a guiding policy (given as a learner), the JAX permutations
    handed in."""
    kw = dict(policy_temperature=1.5, guiding_strength=0.5, optim=optim)
    jl, jstate, tl = _learners(**kw)
    guide_params = jl.init(jax.random.PRNGKey(6)).params
    guide = tppo.PPOLearner(OBS, ACTIONS, tl.config, device="cpu")
    guide.params_from_jax(_tree(guide_params))
    data = _batch(75, seed=4, weight=True)
    key = jax.random.PRNGKey(9)
    jnew, jm = jl.update(jstate, {k: jnp.asarray(v)
                                  for k, v in data.items()}, key,
                         guiding_params=guide_params)
    metrics = tl.update({k: torch.from_numpy(v) for k, v in data.items()},
                        perms=torch.from_numpy(_jax_perms(key, 2, 75)),
                        guiding=guide)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **GRAD,
                                   err_msg=k)
    for name in MODELS:
        _assert_trees(_port_tree(getattr(tl, name),
                                 lambda p: p.detach().numpy()),
                      getattr(jnew.params, name), PARAMS, f"param {name}")


def test_user_metrics_reduce_as_the_jax_trainer():
    """``step_metrics_fn``'s values over an iteration: a plain value by
    its mean, a (value, weight) pair by the weighted mean over weight at
    least 1 (the JAX trainer's reduction, trainer.py:251-261)."""
    tr = _small_trainer()
    T, N, P = 3, 2, 2
    rng = np.random.RandomState(12)
    v = rng.normal(0, 3, (T, N, P)).astype(np.float32)
    w = rng.uniform(size=(T, N, P)) < 0.3
    g = rng.normal(0, 1, (T, N)).astype(np.float32)
    want = {"plain": jnp.mean(jnp.asarray(v)),
            "pair": jnp.sum(jnp.asarray(v) * jnp.asarray(w, jnp.float32))
            / jnp.maximum(jnp.sum(jnp.asarray(w, jnp.float32)), 1.0),
            "none": jnp.sum(jnp.asarray(g) * 0.0) / 1.0}
    state, traj = tr.collect(tr.init(0), T)
    traj["user_metrics"] = {
        "plain": torch.from_numpy(v),
        "pair": (torch.from_numpy(v), torch.from_numpy(w)),
        "none": (torch.from_numpy(g), torch.zeros(T, N, dtype=torch.bool))}
    _, _, metrics = tr.prepare(state, traj)
    for k, x in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(x), **EXACT,
                                   err_msg=k)


def test_trainer_guiding_params():
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=1, team_size=1, device="cpu",
        arena=tstep.ArenaParams(num_cars=2, use_mesh=False,
                                dynamic_wheel_rays=False)))
    small = tppo.PPOConfig(**_cfg())
    other = tppo.PPOLearner(env.obs_size, env.num_actions, small,
                            device="cpu", seed=4)
    with pytest.raises(ValueError):
        ttrainer.Trainer(env, small, guiding_params=other)
    tr = ttrainer.Trainer(env, dataclasses.replace(small,
                                                   guiding_strength=0.1),
                          guiding_params=other)
    assert all(torch.equal(a, b) for a, b in zip(tr.guiding.parameters(),
                                                 other.parameters()))
    assert not any(p.requires_grad for p in tr.guiding.parameters())


# ---------------------------------------------------------------------------
# transfer learning

@pytest.mark.parametrize("use_kl_div", [False, True])
def test_transfer_update_matches_jax(use_kl_div):
    """The new policy (12 obs, 9 actions) distilled from an old one (10
    obs, 7 actions) through an action map, five epochs."""
    cfg = dict(use_kl_div=use_kl_div, epochs=5, lr=1e-3, loss_exponent=1.5)
    jl, jstate, tl = _learners()
    jold = jppo.PPOLearner(10, 7, jppo.PPOConfig(**_cfg()))
    old_params = jold.init(jax.random.PRNGKey(8)).params
    told = tppo.PPOLearner(10, 7, tppo.PPOConfig(**_cfg()), device="cpu")
    told.params_from_jax(_tree(old_params))
    rng = np.random.RandomState(10)
    new_obs = rng.normal(0, 1, (30, OBS)).astype(np.float32)
    old_obs = rng.normal(0, 1, (30, 10)).astype(np.float32)
    new_masks = rng.uniform(size=(30, ACTIONS)) > 0.2
    old_masks = rng.uniform(size=(30, 7)) > 0.2
    new_masks[:, 0] = old_masks[:, 0] = True
    action_map = rng.randint(0, 7, ACTIONS).astype(np.int32)

    jt = jtransfer.TransferLearner(jl, jold,
                                   jtransfer.TransferLearnConfig(**cfg))
    jparams, _, jm = jt.update(
        jstate.params, jt.init_opt(jstate.params), old_params,
        *(jnp.asarray(x) for x in (new_obs, old_obs, new_masks,
                                   old_masks, action_map)))
    tt = ttransfer.TransferLearner(tl, told,
                                   ttransfer.TransferLearnConfig(**cfg))
    m = tt.update(*(torch.from_numpy(x) for x in (
        new_obs, old_obs, new_masks, old_masks, action_map.astype(
            np.int64))))
    for k in ("transfer_learn_loss", "transfer_learn_accuracy"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for name in ("policy", "shared_head"):
        _assert_trees(_port_tree(getattr(tl, name),
                                 lambda p: p.detach().numpy()),
                      getattr(jparams, name), dict(rtol=0, atol=1e-5),
                      name)
    # the critic is not trained
    _assert_trees(_port_tree(tl.critic, lambda p: p.detach().numpy()),
                  jstate.params.critic, dict(rtol=0, atol=0), "critic")


def test_transfer_run_distils_on_the_env():
    """``run``: the new policy plays the env while the teacher's obs come
    from DefaultObs on the same states; each batch is distilled."""
    from reinforcement_learning_torch.envs.obs import DefaultObs
    env = _small_trainer().env
    new = tppo.PPOLearner(env.obs_size, env.num_actions,
                          tppo.PPOConfig(**_cfg()), device="cpu")
    old_obs = DefaultObs(2, env.teams_np, device="cpu")
    old = tppo.PPOLearner(old_obs.obs_size, env.num_actions,
                          tppo.PPOConfig(**_cfg()), device="cpu", seed=3)
    tt = ttransfer.TransferLearner(new, old, ttransfer.TransferLearnConfig(
        batch_size=8, epochs=2))
    before = [p.detach().clone() for p in new.policy.parameters()]
    logs = []
    m = tt.run(env, old_obs, 2, seed=1,
               log_fn=lambda i, mm: logs.append((i, mm)))
    assert [i for i, _ in logs] == [0, 1]
    assert 0 <= float(m["transfer_learn_accuracy"]) <= 1
    assert float(m["transfer_learn_loss"]) > 0
    assert not any(torch.equal(a, b) for a, b in zip(
        new.policy.parameters(), before))


# ---------------------------------------------------------------------------
# report, metrics, keypress, render

def test_report_display_matches_jax():
    from reinforcement_learning_torch.utils.report import Report
    from reinforcement_learning_tpu.utils.report import Report as JReport
    vals = {"b": 1234567.0, "a": 0.123456, "c": -250.25}
    t, j = Report(vals), JReport(vals)
    for r in (t, j):
        r.add_avg("d", 1.0)
        r.add_avg("d", 2.0)
    assert t.display() == j.display()
    assert t["d"] == 1.5 and "a" in t


def test_metric_sender_writes_json_lines(tmp_path):
    from reinforcement_learning_torch.utils.metrics import MetricSender
    path = tmp_path / "run" / "metrics.jsonl"
    s = MetricSender(fallback_path=str(path), use_wandb=False)
    s.send({"x": 1.5}, step=3)
    s.send({"y": 2.0}, step=4)
    s.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(d["step"], d.get("x"), d.get("y")) for d in lines] == [
        (3, 1.5, None), (4, None, 2.0)]
    assert s.run_id is None


def test_keypress_detector_is_inert_without_a_terminal():
    from reinforcement_learning_torch.utils.keypress import KeyPressDetector
    assert KeyPressDetector("qQ").pressed() is False


def test_render_datagram_matches_jax():
    from reinforcement_learning_torch.utils.render import (RenderSender,
                                                           arena_on_host)
    from reinforcement_learning_tpu.utils.render import \
        RenderSender as JRender
    from test_torch_state import random_phys_torch
    host = arena_on_host(random_phys_torch(5).arena, 2)
    teams = np.array([0, 0, 1, 1], np.int32)
    touched = np.array([True, False, False, True])
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(10)
    port_no = recv.getsockname()[1]
    try:
        for sender in (JRender(port=port_no, time_scale=1e6),
                       RenderSender(port=port_no, time_scale=1e6)):
            sender.send(host, teams, ball_touched=touched)
        want, got = recv.recv(65536), recv.recv(65536)
    finally:
        recv.close()
    assert got == want
    msg = json.loads(got)
    assert len(msg["cars"]) == 4 and len(msg["boost_pad_states"]) == 34


# ---------------------------------------------------------------------------
# checkpoints (the port's own; layout and stats keys as the JAX package's)

SMALL = dict(policy_layers=(16, 16), critic_layers=(16,),
             shared_head_layers=(16,), half_precision=False, batch_size=8,
             epochs=2, optim="adamw")


def _small_trainer(folder="", **cfg):
    """1v1 at 2 arenas on the plane arena, 2 ticks per env step, 16-wide
    MLPs with AdamW, 2 env steps per iteration."""
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=2, team_size=1, device="cpu", tick_skip=2, action_delay=1,
        arena=tstep.ArenaParams(num_cars=2, use_mesh=False,
                                dynamic_wheel_rays=False)))
    return ttrainer.Trainer(env, tppo.PPOConfig(**SMALL),
                            ttrainer.TrainerConfig(
                                ts_per_itr=8, random_seed=5,
                                checkpoint_folder=folder,
                                standardize_obs=True, **cfg))


def _everything(tr, state):
    """Every tensor a resumed run depends on, by name."""
    out = {f"state.{k}": v for k, v in flatten(state).items()}
    out.update({f"learner.{k}": v.numpy()
                for k, v in tr.learner.state_dict().items()})
    for name, opt in tr.learner.optimizers.items():
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                out[f"opt.{name}.{i}.{k}"] = np.asarray(v)
    out["gen.trainer"] = tr.generator.get_state().numpy()
    out["gen.env"] = tr.env.generator.get_state().numpy()
    out["host_rng"] = tr._host_rng.get_state()[1]
    return out


def test_checkpoint_resume_continues_bit_equal(tmp_path):
    """Two iterations straight, against one iteration, a save, a fresh
    trainer (and env) resuming through ``init_or_resume``, and one more
    iteration."""
    straight = _small_trainer()
    assert straight.steps_per_itr == 2
    s = straight.init(0)
    for _ in range(2):
        s, _ = straight.train_iteration(s)

    first = _small_trainer(str(tmp_path))
    s1 = first.init(0)
    s1, _ = first.train_iteration(s1)
    path = first.save(s1)
    assert os.path.basename(path) == str(s1.total_timesteps)
    saved = _everything(first, s1)

    resumed = _small_trainer(str(tmp_path))
    s2 = resumed.init_or_resume()
    got = _everything(resumed, s2)
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    s2, _ = resumed.train_iteration(s2)

    want, got = _everything(straight, s), _everything(resumed, s2)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert s2.iterations == 2 and s2.total_timesteps == 16


@dataclasses.dataclass
class _JaxStats:
    total_timesteps: object
    iterations: object
    return_stat: object


jax.tree_util.register_dataclass(
    _JaxStats, data_fields=["total_timesteps", "iterations", "return_stat"],
    meta_fields=[])


def test_checkpoint_retention_and_stats_keys(tmp_path):
    """``train`` saves every ``ts_per_save`` steps and at the end, keeping
    the newest ``checkpoints_to_keep``; RUNNING_STATS.json has the keys the
    JAX package's ``save_checkpoint`` writes."""
    tr = _small_trainer(str(tmp_path / "port"), ts_per_save=8,
                        checkpoints_to_keep=2)
    tr.steps_per_itr = 1
    state = tr.train(tr.init(0), 3)
    # saves at 8 (every 8 steps) and 12 (the end), 4 given way
    assert tckpt._numbered_dirs(str(tmp_path / "port")) == [8, 12]
    latest = tckpt.latest_checkpoint(str(tmp_path / "port"))
    with open(os.path.join(latest, "RUNNING_STATS.json")) as f:
        stats = json.load(f)
    assert stats["total_timesteps"] == state.total_timesteps == 12
    assert stats["iterations"] == 3

    jstate = _JaxStats(jnp.asarray(12, jnp.int32), jnp.asarray(3, jnp.int32),
                       jwelford.WelfordState.make(()))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate)
    with open(os.path.join(jpath, "RUNNING_STATS.json")) as f:
        jstats = json.load(f)

    def keys(d, prefix=""):
        return {prefix + k for k in d} | {
            x for k, v in d.items() if isinstance(v, dict)
            for x in keys(v, prefix + k + ".")}
    assert keys(stats) == keys(jstats)


def test_env_state_snapshot_round_trip(tmp_path):
    tr = _small_trainer()
    state, _ = tr.collect(tr.init(3), 1)
    p = str(tmp_path / "env_state.npz")
    tckpt.save_env_state(p, state.env_states)
    back = tckpt.load_env_state(p, tr.init(4).env_states)
    want, got = flatten(state.env_states), flatten(back)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the example twins

def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_2v2_param_counts_match_jax():
    """At scale 1.5 (one card, 512 games): shared 768x2, policy and critic
    768x3, LayerNorm, leaky ReLU; the same counts as the JAX learner."""
    from reinforcement_learning_torch.examples import train_2v2 as twin
    jmod = _jax_example("train_2v2")
    assert twin.scaled_sizes((512, 512), 1.5) == \
        jmod.scaled_sizes((512, 512), 1.5) == (768, 768)
    ppo = twin.ppo_config(1.5)
    jfields = {f.name for f in dataclasses.fields(jppo.PPOConfig)}
    assert {f.name for f in dataclasses.fields(tppo.PPOConfig)} == jfields
    jl = jppo.PPOLearner(167, 90, jppo.PPOConfig(**dataclasses.asdict(ppo)))
    tl = tppo.PPOLearner(167, 90, ppo, device="cpu")
    assert tl.param_counts() == jl.param_counts()
    assert tl.param_counts()["total"] == 4_345_435
    assert isinstance(tl.optimizers["policy"], torch.optim.Optimizer)


def test_train_2v2_twin_env_and_step_metrics():
    """The twin's env at 2 arenas on the CPU (full fidelity), one
    collected step through a trainer with the twin's ``step_metrics``
    and self-play config: every reward, user metric and update metric
    finite."""
    from reinforcement_learning_torch.examples import train_2v2 as twin
    env = twin.make_env(2, device="cpu")
    assert env.config.num_envs == 2 and env.obs_size == 167
    assert env.params.use_mesh and env.params.dynamic_wheel_rays
    small = dataclasses.replace(twin.ppo_config(0.03), batch_size=8)
    tr = ttrainer.Trainer(env, small, ttrainer.TrainerConfig(ts_per_itr=8),
                          step_metrics_fn=twin.step_metrics)
    state, traj = tr.collect(tr.init(0), 1)
    assert set(traj["user_metrics"]) == {
        "Player/In Air Ratio", "Player/Ball Touch Ratio",
        "Player/Demoed Ratio", "Player/Speed", "Player/Speed Towards Ball",
        "Player/Boost", "Player/Touch Height", "Game/Goal Speed"}
    _, metrics = tr.learn(state, traj)
    names = {f"reward/{w.name}" for w in env.reward_fns}
    assert names | set(traj["user_metrics"]) <= set(metrics)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    touch, w = traj["user_metrics"]["Player/Touch Height"]
    assert touch.shape == w.shape == (1, 2, 4)


def test_train_2v2_run_render_streams_arena_0():
    """``run_render`` with the twin's render env (one arena), one step,
    received on a local UDP socket."""
    from reinforcement_learning_torch.examples import train_2v2 as twin
    from reinforcement_learning_torch.utils import render
    env = twin.make_env(512, render_mode=True, device="cpu")
    assert env.config.num_envs == 1
    tr = ttrainer.Trainer(env, dataclasses.replace(twin.ppo_config(0.03),
                                                   batch_size=8),
                          ttrainer.TrainerConfig(ts_per_itr=4))
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(10)
    real = render.RenderSender
    port_no = recv.getsockname()[1]
    try:
        render.RenderSender = lambda **kw: real(port=port_no, **kw)
        twin.run_render(env, tr, time_scale=1e6, steps=1)
        msg = json.loads(recv.recv(65536))
    finally:
        render.RenderSender = real
        recv.close()
    assert len(msg["cars"]) == 4 and len(msg["boost_pad_states"]) == 34


def test_train_1v1_twin_env():
    from reinforcement_learning_torch.examples import train_1v1 as twin
    env = twin.make_env(2, device="cpu")
    state, obs, _ = env.reset(0)
    assert obs.shape == (2, 2, 109)
    _, out = env.step(state, torch.zeros(2, 2, dtype=torch.long))
    assert set(out.reward_components) == {w.name for w in env.reward_fns}
    assert bool(torch.isfinite(out.reward).all())
    tr = ttrainer.Trainer(env, twin.ppo_config(), twin.trainer_config())
    assert tr.steps_per_itr == 50_000 // 4
