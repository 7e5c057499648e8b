"""The port's learning half against the JAX package on the CPU: the Welford
statistics, GAE, the PPO loss and its grads, the PPO update with Adam and
MagSGD, and the learning half of a training iteration as a whole; then a
smoke run of the port's ``Trainer.train_iteration`` and ``train``.

Inputs are made by numpy from fixed seeds; the JAX parameters go into the
port through ``params_from_jax``, and the JAX minibatch permutations are
handed to the port's ``update``.

Tolerances: GAE and the Welford merge are the same elementwise float32
operations in the same order, so they agree to the last bits (1e-6 allows
for XLA's and torch's summation order in the means); the losses and
grads go through matrix products that XLA:CPU and torch sum in other
orders (rtol 1e-4, atol 1e-6 on values of order 1e-3..1); after four
Adam steps the parameters agree to 1e-6 (each step moves a weight by
about lr = 1e-3 and Adam's m/(sqrt(v)+eps) rounds in another order in
optax and torch.optim.Adam), the moments to rtol 1e-3 (they carry the
grads' own differences).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.learn import gae as tgae
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_torch.learn import welford as twelford
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_tpu.learn import gae as jgae
from reinforcement_learning_tpu.learn import ppo as jppo
from reinforcement_learning_tpu.learn import trainer as jtrainer
from reinforcement_learning_tpu.learn import welford as jwelford

torch.set_num_threads(1)

EXACT = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAMS = dict(rtol=0, atol=1e-6)
MOMENTS = dict(rtol=1e-3, atol=1e-9)


# ---------------------------------------------------------------------------
# Welford

@pytest.mark.parametrize("shape", [(), (5,)])
def test_welford_merge_matches_jax(shape):
    rng = np.random.RandomState(0)
    js, ts = jwelford.WelfordState.make(shape), \
        twelford.WelfordState.make(shape, "cpu")
    for n in (1, 7, 40):                      # count 1 keeps variance 1
        x = rng.normal(3.0, 2.0, (n,) + shape).astype(np.float32)
        js = jwelford.update_batch(js, jnp.asarray(x))
        ts = twelford.update_batch(ts, torch.from_numpy(x))
        for name in ("count", "mean", "m2", "variance", "std"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       **EXACT, err_msg=f"{name} n={n}")
    obs = rng.normal(0, 10, (6,) + shape).astype(np.float32)
    np.testing.assert_allclose(
        twelford.standardize_obs(ts, torch.from_numpy(obs), 0.1, 3.0),
        np.asarray(jwelford.standardize_obs(js, jnp.asarray(obs), 0.1, 3.0)),
        **EXACT)


# ---------------------------------------------------------------------------
# GAE

def _gae_inputs(seed=1, T=12, B=6):
    rng = np.random.RandomState(seed)
    rew = (rng.normal(0, 3, (T, B)) * (rng.uniform(size=(T, B)) > 0.3)
           ).astype(np.float32)
    rew[2, 0] = 900.0                          # clipped at 200 when scaled
    rew[5, 1] = -700.0
    term = np.zeros((T, B), np.int32)
    term[3, :3] = 1                            # NORMAL
    term[7, 2:] = 2                            # TRUNCATED
    term[-1, 0] = 1
    term[-1, 1] = 2
    vals = rng.normal(0, 1, (T, B)).astype(np.float32)
    nvals = rng.normal(0, 1, (T, B)).astype(np.float32)
    return rew, term, vals, nvals


@pytest.mark.parametrize("return_std,clip", [(None, 200.0), (1.0, 200.0),
                                             (0.0, 200.0), (2.5, 200.0),
                                             (2.5, 0.0)])
def test_gae_matches_jax(return_std, clip):
    """NORMAL and TRUNCATED terminals; a return std of 1 and 0 (no
    scaling), a real one with and without the reward clip."""
    rew, term, vals, nvals = _gae_inputs()
    rs = None if return_std is None else np.float32(return_std)
    want = jgae.compute_gae(jnp.asarray(rew), jnp.asarray(term),
                            jnp.asarray(vals), jnp.asarray(nvals), 0.99,
                            0.95, None if rs is None else jnp.asarray(rs),
                            clip)
    got = tgae.compute_gae(torch.from_numpy(rew), torch.from_numpy(term),
                           torch.from_numpy(vals), torch.from_numpy(nvals),
                           0.99, 0.95,
                           None if rs is None else torch.tensor(rs), clip)
    for g, w, name in zip(got, want, ("adv", "target", "returns", "clip")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT,
                                   err_msg=name)
    if return_std == 2.5 and clip:
        assert float(got[3]) > 0             # the clip took effect


# ---------------------------------------------------------------------------
# PPO loss, grads and update

OBS, ACTIONS, WIDTH = 12, 9, 24


def _cfg(**kw):
    base = dict(policy_layers=(WIDTH, WIDTH), critic_layers=(WIDTH, WIDTH),
                shared_head_layers=(WIDTH,), half_precision=False,
                batch_size=32, epochs=2, policy_lr=1e-3, critic_lr=2e-3)
    base.update(kw)
    return base


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _learners(seed=0, **kw):
    jl = jppo.PPOLearner(OBS, ACTIONS, jppo.PPOConfig(**_cfg(**kw)))
    jstate = jl.init(jax.random.PRNGKey(seed))
    tl = tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_cfg(**kw)),
                         device="cpu")
    p = jstate.params
    tl.params_from_jax({"shared_head": _np_tree(p.shared_head),
                        "policy": _np_tree(p.policy),
                        "critic": _np_tree(p.critic)})
    return jl, jstate, tl


def _batch(n, seed=2, weight=False):
    rng = np.random.RandomState(seed)
    mask = rng.uniform(size=(n, ACTIONS)) > 0.35
    mask[:, 3] = True
    action = np.array([rng.choice(np.flatnonzero(m)) for m in mask],
                      np.int32)
    b = dict(obs=rng.normal(0, 1, (n, OBS)).astype(np.float32), mask=mask,
             action=action,
             old_logp=(np.log(1.0 / ACTIONS) + rng.normal(0, 0.4, n)
                       ).astype(np.float32),
             advantage=rng.normal(0, 1, n).astype(np.float32),
             target_value=rng.normal(0, 1, n).astype(np.float32))
    if weight:
        b["weight"] = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return b


def _port_tree(model, get):
    """The port MLP's parameters (through ``get(param)``) in the JAX
    layout."""
    layers = []
    for i, lin in enumerate(model.layers):
        d = {"w": get(lin.weight).T, "b": get(lin.bias)}
        if model.norms is not None:
            d["ln_scale"] = get(model.norms[i].weight)
            d["ln_bias"] = get(model.norms[i].bias)
        layers.append(d)
    out = {"layers": layers}
    if model.out is not None:
        out["out"] = {"w": get(model.out.weight).T, "b": get(model.out.bias)}
    return out


def _assert_trees(got, want, tol, what):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(np.asarray(g), np.asarray(flat_w[path]),
                                   **tol, err_msg=f"{what} {path}")


MODELS = ("shared_head", "policy", "critic")


@pytest.mark.parametrize("weight,mask_entropy", [(False, False),
                                                 (True, True)])
def test_loss_and_grads_match_jax(weight, mask_entropy):
    """One minibatch, masks with disabled actions, with and without the
    per-row ``weight``: the loss, its metrics and every grad."""
    jl, jstate, tl = _learners(mask_entropy=mask_entropy)
    b = _batch(40, weight=weight)
    (jtotal, jaux), jgrads = jax.value_and_grad(jl._loss, has_aux=True)(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    total, aux = tl.loss(tb)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               **GRAD)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **GRAD,
                                   err_msg=k)
    for name in MODELS:
        _assert_trees(_port_tree(getattr(tl, name),
                                 lambda p: p.grad.numpy()),
                      getattr(jgrads, name), GRAD, f"grad {name}")


def _jax_moments(opt_state):
    """(mu, nu) of the Adam state inside optax's chain(clip, adam)."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu, leaf.nu
    raise AssertionError("no Adam state")


def _jax_perms(key, epochs, total):
    return np.stack([np.asarray(jax.random.permutation(k, total))
                     for k in jax.random.split(key, epochs)])


@pytest.mark.parametrize("optim", ["adam", "magsgd"])
def test_update_matches_jax(optim):
    """Two epochs x two minibatches (75 rows, batch size 32: 2 batches of
    37, one row left out) with the JAX permutations: the parameters, the
    Adam moments and the averaged metrics."""
    jl, jstate, tl = _learners(optim=optim)
    data = _batch(75, seed=4)
    key = jax.random.PRNGKey(9)
    jnew, jmetrics = jl.update(jstate, {k: jnp.asarray(v)
                                        for k, v in data.items()}, key)
    perms = torch.from_numpy(_jax_perms(key, 2, 75))
    metrics = tl.update({k: torch.from_numpy(v) for k, v in data.items()},
                        perms=perms)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **GRAD, err_msg=k)
    for name in MODELS:
        model = getattr(tl, name)
        _assert_trees(_port_tree(model, lambda p: p.detach().numpy()),
                      getattr(jnew.params, name), PARAMS, f"param {name}")
        if optim != "adam":
            continue
        st = tl.optimizers[name].state
        mu, nu = _jax_moments(getattr(jnew, {
            "shared_head": "opt_state_shared", "policy": "opt_state_policy",
            "critic": "opt_state_critic"}[name]))
        for slot, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
            _assert_trees(_port_tree(model, lambda p: st[p][slot].numpy()),
                          want, MOMENTS, f"{slot} {name}")
        assert all(float(st[p]["step"]) == 4 for p in model.parameters())


def test_update_draws_its_own_permutations():
    """Without ``perms`` the update shuffles from its generator: the same
    seed gives the same parameters, another seed other ones."""
    outs = []
    for seed in (3, 3, 4):
        _, _, tl = _learners()
        data = {k: torch.from_numpy(v) for k, v in _batch(75).items()}
        tl.update(data, generator=torch.Generator().manual_seed(seed))
        outs.append(torch.cat([p.detach().reshape(-1)
                               for p in tl.parameters()]))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("optim", ["adamw", "adagrad", "rmsprop"])
def test_unported_optimizers_raise(optim):
    """These raised until they were ported in optax's form (their steps
    are held against optax in tests/test_torch_services.py): each model
    now gets its own, and a name outside the JAX package's set raises."""
    from reinforcement_learning_torch.learn.optim import OPTIMIZERS
    tl = tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_cfg(optim=optim)),
                         device="cpu")
    assert set(tl.optimizers) == set(MODELS)
    assert all(type(o) is OPTIMIZERS[optim] for o in tl.optimizers.values())
    with pytest.raises(ValueError):
        tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_cfg(
            optim=optim + "_")), device="cpu")


# ---------------------------------------------------------------------------
# The learning half of an iteration, and the trainer

T, N, TEAM = 3, 2, 2
P = 2 * TEAM
SMALL = dict(policy_layers=(16, 16), critic_layers=(16, 16),
             shared_head_layers=(16,), half_precision=False,
             batch_size=10, epochs=2)


def _plane():
    return tstep.ArenaParams(num_cars=P, use_mesh=False,
                             dynamic_wheel_rays=False)


def _trainer(ts_per_itr=T * N * P, **cfg):
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=N, team_size=TEAM, arena=_plane(), device="cpu"))
    return ttrainer.Trainer(env, tppo.PPOConfig(**{**SMALL, **cfg}),
                            ttrainer.TrainerConfig(ts_per_itr=ts_per_itr,
                                                   random_seed=1))


def _trajectory(obs_size, num_actions, seed=7):
    rng = np.random.RandomState(seed)
    mask = rng.uniform(size=(T, N, P, num_actions)) > 0.2
    mask[..., 0] = True
    action = np.zeros((T, N, P), np.int64)
    for idx in np.ndindex(T, N, P):
        action[idx] = rng.choice(np.flatnonzero(mask[idx]))
    terminal = np.zeros((T, N), np.int32)
    terminal[1, 0] = 1
    terminal[2, 1] = 2
    f = np.float32
    return dict(
        obs=rng.normal(0, 1, (T, N, P, obs_size)).astype(f), mask=mask,
        action=action,
        old_logp=(np.log(1.0 / num_actions) + rng.normal(0, 0.3, (T, N, P))
                  ).astype(f),
        reward=rng.normal(0, 2, (T, N, P)).astype(f), terminal=terminal,
        final_obs=rng.normal(0, 1, (T, N, P, obs_size)).astype(f),
        goal=terminal == 1, touch=rng.uniform(size=(T, N, P)) > 0.7,
        reward_components={"touch": rng.uniform(size=T).astype(f),
                           "goal": rng.uniform(size=T).astype(f)})


def _jax_metric_keys(ppo_keys, component_names):
    """The keys ``Trainer._train_iteration_impl`` of the JAX package
    returns (trainer.py:239-261): the update's metrics, the named keys it
    sets, and one ``reward/<name>`` per reward component."""
    import inspect
    src = inspect.getsource(jtrainer.Trainer._train_iteration_impl)
    named = set(re.findall(r'metrics\["(\w+)"\]', src))
    assert 'metrics[f"reward/{name}"]' in src
    return set(ppo_keys) | named | {f"reward/{n}" for n in component_names}


def test_learning_half_matches_jax():
    """The port's ``Trainer.learn`` against the JAX functions called in
    ``_train_iteration_impl``'s order (fp32 values of obs and final obs,
    GAE over (T, N*P) with each arena's terminal per player, the Welford
    update, the PPO update) on one numpy-made trajectory, from a return
    statistic whose std is neither 0 nor 1."""
    tr = _trainer()
    env = tr.env
    traj = _trajectory(env.obs_size, env.num_actions)
    jl = jppo.PPOLearner(env.obs_size, env.num_actions,
                         jppo.PPOConfig(**SMALL))
    jstate = jl.init(jax.random.PRNGKey(3))
    p = jstate.params
    tr.learner.params_from_jax({"shared_head": _np_tree(p.shared_head),
                                "policy": _np_tree(p.policy),
                                "critic": _np_tree(p.critic)})
    rs = jwelford.WelfordState(count=jnp.float32(50.0),
                               mean=jnp.float32(0.3), m2=jnp.float32(400.0))

    # the JAX package, trainer.py:195-236
    flat = lambda x: jnp.asarray(x).reshape((T * N * P,) + x.shape[3:])  # noqa
    v_obs = jl.values(p, flat(traj["obs"]), half=False)
    v_final = jl.values(p, flat(traj["final_obs"]), half=False)
    term_tb = jnp.repeat(jnp.asarray(traj["terminal"]), P,
                         axis=-1).reshape(T, N * P)
    advs, targets, returns, clip_portion = jgae.compute_gae(
        jnp.asarray(traj["reward"]).reshape(T, N * P), term_tb,
        v_obs.reshape(T, N * P), v_final.reshape(T, N * P), 0.99, 0.95,
        rs.std, 200.0)
    rs_new = jwelford.update_batch(rs, returns.reshape(-1))
    data = dict(obs=flat(traj["obs"]), mask=flat(traj["mask"]),
                action=flat(traj["action"]).astype(jnp.int32),
                old_logp=flat(traj["old_logp"]), advantage=advs.reshape(-1),
                target_value=targets.reshape(-1))
    key = jax.random.PRNGKey(11)
    jnew, jm = jl.update(jstate, data, key)
    want = dict(jm, reward_mean=np.mean(traj["reward"]),
                goal_rate=np.mean(traj["goal"]),
                touch_rate=np.mean(traj["touch"]),
                episode_terminals=np.sum(traj["terminal"] > 0),
                return_std=rs_new.std, reward_clip_portion=clip_portion,
                value_mean=jnp.mean(v_obs),
                **{f"reward/{k}": np.mean(v)
                   for k, v in traj["reward_components"].items()})

    state = tr.init(0)
    state.return_stat = twelford.WelfordState(
        count=torch.tensor(50.0), mean=torch.tensor(0.3),
        m2=torch.tensor(400.0))
    ttraj = {k: (torch.from_numpy(v) if k != "reward_components" else
                 {n: torch.from_numpy(c) for n, c in v.items()})
             for k, v in traj.items()}
    perms = torch.from_numpy(_jax_perms(key, 2, T * N * P))
    state, metrics = tr.learn(state, ttraj, perms=perms)

    assert set(metrics) == set(want) == _jax_metric_keys(
        jm, traj["reward_components"])
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(w), **GRAD,
                                   err_msg=k)
    for name in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(state.return_stat, name).numpy(),
                                   np.asarray(getattr(rs_new, name)),
                                   **EXACT, err_msg=name)
    assert state.iterations == 1 and state.total_timesteps == T * N * P
    for name in MODELS:
        _assert_trees(_port_tree(getattr(tr.learner, name),
                                 lambda q: q.detach().numpy()),
                      getattr(jnew.params, name), PARAMS, f"param {name}")


@pytest.fixture(scope="module")
def trained():
    """Two iterations of ``Trainer.train`` on the CPU: 2 arenas of 2v2 on
    the plane arena, 16-wide MLPs, one env step each, standardised
    observations."""
    env = _trainer().env
    tr = ttrainer.Trainer(env, tppo.PPOConfig(**SMALL),
                          ttrainer.TrainerConfig(ts_per_itr=N * P,
                                                 random_seed=1,
                                                 standardize_obs=True))
    state = tr.init(0)
    before = [q.detach().clone() for q in tr.learner.parameters()]
    logs = []
    state = tr.train(state, 2, log_fn=lambda i, m: logs.append((i, m)))
    return tr, state, before, logs


def test_train_iteration_runs_on_the_cpu(trained):
    tr, state, before, logs = trained
    assert [i for i, _ in logs] == [1, 2]
    assert state.iterations == 2
    assert state.total_timesteps == 2 * tr.steps_per_itr * N * P
    m = logs[-1][1]
    keys = _jax_metric_keys(tppo.UPDATE_METRICS,
                            [wr.name for wr in tr.env.reward_fns])
    assert set(m) == keys | {"steps_per_second", "iteration_time"}
    assert all(np.isfinite(v) for v in m.values())
    assert float(state.obs_stat.count) == 2 * tr.steps_per_itr * N * P
    after = list(tr.learner.parameters())
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_trainer_raises_for_what_is_not_ported(trained):
    """Self-play and checkpoints are ported now (tests/test_torch_selfplay
    .py, tests/test_torch_services.py), and hoops runs on the portable
    physics route.  What still raises, as in the JAX package: a guiding
    policy without a guiding strength, and hoops asked of the kernel
    route ("auto" takes the portable route)."""
    tr = trained[0]
    with pytest.raises(ValueError):
        ttrainer.Trainer(tr.env, tr.ppo_config, guiding_params=tr.learner)
    with pytest.raises(ValueError):
        tenv.RocketLeagueEnv(tenv.EnvConfig(num_envs=1, game_mode="hoops",
                                            device="cpu",
                                            physics_backend="kernel"))
    assert tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=1, game_mode="hoops", device="cpu")).portable
