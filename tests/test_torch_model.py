"""The port's MLP and PPO inference against the JAX package, with the JAX
parameters loaded through ``params_from_jax``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.models import mlp as tmlp
from reinforcement_learning_tpu.learn import ppo as jppo
from reinforcement_learning_tpu.models import mlp as jmlp

torch.set_num_threads(1)

OBS, ACTIONS, B = 167, 90, 64
WIDTH = 32
# bf16 keeps 8 bits of mantissa; the two frameworks round the matmul and
# bias add at different places, so bf16 outputs agree to a few bf16 ulps
BF16_ATOL = 5e-2


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _config(**kw):
    base = dict(policy_layers=(WIDTH, WIDTH), critic_layers=(WIDTH, WIDTH),
                shared_head_layers=(WIDTH,), half_precision=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def learners():
    jl = jppo.PPOLearner(OBS, ACTIONS, jppo.PPOConfig(**_config()))
    params = jl.init(jax.random.PRNGKey(0)).params
    tl = tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_config()),
                         device="cpu")
    tl.params_from_jax({"shared_head": _numpy_tree(params.shared_head),
                        "policy": _numpy_tree(params.policy),
                        "critic": _numpy_tree(params.critic)})
    return jl, params, tl


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.normal(0, 1, (B, OBS)).astype(np.float32)
    masks = rng.uniform(size=(B, ACTIONS)) > 0.3
    masks[:, 0] = True
    return obs, masks


def test_params_from_jax_copies_every_parameter(learners):
    jl, params, tl = learners
    assert tl.param_counts() == jl.param_counts()
    w = np.asarray(params.policy["layers"][1]["w"])
    np.testing.assert_array_equal(tl.policy.layers[1].weight.detach().numpy(),
                                  w.T)
    np.testing.assert_array_equal(tl.critic.out.bias.detach().numpy(),
                                  np.asarray(params.critic["out"]["b"]))


@pytest.mark.parametrize("layer_norm", [True, False])
def test_mlp_fp32_forward(layer_norm):
    cfg = dict(num_inputs=OBS, layer_sizes=(WIDTH, WIDTH), num_outputs=7,
               layer_norm=layer_norm)
    jp = jmlp.init_mlp(jax.random.PRNGKey(1), jmlp.MLPConfig(**cfg))
    m = tmlp.MLP(tmlp.MLPConfig(**cfg)).load_jax(_numpy_tree(jp))
    x = _inputs()[0]
    want = np.asarray(jmlp.apply_mlp(jp, jmlp.MLPConfig(**cfg),
                                     jnp.asarray(x)))
    got = m(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mlp_bf16_forward():
    cfg = dict(num_inputs=OBS, layer_sizes=(WIDTH, WIDTH), num_outputs=7)
    jp = jmlp.init_mlp(jax.random.PRNGKey(2), jmlp.MLPConfig(**cfg))
    m = tmlp.MLP(tmlp.MLPConfig(**cfg)).load_jax(_numpy_tree(jp))
    x = _inputs()[0]
    want = np.asarray(jmlp.apply_mlp(jp, jmlp.MLPConfig(**cfg),
                                     jnp.asarray(x), half_precision=True))
    got = m(torch.from_numpy(x), half_precision=True).detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)


def test_mlp_init_bounds():
    m = tmlp.MLP(tmlp.MLPConfig(num_inputs=100, layer_sizes=(50,),
                                num_outputs=3),
                 generator=torch.Generator().manual_seed(0))
    for lin in (m.layers[0], m.out):
        bound = 1.0 / np.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            assert float(p.abs().max()) <= bound
            assert float(p.abs().max()) > 0.8 * bound


def test_policy_probs_with_masks(learners):
    jl, params, tl = learners
    obs, masks = _inputs(3)
    want = np.asarray(jl.policy_probs(params, jnp.asarray(obs),
                                      jnp.asarray(masks)))
    got = tl.policy_probs(torch.from_numpy(obs),
                          torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[~masks] <= 1e-10)


def test_sample_actions_given_the_same_gumbel_noise(learners):
    jl, params, tl = learners
    obs, masks = _inputs(4)
    key = jax.random.PRNGKey(7)
    want_a, want_logp = jl.sample_actions(params, jnp.asarray(obs),
                                          jnp.asarray(masks), key)
    # jax.random.categorical is argmax(logits + gumbel(key, shape))
    noise = np.asarray(jax.random.gumbel(key, (B, ACTIONS)))
    got_a, got_logp = tl.sample_actions(torch.from_numpy(obs),
                                        torch.from_numpy(masks),
                                        gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp),
                               atol=1e-5)
    assert masks[np.arange(B), got_a.numpy()].all()


def test_sample_actions_deterministic_and_drawn(learners):
    jl, params, tl = learners
    obs, masks = _inputs(5)
    want_a, want_logp = jl.sample_actions(
        params, jnp.asarray(obs), jnp.asarray(masks), jax.random.PRNGKey(0),
        deterministic=True)
    got_a, got_logp = tl.sample_actions(torch.from_numpy(obs),
                                        torch.from_numpy(masks),
                                        deterministic=True)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp),
                               atol=1e-5)
    g = torch.Generator().manual_seed(0)
    drawn, _ = tl.sample_actions(torch.from_numpy(obs),
                                 torch.from_numpy(masks), generator=g)
    assert masks[np.arange(B), drawn.numpy()].all()


def test_values(learners):
    jl, params, tl = learners
    obs, _ = _inputs(6)
    want = np.asarray(jl.values(params, jnp.asarray(obs)))
    got = tl.values(torch.from_numpy(obs)).numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_param_count_at_bench_widths():
    cfg = tppo.PPOConfig(policy_layers=(384, 384, 384),
                         critic_layers=(384, 384, 384),
                         shared_head_layers=(384, 384), half_precision=True)
    counts = tppo.PPOLearner(OBS, ACTIONS, cfg, device="cpu").param_counts()
    assert counts["total"] == 1_140_571


def test_cuda_is_the_default_device():
    """Entry points run on the card unless asked otherwise, and never fall
    back to the CPU on their own."""
    from reinforcement_learning_torch.envs import env as tenv
    if torch.cuda.is_available():
        learner = tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_config()))
        assert learner.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tppo.PPOLearner(OBS, ACTIONS, tppo.PPOConfig(**_config()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.RocketLeagueEnv(tenv.EnvConfig(num_envs=1))
