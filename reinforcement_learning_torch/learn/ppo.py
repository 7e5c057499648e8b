"""PPO learner, inference half: masked discrete policy and critic
(GigaLearnCPP/PPO/PPOLearner.cpp:78-184).

  * masked softmax with disabled logit -1e10, min prob 1e-11
  * sampling by the Gumbel-max trick, so a caller can hand in the noise
  * a shared head feeding a policy and a critic MLP

The update (GAE, clipped surrogate, Adam with the 0.5 global-norm clip) is
not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reinforcement_learning_torch.device import resolve_device
from reinforcement_learning_torch.models import mlp

ACTION_MIN_PROB = 1e-11
ACTION_DISABLED_LOGIT = -1e10


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPOLearnerConfig (PPO/PPOLearnerConfig.h), the fields inference
    reads; the update's fields come with the update."""
    deterministic: bool = False
    half_precision: bool = True

    policy_layers: tuple = (256, 256, 256)
    critic_layers: tuple = (256, 256, 256)
    shared_head_layers: tuple = (256,)   # () => no shared head
    layer_norm: bool = True

class PPOLearner(nn.Module):
    """The shared head, policy and critic on ``device`` (default
    ``"cuda"``)."""

    def __init__(self, obs_size: int, num_actions: int, config: PPOConfig,
                 device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.obs_size = obs_size
        self.num_actions = num_actions
        self.device = resolve_device(device)
        self.has_shared = len(config.shared_head_layers) > 0
        feat = (config.shared_head_layers[-1] if self.has_shared
                else obs_size)
        self.shared_cfg = mlp.MLPConfig(
            num_inputs=obs_size, layer_sizes=tuple(config.shared_head_layers),
            num_outputs=0, layer_norm=config.layer_norm) \
            if self.has_shared else None
        self.policy_cfg = mlp.MLPConfig(
            num_inputs=feat, layer_sizes=tuple(config.policy_layers),
            num_outputs=num_actions, layer_norm=config.layer_norm)
        self.critic_cfg = mlp.MLPConfig(
            num_inputs=feat, layer_sizes=tuple(config.critic_layers),
            num_outputs=1, layer_norm=config.layer_norm)
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.shared_head = (mlp.MLP(self.shared_cfg, g, self.device)
                            if self.has_shared else None)
        self.policy = mlp.MLP(self.policy_cfg, g, self.device)
        self.critic = mlp.MLP(self.critic_cfg, g, self.device)

    def init(self, seed: int = 0) -> "PPOLearner":
        """Draw fresh parameters from ``seed``."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for model in (self.shared_head, self.policy, self.critic):
            if model is not None:
                model.reset_parameters(g)
        return self

    def param_counts(self) -> dict:
        out = {"policy": mlp.param_count(self.policy),
               "critic": mlp.param_count(self.critic)}
        if self.has_shared:
            out["shared_head"] = mlp.param_count(self.shared_head)
        out["total"] = sum(out.values())
        return out

    @torch.no_grad()
    def params_from_jax(self, tree: dict) -> "PPOLearner":
        """Load the JAX package's ``PPOParams`` given as numpy arrays:
        ``{"shared_head": mlp tree or None, "policy": ..., "critic": ...}``
        with each mlp tree ``{"layers": [{"w", "b", "ln_scale",
        "ln_bias"}], "out": {"w", "b"}}`` and ``w`` as (fan_in, fan_out)."""
        if (tree.get("shared_head") is None) == self.has_shared:
            raise ValueError("shared head present in one model only")
        if self.has_shared:
            self.shared_head.load_jax(tree["shared_head"])
        self.policy.load_jax(tree["policy"])
        self.critic.load_jax(tree["critic"])
        return self

    # --- inference --------------------------------------------------------

    def _features(self, obs):
        if self.has_shared:
            return self.shared_head(obs, self.config.half_precision)
        return obs

    @torch.no_grad()
    def policy_probs(self, obs, action_masks):
        """Masked softmax action probabilities (PPOLearner.cpp:78-114)."""
        logits = self.policy(self._features(obs), self.config.half_precision)
        logits = logits + ACTION_DISABLED_LOGIT * (~action_masks).float()
        probs = torch.softmax(logits, dim=-1)
        return torch.clamp(probs, ACTION_MIN_PROB, 1.0)

    @torch.no_grad()
    def sample_actions(self, obs, action_masks, generator=None, gumbel=None,
                       deterministic=False):
        """Returns (actions int64, log_probs) (PPOLearner.cpp:116-184).
        Sampling is ``argmax(log p + g)`` with Gumbel noise ``g``: given as
        ``gumbel`` (same shape as the probabilities), or drawn from
        ``generator``."""
        probs = self.policy_probs(obs, action_masks)
        logp_all = torch.log(probs)
        if deterministic:
            actions = torch.argmax(probs, dim=-1)
        else:
            if gumbel is None:
                e = torch.empty_like(logp_all).exponential_(
                    generator=generator)
                gumbel = -torch.log(e)
            actions = torch.argmax(logp_all + gumbel, dim=-1)
        logp = torch.gather(logp_all, -1, actions[..., None])[..., 0]
        return actions, logp

    @torch.no_grad()
    def values(self, obs):
        return self.critic(self._features(obs),
                           self.config.half_precision)[..., 0]
