"""Standalone policy inference for deployment (Util/InferUnit.{h,cpp}).

An ``InferUnit`` loads a trained policy (and its shared head) from a port
checkpoint or a converted ``.npz`` and infers actions for game states
outside the training loop, on the card unless the caller asks for the CPU.
The obs builder and action parser are the training plugins, so the obs
sizes agree (InferUnit.cpp:45-52).  Inference is fp32 with TF32 off;
deterministic actions are the masked argmax, stochastic ones a masked
softmax sample from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from reinforcement_learning_torch.device import resolve_device
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import AdvancedObs
from reinforcement_learning_torch.learn.ppo import (PPOConfig, PPOLearner,
                                                    _full_fp32_matmul,
                                                    params_tree)


class InferUnit:
    """Policy inference for deployment, its model on ``device`` (default
    ``"cuda"``).  ``params``: the JAX layout's ``PPOParams`` tree of numpy
    arrays (``PPOLearner.params_to_jax``); ``ppo_config`` gives the layer
    sizes and the activation, and inference runs fp32 whatever its
    ``half_precision``.  ``seed`` seeds the generator stochastic actions
    draw from when the caller hands in none."""

    def __init__(self, obs_builder, action_parser, params: dict,
                 ppo_config: PPOConfig, deterministic: bool = True,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.obs_builder = obs_builder
        self.action_parser = action_parser
        self.config = dataclasses.replace(ppo_config, half_precision=False)
        self.learner = PPOLearner(obs_builder.obs_size,
                                  action_parser.num_actions, self.config,
                                  device=self.device).params_from_jax(params)
        self.deterministic = deterministic
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_params(cls, params: dict, team_size: int,
                    ppo_config: PPOConfig | None = None,
                    deterministic: bool = True, device=None,
                    seed: int = 0) -> "InferUnit":
        """AdvancedObs for ``team_size`` x 2 players and DefaultAction;
        without ``ppo_config`` the layer sizes and LayerNorm come from the
        parameters and the activation is taken to be ReLU, as the JAX
        package does."""
        dev = resolve_device(device)
        teams = np.array([0] * team_size + [1] * team_size)
        obs_builder = AdvancedObs(2 * team_size, teams, device=dev)
        action_parser = DefaultAction(device=dev)
        cfg = ppo_config or _config_from_params(params)
        return cls(obs_builder, action_parser, params, cfg, deterministic,
                   dev, seed)

    @classmethod
    def from_checkpoint(cls, path: str, team_size: int,
                        ppo_config: PPOConfig | None = None,
                        deterministic: bool = True, device=None,
                        seed: int = 0) -> "InferUnit":
        """From a port checkpoint folder (``<folder>/<total_timesteps>``
        holding ``state.pt``, utils/checkpoint.py): its learner's
        parameters."""
        snap = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
        return cls.from_params(params_tree(snap["learner"]), team_size,
                               ppo_config, deterministic, device, seed)

    @classmethod
    def from_npz(cls, path: str, team_size: int,
                 ppo_config: PPOConfig | None = None,
                 deterministic: bool = True, device=None,
                 seed: int = 0) -> "InferUnit":
        """From a parameter ``.npz`` in the layout of
        ``checkpoint_converter.load_npz_params`` (how a JAX-trained model
        reaches the port)."""
        from reinforcement_learning_torch.tools.checkpoint_converter import \
            load_npz_params
        return cls.from_params(load_npz_params(path), team_size, ppo_config,
                               deterministic, device, seed)

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def logits(self, obs) -> torch.Tensor:
        """(B, obs_size) -> (B, num_actions) fp32 policy logits."""
        obs = self._tensor(obs, torch.float32)
        learner = self.learner
        with _full_fp32_matmul():
            feat = learner.shared_head(obs) if learner.has_shared else obs
            return learner.policy(feat)

    def infer_actions(self, obs, masks=None,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        """(B, obs_size) -> (B,) action indices on the unit's device
        (InferUnit.cpp:36-81).  ``masks`` (B, num_actions) bool, all legal
        when omitted; ``generator`` for stochastic actions (the unit's
        own when omitted)."""
        obs = self._tensor(obs, torch.float32)
        if masks is None:
            masks = torch.ones(obs.shape[0], self.action_parser.num_actions,
                               dtype=torch.bool, device=self.device)
        else:
            masks = self._tensor(masks, torch.bool)
        with _full_fp32_matmul():
            actions, _ = self.learner.sample_actions(
                obs, masks, generator=generator or self.generator,
                deterministic=self.deterministic)
        return actions

    def infer_controls(self, obs, masks=None,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
        """Action indices -> (B, 8) control rows."""
        return self.action_parser.parse(
            self.infer_actions(obs, masks, generator))


def _config_from_params(params: dict) -> PPOConfig:
    """Layer sizes and LayerNorm from a parameter tree (the reference's
    model_info_from_dict); the activation stays ReLU."""
    def sizes(tree):
        if tree is None:
            return ()
        return tuple(int(layer["b"].shape[0]) for layer in tree["layers"])

    return PPOConfig(
        policy_layers=sizes(params["policy"]),
        critic_layers=sizes(params["critic"]),
        shared_head_layers=sizes(params.get("shared_head")),
        layer_norm="ln_scale" in params["policy"]["layers"][0],
        half_precision=False)
