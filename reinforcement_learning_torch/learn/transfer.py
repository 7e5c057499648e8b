"""Transfer learning: distil an old policy into a new network
(Learner::StartTransferLearn, Learner.cpp:299-480;
PPOLearner::TransferLearn, PPOLearner.cpp:583-637;
TransferLearnConfig.h).

The envs step with the NEW policy while observations are built through
BOTH obs builders from the same states; the new policy's masked action
distribution is then pulled toward the frozen old policy's (an L1 or
|KL|^exponent loss, scaled), with an optional action-index map when the
action spaces differ.  The new policy and shared head train with their own
Adam after one 0.5 global-norm clip over both, as optax's
``chain(clip_by_global_norm(0.5), adam(lr))`` in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from reinforcement_learning_torch.learn.ppo import (MAX_GRAD_NORM,
                                                    PPOLearner)


@dataclasses.dataclass(frozen=True)
class TransferLearnConfig:
    """TransferLearnConfig.h:14-52."""
    lr: float = 3e-4
    batch_size: int = 50_000
    epochs: int = 5
    use_kl_div: bool = False
    loss_scale: float = 500.0
    loss_exponent: float = 1.0


class TransferLearner:
    """Distillation steps over collected (new obs, old obs) pairs.

    ``learner`` is trained in place; ``old_learner`` is the frozen teacher
    (its obs size and action count may differ).  ``action_map``: an
    optional (new actions,) index map from the new action indices into
    the old policy's action space (PPOLearner.cpp:598-599)."""

    def __init__(self, learner: PPOLearner, old_learner: PPOLearner,
                 config: TransferLearnConfig = TransferLearnConfig()):
        self.learner = learner
        self.old_learner = old_learner
        self.config = config
        self.params = list(learner.policy.parameters())
        if learner.has_shared:
            self.params += list(learner.shared_head.parameters())
        self.optimizer = torch.optim.Adam(self.params, lr=config.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def _distill_loss(self, old_probs, new_obs, new_masks):
        cfg = self.config
        learner = self.learner
        new_probs = learner._masked_probs(learner._logits(
            learner._features(new_obs, half=False), False), new_masks)
        if cfg.use_kl_div:
            loss = torch.abs(old_probs * torch.log(old_probs / new_probs))
        else:
            loss = torch.abs(old_probs - new_probs)
        loss = torch.mean(loss ** cfg.loss_exponent) * cfg.loss_scale
        acc = torch.mean((torch.argmax(new_probs, -1)
                          == torch.argmax(old_probs, -1)).to(torch.float32))
        return loss, acc

    def update(self, new_obs, old_obs, new_masks, old_masks,
               action_map=None) -> dict:
        """``epochs`` distillation steps on one batch; returns the first
        epoch's loss and accuracy."""
        old_probs = self.old_learner.policy_probs(old_obs, old_masks,
                                                  half=False)
        if action_map is not None:
            old_probs = old_probs[..., action_map]
        metrics = {}
        for epoch in range(self.config.epochs):
            self.optimizer.zero_grad()
            loss, acc = self._distill_loss(old_probs, new_obs, new_masks)
            loss.backward()
            with torch.no_grad():
                grads = [p.grad for p in self.params]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < MAX_GRAD_NORM
                for g in grads:
                    g.copy_(torch.where(keep, g,
                                        (g / norm) * MAX_GRAD_NORM))
            self.optimizer.step()
            if epoch == 0:
                metrics["transfer_learn_loss"] = loss.detach()
                metrics["transfer_learn_accuracy"] = acc
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _collect(self, env, states, obs, masks, steps, old_obs_builder,
                 old_action_parser, generator):
        new_obs, new_masks, old_obs, old_masks = [], [], [], []
        for _ in range(steps):
            N, P, D = obs.shape
            actions, _ = self.learner.sample_actions(
                obs.reshape(N * P, D), masks.reshape(N * P, -1),
                generator=generator)
            arena = states.phys.arena
            new_obs.append(obs)
            new_masks.append(masks)
            old_obs.append(old_obs_builder.build(
                arena.cars, arena.ball, arena.pads, states.prev_actions))
            old_masks.append(old_action_parser.action_mask(arena.cars)
                             if old_action_parser is not None else masks)
            states, out = env.step(states, actions.reshape(N, P))
            obs, masks = out.obs, out.action_mask

        def flat(xs):
            x = torch.stack(xs)
            return x.reshape((-1,) + tuple(x.shape[3:]))
        batch = tuple(flat(x) for x in (new_obs, old_obs, new_masks,
                                        old_masks))
        return states, obs, masks, batch

    def run(self, env, old_obs_builder, iterations: int, seed: int = 0,
            old_action_parser=None, action_map=None, log_fn=None) -> dict:
        """StartTransferLearn (Learner.cpp:299-480): step the envs with
        the new policy while building the teacher's observations through
        ``old_obs_builder`` from the same states, then distil each
        collected batch of ``batch_size`` player-steps.
        ``old_action_parser`` gives the teacher's action masks (default:
        the env's).  Returns the last metrics."""
        n_players = env.config.num_envs * env.config.cars_per_arena
        steps = max(self.config.batch_size // n_players, 1)
        generator = torch.Generator(device=env.device).manual_seed(seed)
        states, obs, masks = env.reset(seed)
        metrics = {}
        for it in range(iterations):
            states, obs, masks, batch = self._collect(
                env, states, obs, masks, steps, old_obs_builder,
                old_action_parser, generator)
            new_obs, old_obs, new_masks, old_masks = batch
            metrics = self.update(new_obs, old_obs, new_masks, old_masks,
                                  action_map)
            if log_fn is not None:
                log_fn(it, {k: float(v) for k, v in metrics.items()})
        return metrics
