"""PPO learner: masked discrete policy and critic, and the clipped PPO
update (GigaLearnCPP/PPO/PPOLearner.cpp).

  * masked softmax with disabled logit -1e10, min prob 1e-11 (:78-114)
  * sampling by the Gumbel-max trick, so a caller can hand in the noise
  * a shared head feeding a policy and a critic MLP
  * entropy normalised by log(num actions), or log(valid actions) with
    ``mask_entropy`` (:253-276)
  * a policy temperature dividing the logits (:78-114)
  * clipped surrogate, normalised entropy bonus, MSE critic loss, an
    optional L1 pull toward a frozen guiding policy (:458-468), and per
    model a global-norm clip of 0.5 before Adam, AdamW, Adagrad, RMSprop
    (optax's formulas, ``learn/optim.py``) or MagSGD (:278-581)
  * advantages normalised per minibatch (:363-370); KL, clip fraction and
    ratio averaged over the update (:481-490)

Data-parallel (``parallel/mesh.py``): a rank holds its arenas' rows; the
permutation is drawn over the global rows and each rank trains on its
rows of each minibatch.  Every mean is a local sum over the minibatch's
global count (or weight sum), so the all-reduced gradient, norm and
metrics are the unsharded ones.

Inference may run in bf16 (``half_precision``); the update runs fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from reinforcement_learning_torch.device import resolve_device
from reinforcement_learning_torch.envs.shard import EnvShard
from reinforcement_learning_torch.learn.optim import OPTIMIZERS
from reinforcement_learning_torch.models import mlp
from reinforcement_learning_torch.utils import tracing

ACTION_MIN_PROB = 1e-11
ACTION_DISABLED_LOGIT = -1e10


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPOLearnerConfig (PPO/PPOLearnerConfig.h).  ``ts_per_itr``,
    ``mini_batch_size``, ``overbatching`` and ``max_episode_duration`` are
    accepted and unused, as in the JAX package: the update splits rows by
    ``batch_size`` only."""
    ts_per_itr: int = 50_000
    batch_size: int = 50_000
    mini_batch_size: int = 0       # 0 => batch_size
    overbatching: bool = True
    max_episode_duration: float = 120.0
    deterministic: bool = False
    half_precision: bool = True

    policy_layers: tuple = (256, 256, 256)
    critic_layers: tuple = (256, 256, 256)
    shared_head_layers: tuple = (256,)   # () => no shared head
    activation: str = "relu"   # relu | leaky_relu | sigmoid | tanh
    layer_norm: bool = True
    optim: str = "adam"   # adam | adamw | adagrad | rmsprop | magsgd

    epochs: int = 2
    policy_lr: float = 3e-4
    critic_lr: float = 3e-4
    entropy_scale: float = 0.018
    mask_entropy: bool = False
    clip_range: float = 0.2
    policy_temperature: float = 1.0
    gae_lambda: float = 0.95
    gae_gamma: float = 0.99
    reward_clip_range: float = 200.0
    guiding_strength: float = 0.0  # > 0 enables the guiding policy loss


MAX_GRAD_NORM = 0.5
UPDATE_METRICS = ("entropy", "policy_loss", "critic_loss", "kl",
                  "clip_fraction", "ratio", "guiding_loss")


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 matrix products in full precision (no TF32) on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
            num_outputs=0, activation=config.activation,
            layer_norm=config.layer_norm) \
            if self.has_shared else None
        self.policy_cfg = mlp.MLPConfig(
            num_inputs=feat, layer_sizes=tuple(config.policy_layers),
            num_outputs=num_actions, activation=config.activation,
            layer_norm=config.layer_norm)
        self.critic_cfg = mlp.MLPConfig(
            num_inputs=feat, layer_sizes=tuple(config.critic_layers),
            num_outputs=1, activation=config.activation,
            layer_norm=config.layer_norm)
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.shared_head = (mlp.MLP(self.shared_cfg, g, self.device)
                            if self.has_shared else None)
        self.policy = mlp.MLP(self.policy_cfg, g, self.device)
        self.critic = mlp.MLP(self.critic_cfg, g, self.device)
        self._reset_optimizers()

    def init(self, seed: int = 0) -> "PPOLearner":
        """Draw fresh parameters from ``seed`` and clear the optimiser
        states."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for model in (self.shared_head, self.policy, self.critic):
            if model is not None:
                model.reset_parameters(g)
        self._reset_optimizers()
        return self

    def _models(self) -> dict:
        """name -> (model, learning rate): policy, critic, shared head."""
        cfg = self.config
        out = {"policy": (self.policy, cfg.policy_lr),
               "critic": (self.critic, cfg.critic_lr)}
        if self.has_shared:
            out["shared_head"] = (self.shared_head, cfg.policy_lr)
        return out

    def _reset_optimizers(self):
        """One optimiser per model (``_make_optim`` of the JAX package):
        Adam (b1 0.9, b2 0.999, eps 1e-8, as optax's), AdamW, Adagrad or
        RMSprop in optax's form (``learn/optim.py``), or MagSGD."""
        optim = self.config.optim
        if optim not in ("adam", "magsgd", *OPTIMIZERS):
            raise ValueError(optim)

        def make(model, lr):
            if optim == "adam":
                return torch.optim.Adam(model.parameters(), lr=lr,
                                        betas=(0.9, 0.999), eps=1e-8)
            if optim == "magsgd":
                return None
            return OPTIMIZERS[optim](model.parameters(), lr=lr)
        self.optimizers = {name: make(model, lr)
                           for name, (model, lr) in self._models().items()}

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

    def params_to_jax(self) -> dict:
        """The inverse of ``params_from_jax``: this learner's parameters as
        the JAX package's ``PPOParams`` tree of float32 numpy arrays."""
        return params_tree(self.state_dict())

    # --- inference --------------------------------------------------------

    def _half(self, half):
        return self.config.half_precision if half is None else half

    def _apply(self, name, x, half, params=None):
        """Model ``name`` on ``x``; ``params[name]`` (a dict of its
        parameters by ``named_parameters`` name) stands in for its own."""
        model = getattr(self, name)
        if params is None:
            return model(x, half)
        return torch.func.functional_call(model, params[name], (x, half))

    def _features(self, obs, half=None, params=None):
        if self.has_shared:
            return self._apply("shared_head", obs, self._half(half), params)
        return obs

    def _logits(self, feat, half, params=None):
        """The policy's logits on the features, over the temperature."""
        logits = self._apply("policy", feat, half, params)
        if self.config.policy_temperature != 1.0:
            logits = logits / self.config.policy_temperature
        return logits

    def _masked_probs(self, logits, action_masks):
        logits = logits + ACTION_DISABLED_LOGIT * (~action_masks).float()
        return torch.clamp(torch.softmax(logits, dim=-1), ACTION_MIN_PROB,
                           1.0)

    @torch.no_grad()
    def policy_probs(self, obs, action_masks, half=None, params=None):
        """Masked softmax action probabilities (PPOLearner.cpp:78-114).
        ``params``: another version's ``{"policy": ..., "shared_head":
        ...}`` parameters (``VersionBank.get_version``) in place of this
        learner's."""
        half = self._half(half)
        feat = self._features(obs, half, params)
        return self._masked_probs(self._logits(feat, half, params),
                                  action_masks)

    @torch.no_grad()
    @tracing.traced("policy.sample")
    def sample_actions(self, obs, action_masks, generator=None, gumbel=None,
                       deterministic=False, params=None):
        """Returns (actions int64, log_probs) (PPOLearner.cpp:116-184).
        Sampling is ``argmax(log p + g)`` with Gumbel noise ``g``: given as
        ``gumbel`` (same shape as the probabilities), or drawn from
        ``generator``.  ``params``: as in ``policy_probs``."""
        tracing.count("policy.rows", obs.shape[0])
        probs = self.policy_probs(obs, action_masks, params=params)
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
    def values(self, obs, half=None):
        """Critic values; ``half`` overrides ``half_precision``."""
        tracing.count("critic.rows", obs.shape[0])
        half = self._half(half)
        return self.critic(self._features(obs, half), half)[..., 0]

    # --- update -----------------------------------------------------------

    def _entropy(self, probs, action_masks):
        """Normalised entropy (PPOLearner.cpp:253-276)."""
        ent = -torch.sum(torch.log(probs) * probs, dim=-1)
        if self.config.mask_entropy:
            valid = torch.sum(action_masks.to(torch.float32), dim=-1)
            return ent / torch.log(torch.clamp(valid, min=2.0))
        return ent / torch.log(torch.tensor(float(self.num_actions),
                                            device=ent.device))

    def guide(self, guiding) -> "PPOLearner":
        """A frozen guiding policy for ``loss`` and ``update``: a learner of
        the same widths, or the JAX package's parameter tree (as
        ``params_from_jax`` takes it), copied into a learner with this
        learner's config, so that its probabilities take this config's
        precision and temperature as the JAX package's ``_loss`` does."""
        out = PPOLearner(self.obs_size, self.num_actions, self.config,
                         device=self.device)
        if isinstance(guiding, PPOLearner):
            out.load_state_dict(guiding.state_dict())
        else:
            out.params_from_jax(guiding)
        return out.requires_grad_(False)

    def loss(self, batch: dict, guiding: "PPOLearner | None" = None,
             denom=None):
        """(total loss, metrics) of one minibatch with fp32 forward passes.
        ``batch``: obs, mask, action, old_logp, advantage, target_value and
        optionally weight (per row; 0 leaves a row out).  ``guiding``: a
        learner from ``guide``; with ``guiding_strength`` > 0 the loss adds
        the mean L1 distance of the two policies' probabilities, scaled.
        Every mean is a sum over the rows divided by ``denom``: by default
        the row count, or the weight sum (at least 1); a data-parallel
        rank passes the whole minibatch's, so that its loss and metrics
        are its share of the minibatch's."""
        tracing.count("update.rows", batch["obs"].shape[0])
        cfg = self.config
        w = batch.get("weight")
        if denom is None:
            denom = (batch["obs"].shape[0] if w is None
                     else torch.clamp(torch.sum(w), min=1.0))

        def wmean(x):
            return torch.sum(x if w is None else x * w) / denom
        feat = self._features(batch["obs"], half=False)
        probs = self._masked_probs(self._logits(feat, False), batch["mask"])
        logp = torch.log(torch.gather(
            probs, -1, batch["action"][..., None].long()))[..., 0]
        entropy = wmean(self._entropy(probs, batch["mask"]))

        log_ratio = logp - batch["old_logp"]
        ratio = torch.exp(log_ratio)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_range,
                              1.0 + cfg.clip_range)
        adv = batch["advantage"]
        policy_loss = -wmean(torch.minimum(ratio * adv, clipped * adv))
        ppo_loss = policy_loss - entropy * cfg.entropy_scale

        guiding_loss = torch.zeros((), device=probs.device)
        if guiding is not None and cfg.guiding_strength > 0:
            gprobs = guiding.policy_probs(batch["obs"], batch["mask"])
            guiding_loss = wmean(torch.mean(torch.abs(gprobs - probs),
                                            dim=-1))
            ppo_loss = ppo_loss + guiding_loss * cfg.guiding_strength

        vals = self.critic(feat, False)[..., 0]
        critic_loss = wmean((vals - batch["target_value"]) ** 2)
        total = ppo_loss + critic_loss

        with torch.no_grad():
            kl = wmean(torch.exp(log_ratio) - 1.0 - log_ratio)
            clip_frac = wmean((torch.abs(ratio - 1.0)
                               > cfg.clip_range).to(torch.float32))
            aux = dict(entropy=entropy.detach(),
                       policy_loss=policy_loss.detach(),
                       critic_loss=critic_loss.detach(), kl=kl,
                       clip_fraction=clip_frac,
                       ratio=wmean(ratio.detach()),
                       guiding_loss=guiding_loss.detach())
        return total, aux

    @torch.no_grad()
    def _step_model(self, name: str):
        """Clip the model's grads by their global norm (optax's
        clip_by_global_norm: untouched below 0.5, else (g / norm) * 0.5),
        then its optimiser step."""
        model, lr = self._models()[name]
        params = [p for p in model.parameters()]
        grads = [p.grad for p in params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < MAX_GRAD_NORM
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * MAX_GRAD_NORM))
        opt = self.optimizers[name]
        if opt is not None:
            opt.step()
            return
        # MagSGD (Util/MagSGD.h:11-48): the clipped grads scaled to a
        # fixed update magnitude lr
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = -lr / torch.clamp(g_norm, min=1e-12)
        for p, g in zip(params, grads):
            p.add_(g * scale)

    @tracing.traced("iter.update", device="device")
    def update(self, data: dict, generator: torch.Generator | None = None,
               perms: torch.Tensor | None = None, guiding=None,
               shard: EnvShard | None = None, players: int = 1) -> dict:
        """One PPO learn phase (PPOLearner::Learn, :278-581) on flat
        ``(B, ...)`` rows: obs, mask, action, old_logp, advantage,
        target_value (and optionally weight).  Each epoch shuffles the
        rows by a permutation, ``perms[epoch]`` when given (``(epochs,
        B)``), else drawn from ``generator``; the rows are split evenly
        into ``max(B // batch_size, 1)`` minibatches (the remainder of the
        permutation is left out), each with its own advantage
        normalisation and one step of every model from one set of grads.
        ``guiding``: a frozen guiding policy, a learner or a parameter tree
        (see ``guide``; a learner with this config is used as it is).
        Returns the metrics averaged over all minibatches.

        ``shard`` (data-parallel, ``EnvShard``): ``data`` holds this rank's
        block of arenas, rows flat in (step, arena, player) order with
        ``players`` rows per arena; the permutations run over the global
        rows, each minibatch is this rank's rows of it (one host sync per
        epoch), its advantage mean and std, weight sum, gradients and the
        metrics are all-reduced."""
        cfg = self.config
        if guiding is not None and not (isinstance(guiding, PPOLearner)
                                        and guiding.config == cfg):
            guiding = self.guide(guiding)
        local = data["obs"].shape[0]
        if shard is None:
            shard, players = EnvShard(local), 1
        total = local // shard.local_envs * shard.global_envs
        num_batches = max(total // max(cfg.batch_size, 1), 1)
        batch_size = total // num_batches
        used = num_batches * batch_size
        weighted = "weight" in data
        params = list(self.parameters())
        sums = None
        with _full_fp32_matmul():
            for epoch in range(cfg.epochs):
                with tracing.span("update.epoch"):
                    perm = (perms[epoch] if perms is not None
                            else torch.randperm(total, generator=generator,
                                                device=self.device))
                    perm = perm[:used].to(self.device).reshape(num_batches,
                                                               batch_size)
                    for idx in shard.local_rows(perm, players):
                        batch = {k: v[idx] for k, v in data.items()}
                        adv = batch["advantage"]
                        first = torch.stack([torch.sum(adv)] + (
                            [torch.sum(batch["weight"])] if weighted
                            else []))
                        first = shard.all_sum(first)
                        mean = first[0] / batch_size
                        var = shard.all_sum(torch.sum((adv - mean) ** 2)
                                            .reshape(1))[0] / batch_size
                        batch["advantage"] = (adv - mean) / (torch.sqrt(var)
                                                             + 1e-8)
                        denom = (torch.clamp(first[1], min=1.0) if weighted
                                 else batch_size)
                        self.zero_grad()
                        total_loss, aux = self.loss(batch, guiding, denom)
                        total_loss.backward()
                        if shard.sharded:
                            _all_sum_grads(params, shard)
                        for name in self._models():
                            self._step_model(name)
                        sums = aux if sums is None else {
                            k: sums[k] + v for k, v in aux.items()}
        n = cfg.epochs * num_batches
        reduced = shard.all_sum(torch.stack(list(sums.values())))
        return {k: v / n for k, v in zip(sums, reduced)}


@torch.no_grad()
def _all_sum_grads(params, shard: EnvShard):
    """Sum every parameter's gradient over the ranks, in one flat
    all-reduce."""
    grads = [p.grad for p in params]
    flat = shard.all_sum(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.reshape(g.shape))


def _mlp_tree(sd: dict, prefix: str) -> dict:
    def a(key):
        return sd[prefix + key].detach().cpu().numpy().astype(np.float32)
    layers = []
    while f"{prefix}layers.{len(layers)}.weight" in sd:
        i = len(layers)
        layer = {"w": np.ascontiguousarray(a(f"layers.{i}.weight").T),
                 "b": a(f"layers.{i}.bias")}
        if f"{prefix}norms.{i}.weight" in sd:
            layer["ln_scale"] = a(f"norms.{i}.weight")
            layer["ln_bias"] = a(f"norms.{i}.bias")
        layers.append(layer)
    tree = {"layers": layers}
    if prefix + "out.weight" in sd:
        tree["out"] = {"w": np.ascontiguousarray(a("out.weight").T),
                       "b": a("out.bias")}
    return tree


def params_tree(state_dict: dict) -> dict:
    """A ``PPOLearner`` state dict (``learner.state_dict()``, or a
    checkpoint's ``"learner"``) as the JAX package's ``PPOParams`` tree:
    ``{"shared_head": mlp tree or None, "policy": ..., "critic": ...}``,
    each mlp tree ``{"layers": [{"w", "b", "ln_scale", "ln_bias"}], "out":
    {"w", "b"}}`` of float32 numpy arrays, ``w`` as (fan_in, fan_out)."""
    has_shared = any(k.startswith("shared_head.") for k in state_dict)
    return {"shared_head": (_mlp_tree(state_dict, "shared_head.")
                            if has_shared else None),
            "policy": _mlp_tree(state_dict, "policy."),
            "critic": _mlp_tree(state_dict, "critic.")}
