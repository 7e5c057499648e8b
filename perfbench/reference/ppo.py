"""The learning half of an iteration as plain PyTorch in float32 with TF32
off: the critic values, GAE, the return statistic and the clipped PPO
update with its optimisers.  A copy of the port's ``learn/ppo.py``
(``loss``, ``update``, ``_step_model``) and ``learn/trainer.py``
(``prepare``) as they were when the benchmark was written, on one process,
built from a configuration file's widths and handed the benchmark's
weights.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.reference.rlt.learn import gae as gaemod
from perfbench.reference.rlt.learn import welford
from perfbench.reference.rlt.learn.optim import OPTIMIZERS
from perfbench.reference.rlt.models import mlp

ACTION_MIN_PROB = 1e-11
ACTION_DISABLED_LOGIT = -1e10
MAX_GRAD_NORM = 0.5
MODELS = ("policy", "critic", "shared_head")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class RefLearner:
    """Shared head, policy and critic of a configuration file, with the
    weights ``weights`` (name -> tensor, the program's parameter names)."""

    def __init__(self, config: dict, weights: dict, device):
        ppo = self.ppo = config["ppo"]
        obs, actions = config["obs_size"], config["num_actions"]
        self.num_actions = actions
        shared = tuple(ppo["shared_head_layers"])
        feat = shared[-1] if shared else obs

        def make(n_in, layers, n_out):
            return mlp.MLP(mlp.MLPConfig(
                num_inputs=n_in, layer_sizes=tuple(layers),
                num_outputs=n_out, activation=ppo["activation"],
                layer_norm=ppo["layer_norm"]), device=device)
        self.models = {"policy": make(feat, ppo["policy_layers"], actions),
                       "critic": make(feat, ppo["critic_layers"], 1)}
        if shared:
            self.models["shared_head"] = make(obs, shared, 0)
        with torch.no_grad():
            for name, model in self.models.items():
                for k, p in model.named_parameters():
                    p.copy_(weights[f"{name}.{k}"])
        lrs = {"policy": ppo["policy_lr"], "critic": ppo["critic_lr"],
               "shared_head": ppo["policy_lr"]}

        def optim(model, lr):
            if ppo["optim"] == "adam":
                return torch.optim.Adam(model.parameters(), lr=lr,
                                        betas=(0.9, 0.999), eps=1e-8)
            return OPTIMIZERS[ppo["optim"]](model.parameters(), lr=lr)
        self.optimizers = {n: optim(m, lrs[n])
                           for n, m in self.models.items()}

    def load_optimizers(self, states: dict):
        """Each parameter's optimiser state from a captured program's
        (model -> parameter name -> state): tensors with an axis on the
        device, a step count as the optimiser keeps it."""
        for name, opt in self.optimizers.items():
            for k, p in self.models[name].named_parameters():
                opt.state[p] = {
                    key: (v.to(p.device) if isinstance(v, torch.Tensor)
                          and v.dim() else
                          v.clone() if isinstance(v, torch.Tensor) else v)
                    for key, v in states[name][k].items()}

    def params(self) -> dict:
        return {f"{n}.{k}": p.detach().clone()
                for n, m in self.models.items()
                for k, p in m.named_parameters()}

    def _features(self, obs, half=False):
        if "shared_head" in self.models:
            return self.models["shared_head"](obs, half)
        return obs

    def _probs(self, feat, mask, half=False):
        logits = self.models["policy"](feat, half)
        temp = self.ppo.get("policy_temperature", 1.0)
        if temp != 1.0:
            logits = logits / temp
        logits = logits + ACTION_DISABLED_LOGIT * (~mask).float()
        return torch.clamp(torch.softmax(logits, dim=-1), ACTION_MIN_PROB,
                           1.0)

    @torch.no_grad()
    def logp(self, obs, mask, action, half=False):
        """Log-probability of ``action`` under the masked policy; ``half``:
        the hidden layers in bf16, as the program's inference."""
        probs = self._probs(self._features(obs, half), mask, half)
        return torch.log(torch.gather(probs, -1, action[..., None]))[..., 0]

    @torch.no_grad()
    def logit_scale(self, obs, mask):
        """Each row's largest |logit| over its valid actions, at least 1:
        the scale of a rounding error in the logits, which a log-prob
        inherits."""
        logits = self.models["policy"](self._features(obs), False)
        logits = logits / self.ppo.get("policy_temperature", 1.0)
        big = torch.where(mask, logits.abs(), 0.0).amax(-1)
        return torch.clamp(big, min=1.0)

    @torch.no_grad()
    def values(self, obs):
        return self.models["critic"](self._features(obs), False)[..., 0]

    def _entropy(self, probs, mask):
        ent = -torch.sum(torch.log(probs) * probs, dim=-1)
        if self.ppo["mask_entropy"]:
            valid = torch.sum(mask.to(torch.float32), dim=-1)
            return ent / torch.log(torch.clamp(valid, min=2.0))
        return ent / torch.log(torch.tensor(float(self.num_actions),
                                            device=ent.device))

    def loss(self, batch: dict, denom):
        ppo = self.ppo
        w = batch.get("weight")

        def wmean(x):
            return torch.sum(x if w is None else x * w) / denom
        feat = self._features(batch["obs"])
        probs = self._probs(feat, batch["mask"])
        logp = torch.log(torch.gather(
            probs, -1, batch["action"][..., None].long()))[..., 0]
        entropy = wmean(self._entropy(probs, batch["mask"]))
        ratio = torch.exp(logp - batch["old_logp"])
        clipped = torch.clamp(ratio, 1.0 - ppo["clip_range"],
                              1.0 + ppo["clip_range"])
        adv = batch["advantage"]
        policy_loss = -wmean(torch.minimum(ratio * adv, clipped * adv))
        vals = self.models["critic"](feat, False)[..., 0]
        critic_loss = wmean((vals - batch["target_value"]) ** 2)
        return policy_loss - entropy * ppo["entropy_scale"] + critic_loss

    @torch.no_grad()
    def _step_model(self, name: str) -> dict:
        """Clip by the global norm, step; returns the clipped gradients."""
        model = self.models[name]
        grads = {k: p.grad for k, p in model.named_parameters()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < MAX_GRAD_NORM
        for g in grads.values():
            g.copy_(torch.where(keep, g, (g / norm) * MAX_GRAD_NORM))
        self.optimizers[name].step()
        return {f"{name}.{k}": g.clone() for k, g in grads.items()}

    def update(self, data: dict, generator: torch.Generator) -> tuple:
        """The PPO epochs over the rows of ``data``, each epoch's
        permutation drawn from ``generator`` as the program draws it.
        Returns (each minibatch's loss, each step's clipped gradients)."""
        ppo = self.ppo
        total = data["obs"].shape[0]
        num_batches = max(total // max(ppo["batch_size"], 1), 1)
        batch_size = total // num_batches
        used = num_batches * batch_size
        dev = data["obs"].device
        losses, grads = [], []
        for _ in range(ppo["epochs"]):
            perm = torch.randperm(total, generator=generator, device=dev)
            perm = perm[:used].reshape(num_batches, batch_size)
            for idx in perm:
                batch = {k: v[idx] for k, v in data.items()}
                adv = batch["advantage"]
                mean = torch.sum(adv) / batch_size
                var = torch.sum((adv - mean) ** 2) / batch_size
                batch["advantage"] = (adv - mean) / (torch.sqrt(var) + 1e-8)
                denom = (torch.clamp(torch.sum(batch["weight"]), min=1.0)
                         if "weight" in batch else batch_size)
                for m in self.models.values():
                    m.zero_grad()
                loss = self.loss(batch, denom)
                loss.backward()
                step = {}
                for name in MODELS:
                    if name in self.models:
                        step.update(self._step_model(name))
                losses.append(float(loss.detach()))
                grads.append(step)
        return losses, grads

    def prepare(self, traj: dict, return_stat, gamma, lam, clip_range,
                standardize_returns=True):
        """Values, GAE and the return statistic of a collected ``traj``:
        (the update's rows, the new return statistic)."""
        T, N, P = traj["action"].shape

        def flat(x):
            return x.reshape((T * N * P,) + tuple(x.shape[3:]))
        v_obs = self.values(flat(traj["obs"]))
        v_final = self.values(flat(traj["final_obs"]))
        terminal_tb = traj["terminal"].repeat_interleave(P, dim=-1)
        return_std = (return_stat.std if standardize_returns
                      else torch.ones((), device=v_obs.device))
        advs, targets, returns, _ = gaemod.compute_gae(
            traj["reward"].reshape(T, N * P), terminal_tb,
            v_obs.reshape(T, N * P), v_final.reshape(T, N * P),
            gamma=gamma, lam=lam, return_std=return_std,
            reward_clip_range=clip_range)
        return_stat = welford.update_batch(return_stat, returns.reshape(-1))
        data = dict(obs=flat(traj["obs"]), mask=flat(traj["mask"]),
                    action=flat(traj["action"]),
                    old_logp=flat(traj["old_logp"]),
                    advantage=advs.reshape(-1),
                    target_value=targets.reshape(-1))
        return data, return_stat
