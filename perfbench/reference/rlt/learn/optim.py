"""AdamW, Adagrad and RMSprop written to optax's formulas (optax 0.2.6
``adamw``, ``adagrad`` and ``rmsprop`` with their defaults), which the
JAX package's ``PPOLearner._make_optim`` chains after the 0.5 global-norm
clip.  torch.optim's versions differ in defaults and in where eps sits:

  * AdamW: weight decay 1e-4 on every parameter, added to the Adam
    direction before the learning rate, ``p -= lr * (m^/(sqrt(v^)+eps) +
    wd * p)`` (torch: decay 1e-2, applied as ``p *= 1 - lr * wd`` first);
  * Adagrad: the accumulator starts at 0.1 and eps 1e-7 sits inside the
    root, ``g * rsqrt(sum + eps)``, 0 where the sum is 0 (torch: starts at
    0, eps outside);
  * RMSprop: decay 0.9, eps 1e-8 inside the root, the mean square starts at
    0, no momentum, no centring (torch: alpha 0.99, eps outside).
"""

from __future__ import annotations

import torch


class _OptaxLike(torch.optim.Optimizer):
    """One step per call over every parameter with a grad; the state of
    each is made by ``_init`` on its first step."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))

    def _init(self, p, group) -> dict:
        raise NotImplementedError

    def _direction(self, p, g, st, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init(p, group))
                p.add_(self._direction(p, p.grad, st, group),
                       alpha=-group["lr"])


class AdamW(_OptaxLike):
    """optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(params, lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)

    def _init(self, p, group):
        return dict(step=0, exp_avg=torch.zeros_like(p),
                    exp_avg_sq=torch.zeros_like(p))

    def _direction(self, p, g, st, group):
        b1, b2 = group["betas"]
        st["step"] += 1
        m = st["exp_avg"].mul_(b1).add_((1 - b1) * g)
        v = st["exp_avg_sq"].mul_(b2).add_((1 - b2) * g * g)
        count = torch.tensor(float(st["step"]), dtype=p.dtype,
                             device=p.device)
        m_hat = m / (1 - torch.tensor(b1, dtype=p.dtype,
                                      device=p.device) ** count)
        v_hat = v / (1 - torch.tensor(b2, dtype=p.dtype,
                                      device=p.device) ** count)
        return m_hat / (torch.sqrt(v_hat) + group["eps"]) \
            + group["weight_decay"] * p


class Adagrad(_OptaxLike):
    """optax.adagrad(lr): initial accumulator 0.1, eps 1e-7."""

    def __init__(self, params, lr: float, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, lr, initial=initial_accumulator_value,
                         eps=eps)

    def _init(self, p, group):
        return dict(sum=torch.full_like(p, group["initial"]))

    def _direction(self, p, g, st, group):
        s = st["sum"].copy_(g * g + st["sum"])
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
        return inv * g


class RMSprop(_OptaxLike):
    """optax.rmsprop(lr): decay 0.9, eps 1e-8 inside the root."""

    def __init__(self, params, lr: float, decay=0.9, eps=1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def _init(self, p, group):
        return dict(nu=torch.zeros_like(p))

    def _direction(self, p, g, st, group):
        d = group["decay"]
        nu = st["nu"].copy_((1 - d) * (g * g) + d * st["nu"])
        return torch.rsqrt(nu + group["eps"]) * g


OPTIMIZERS = {"adamw": AdamW, "adagrad": Adagrad, "rmsprop": RMSprop}
