"""MLP: Linear layers, each followed by optional LayerNorm and an
activation (ReLU, leaky ReLU with slope 0.01, sigmoid or tanh), plus an
optional linear output layer (GigaLearnCPP/Util/Models.cpp:7-34).
Weights and biases start U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the JAX
package draws them.

With ``half_precision`` the hidden layers compute in bfloat16, LayerNorm
statistics in float32, and the output is float32 (Models.cpp:42-65).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """ModelConfig (Util/ModelConfig.h:6-43)."""
    num_inputs: int
    layer_sizes: tuple
    num_outputs: int = 0          # 0 => no output layer
    activation: str = "relu"      # relu | leaky_relu | sigmoid | tanh
    layer_norm: bool = True


ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.act = ACTIVATIONS[cfg.activation]
        sizes = [cfg.num_inputs] + list(cfg.layer_sizes)
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device) for i, o in zip(sizes[:-1],
                                                            sizes[1:]))
        self.norms = nn.ModuleList(
            nn.LayerNorm(o, eps=1e-5, device=device) for o in sizes[1:]
        ) if cfg.layer_norm else None
        self.out = (nn.Linear(sizes[-1], cfg.num_outputs, device=device)
                    if cfg.num_outputs > 0 else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        linears = list(self.layers) + ([self.out] if self.out else [])
        for lin in linears:
            bound = 1.0 / np.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
        for norm in self.norms or ():
            norm.reset_parameters()

    def forward(self, x: torch.Tensor,
                half_precision: bool = False) -> torch.Tensor:
        dtype = torch.bfloat16 if half_precision else torch.float32
        h = x.to(dtype)
        for i, lin in enumerate(self.layers):
            h = h @ lin.weight.to(dtype).T + lin.bias.to(dtype)
            if self.norms is not None:
                norm = self.norms[i]
                h = F.layer_norm(h.float(), norm.normalized_shape,
                                 norm.weight, norm.bias, norm.eps).to(dtype)
            h = self.act(h)
        if self.out is not None:
            h = h @ self.out.weight.to(dtype).T + self.out.bias.to(dtype)
        return h.float()

    @torch.no_grad()
    def load_jax(self, tree: dict) -> "MLP":
        """Copy the JAX package's parameters (``{"layers": [{"w", "b",
        "ln_scale", "ln_bias"}], "out": {"w", "b"}}``, ``w`` as (fan_in,
        fan_out) numpy arrays) into this module."""
        def t(x):
            return torch.tensor(np.asarray(x))

        layers = tree["layers"]
        if len(layers) != len(self.layers):
            raise ValueError(f"{len(layers)} layers given, module has "
                             f"{len(self.layers)}")
        for i, entry in enumerate(layers):
            self.layers[i].weight.copy_(t(entry["w"]).T)
            self.layers[i].bias.copy_(t(entry["b"]))
            if self.norms is not None:
                self.norms[i].weight.copy_(t(entry["ln_scale"]))
                self.norms[i].bias.copy_(t(entry["ln_bias"]))
        if self.out is not None:
            self.out.weight.copy_(t(tree["out"]["w"]).T)
            self.out.bias.copy_(t(tree["out"]["b"]))
        return self


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
