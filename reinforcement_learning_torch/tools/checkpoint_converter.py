"""Checkpoint converter: the port's checkpoints <-> rlgym-ppo state dicts,
the JAX package's ``.npz`` and GigaLearnCPP's torchscript archives.

    python -m reinforcement_learning_torch.tools.checkpoint_converter \\
        DIRECTION PATH [--out OUT] [--activation relu]

  to_torch   <checkpoint dir>  -> PPO_POLICY.pt, PPO_VALUE_NET.pt (and
                                  PPO_SHARED_HEAD.pt) state dicts in the
                                  rlgym-ppo naming ("model.<idx>.weight" /
                                  ".bias")
  from_torch <torch dir>       -> a parameter .npz that the JAX package and
                                  ``InferUnit.from_npz`` load
  to_lt      <checkpoint dir>  -> POLICY.lt, CRITIC.lt (and SHARED_HEAD.lt)
                                  torchscript archives GigaLearnCPP loads
  from_lt    <lt dir>          -> a parameter .npz

A checkpoint dir is one of ``utils/checkpoint.py``'s numbered folders
(``<folder>/<total_timesteps>/state.pt``).  The ``.npz`` layout is the JAX
package's (``policy/layers/<i>/w``, ``policy/out/b``, ...), so a model
trained by either package reaches the other through it.

rlgym-ppo's DiscreteFF/ValueEstimator are plain Linear+ReLU stacks; with
LayerNorm the norm's parameters go out as "model.<idx>.ln_scale/ln_bias"
(the JAX package's extension).  torch's Linear stores weight as (out, in),
transposed from the tree's (in, out).  Neither the state dicts nor the
``.npz`` record the activation: ``to_lt`` takes it as ``--activation``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from reinforcement_learning_torch.learn.ppo import params_tree

MODELS = ("policy", "critic", "shared_head")


def load_checkpoint_params(checkpoint_dir: str) -> dict:
    """The JAX-layout parameter tree of a port checkpoint's learner."""
    snap = torch.load(os.path.join(checkpoint_dir, "state.pt"),
                      map_location="cpu", weights_only=True)
    return params_tree(snap["learner"])


def _flatten_mlp_to_torch(params: dict, prefix: str = "model") -> dict:
    """An MLP tree -> an rlgym-ppo-style ordered state dict (numpy)."""
    out = {}
    idx = 0
    for layer in params["layers"]:
        out[f"{prefix}.{idx}.weight"] = np.asarray(layer["w"]).T
        out[f"{prefix}.{idx}.bias"] = np.asarray(layer["b"])
        if "ln_scale" in layer:
            out[f"{prefix}.{idx}.ln_scale"] = np.asarray(layer["ln_scale"])
            out[f"{prefix}.{idx}.ln_bias"] = np.asarray(layer["ln_bias"])
        idx += 2  # Linear + activation, as nn.Sequential indexes them
    if "out" in params:
        out[f"{prefix}.{idx}.weight"] = np.asarray(params["out"]["w"]).T
        out[f"{prefix}.{idx}.bias"] = np.asarray(params["out"]["b"])
    return out


def _torch_to_mlp(state_dict: dict) -> dict:
    """The inverse of ``_flatten_mlp_to_torch`` (tensors or numpy)."""
    def to_np(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    by_idx: dict[int, dict] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        by_idx.setdefault(int(parts[-2]), {})[parts[-1]] = to_np(val)

    idxs = sorted(by_idx)
    layers = []
    out = None
    for n, idx in enumerate(idxs):
        entry = by_idx[idx]
        layer = {"w": entry["weight"].T.copy(), "b": entry["bias"].copy()}
        if "ln_scale" in entry:
            layer["ln_scale"] = entry["ln_scale"].copy()
            layer["ln_bias"] = entry["ln_bias"].copy()
        if n == len(idxs) - 1 and "ln_scale" not in entry:
            out = layer
        else:
            layers.append(layer)
    params = {"layers": layers}
    if out is not None:
        params["out"] = out
    return params


def _write_npz(output_path: str, trees: dict) -> None:
    """``{model name: MLP tree or None}`` -> the JAX package's flat
    ``.npz`` (``<model>/layers/<i>/<key>``, ``<model>/out/<key>``)."""
    flat = {}
    for name, tree in trees.items():
        if tree is None:
            continue
        for i, layer in enumerate(tree["layers"]):
            for k, v in layer.items():
                flat[f"{name}/layers/{i}/{k}"] = v
        for k, v in tree.get("out", {}).items():
            flat[f"{name}/out/{k}"] = v
    np.savez(output_path, **flat)


def export_to_torch(checkpoint_dir: str, output_dir: str):
    params = load_checkpoint_params(checkpoint_dir)
    os.makedirs(output_dir, exist_ok=True)
    for name, fname in (("policy", "PPO_POLICY.pt"),
                        ("critic", "PPO_VALUE_NET.pt"),
                        ("shared_head", "PPO_SHARED_HEAD.pt")):
        if params.get(name) is None:
            continue
        sd = _flatten_mlp_to_torch(params[name])
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                   os.path.join(output_dir, fname))
    print(f"Exported torch state dicts to {output_dir}")


def import_from_torch(torch_dir: str, output_path: str):
    def load(fname):
        return torch.load(os.path.join(torch_dir, fname),
                          map_location="cpu", weights_only=True)
    trees = {"policy": _torch_to_mlp(load("PPO_POLICY.pt")),
             "critic": _torch_to_mlp(load("PPO_VALUE_NET.pt")),
             "shared_head": None}
    if os.path.exists(os.path.join(torch_dir, "PPO_SHARED_HEAD.pt")):
        trees["shared_head"] = _torch_to_mlp(load("PPO_SHARED_HEAD.pt"))
    _write_npz(output_path, trees)
    print(f"Imported params saved to {output_path}")


def load_npz_params(path: str) -> dict:
    """A parameter ``.npz`` (``import_from_torch``, ``import_from_lt``, or
    the JAX package's converter) as the ``PPOParams`` tree."""
    params = {name: {"layers": []} for name in MODELS}
    with np.load(path) as data:
        for key in sorted(data.files):
            parts = key.split("/")
            model = params[parts[0]]
            if parts[1] == "layers":
                i = int(parts[2])
                while len(model["layers"]) <= i:
                    model["layers"].append({})
                model["layers"][i][parts[3]] = data[key]
            else:
                model.setdefault("out", {})[parts[2]] = data[key]
    if not params["shared_head"]["layers"]:
        params["shared_head"] = None
    return params


# ---------------------------------------------------------------------------
# GigaLearnCPP ``.lt`` torchscript archives (Models.cpp:116-127 saves each
# model's nn::Sequential with torch::save; torch.jit.load reads them)

_LT_NAMES = {"policy": "POLICY.lt", "critic": "CRITIC.lt",
             "shared_head": "SHARED_HEAD.lt"}


def _build_torch_sequential(params: dict, activation: str = "relu"):
    """An MLP tree -> an nn.Sequential with the reference's module layout
    (Models.cpp:16-29: Linear [+LayerNorm] + activation per hidden layer,
    then the output Linear)."""
    import torch.nn as nn

    acts = {"relu": nn.ReLU, "leaky_relu": nn.LeakyReLU,
            "sigmoid": nn.Sigmoid, "tanh": nn.Tanh}
    mods = []

    def _linear(layer):
        w = np.asarray(layer["w"])
        lin = nn.Linear(w.shape[0], w.shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(layer["b"]).copy()))
        return lin

    for layer in params["layers"]:
        mods.append(_linear(layer))
        if "ln_scale" in layer:
            ln = nn.LayerNorm(len(layer["ln_scale"]))
            with torch.no_grad():
                ln.weight.copy_(torch.from_numpy(
                    np.asarray(layer["ln_scale"]).copy()))
                ln.bias.copy_(torch.from_numpy(
                    np.asarray(layer["ln_bias"]).copy()))
            mods.append(ln)
        mods.append(acts[activation]())
    if "out" in params:
        mods.append(_linear(params["out"]))
    return nn.Sequential(*mods)


def _sequential_to_params(module) -> dict:
    """A torch.jit-loaded Sequential -> an MLP tree.  Linear weights are
    2-D, LayerNorm weights 1-D.  The output layer (addOutputLayer,
    Models.cpp:25-28) is found by structure: every hidden Linear is
    followed by an activation module, so a Linear that is the sequence's
    last module is the output layer (LayerNorm presence would misfile the
    last hidden Linear of a model built without LayerNorm and without an
    output layer)."""
    entries = []
    by_idx: dict[int, dict] = {}
    for key, val in module.state_dict().items():
        parts = key.split(".")
        by_idx.setdefault(int(parts[-2]), {})[parts[-1]] = \
            val.detach().cpu().numpy()
    for idx in sorted(by_idx):
        e = by_idx[idx]
        entries.append(("linear" if e["weight"].ndim == 2 else "ln", e))

    # the last module's index, activations included (they are children
    # though they hold no parameters)
    last_module_idx = max(
        (int(name) for name, _ in module.named_children()
         if name.isdigit()), default=-1)
    last_param_idx = max(by_idx) if by_idx else -1
    has_output_layer = (last_module_idx == last_param_idx
                        and len(entries) > 1 and entries[-1][0] == "linear")

    layers = []
    i = 0
    while i < len(entries):
        kind, e = entries[i]
        if kind != "linear":
            raise ValueError("unexpected module order in .lt archive")
        layer = {"w": e["weight"].T.copy(), "b": e["bias"].copy()}
        if i + 1 < len(entries) and entries[i + 1][0] == "ln":
            layer["ln_scale"] = entries[i + 1][1]["weight"].copy()
            layer["ln_bias"] = entries[i + 1][1]["bias"].copy()
            i += 1
        i += 1
        layers.append(layer)
    params = {"layers": layers}
    if has_output_layer:
        out = layers.pop()
        params["out"] = {"w": out["w"], "b": out["b"]}
    return params


def export_to_lt(checkpoint_dir: str, output_dir: str,
                 activation: str = "relu"):
    """A port checkpoint -> GigaLearnCPP POLICY.lt / CRITIC.lt (/
    SHARED_HEAD.lt) torchscript archives the reference learner loads."""
    params = load_checkpoint_params(checkpoint_dir)
    os.makedirs(output_dir, exist_ok=True)
    for name, fname in _LT_NAMES.items():
        if params.get(name) is None:
            continue
        seq = _build_torch_sequential(params[name], activation)
        torch.jit.save(torch.jit.script(seq),
                       os.path.join(output_dir, fname))
    print(f"Exported .lt archives to {output_dir}")


def import_from_lt(lt_dir: str, output_path: str):
    """GigaLearnCPP .lt archives -> a parameter .npz (the reference's
    to_python direction)."""
    trees = {}
    for name, fname in _LT_NAMES.items():
        path = os.path.join(lt_dir, fname)
        if os.path.exists(path):
            trees[name] = _sequential_to_params(
                torch.jit.load(path, map_location="cpu"))
    _write_npz(output_path, trees)
    print(f"Imported params saved to {output_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert port checkpoints to and from rlgym-ppo state "
                    "dicts, the JAX package's .npz and GigaLearnCPP .lt "
                    "archives.")
    ap.add_argument("direction",
                    choices=["to_torch", "from_torch", "to_lt", "from_lt"])
    ap.add_argument("path")
    ap.add_argument("--out", default=None)
    ap.add_argument("--activation", default="relu",
                    choices=["relu", "leaky_relu", "sigmoid", "tanh"])
    args = ap.parse_args(argv)
    if args.direction == "to_torch":
        export_to_torch(args.path, args.out or "torch_checkpoint")
    elif args.direction == "from_torch":
        import_from_torch(args.path, args.out or "imported_params.npz")
    elif args.direction == "to_lt":
        export_to_lt(args.path, args.out or "cpp_checkpoint",
                     args.activation)
    else:
        import_from_lt(args.path, args.out or "imported_params.npz")


if __name__ == "__main__":
    main()
