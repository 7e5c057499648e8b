"""Checkpoint save, load and retention (Learner.cpp:224-279), with
``torch.save`` in place of the JAX package's orbax.

Layout as in the JAX package: one folder per checkpoint,
``<folder>/<total_timesteps>/``, holding ``state.pt`` and a
``RUNNING_STATS.json`` sidecar with the same keys (``total_timesteps``,
``iterations``, ``return_stat.{count,mean,m2}``); the newest
``checkpoints_to_keep`` are kept, and auto-resume takes the highest
number.

``state.pt`` holds what the JAX package's ``TrainState`` holds: the
learner's parameters and optimiser states, the Welford statistics, the
counters, the env states, observations and masks, and, in place of the
JAX key, the trainer's and the env's ``torch.Generator`` states and the
host ``RandomState`` of the self-play decisions.  As in the JAX package,
the version bank is not saved.  Every tensor is stored by its path in the
``TrainState`` and comes back, bit for bit, into a template of the same
structure on the template's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch


def _numbered_dirs(folder: str) -> list[int]:
    """Utils::FindNumberedDirs (Util/Utils.h:27)."""
    if not os.path.isdir(folder):
        return []
    return sorted(int(name) for name in os.listdir(folder)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(folder, name)))


def flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of the tensors, ints, floats and bools in a tree of
    dataclasses, dicts, lists and tuples."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def unflatten(template, flat: dict, prefix: str = ""):
    """``template`` with every leaf replaced by ``flat[path]``; tensors are
    moved to the template leaf's device."""
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return type(template)(**{
            f.name: unflatten(getattr(template, f.name), flat,
                              f"{prefix}{f.name}.")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten(v, flat, f"{prefix}{i}.")
                              for i, v in enumerate(template))
    value = flat[prefix]
    if isinstance(template, torch.Tensor):
        return value.to(template.device)
    return value


def _host_rng_state(rng: np.random.RandomState) -> dict:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def _set_host_rng_state(rng: np.random.RandomState, st: dict):
    rng.set_state((st["name"], st["keys"].numpy().astype(np.uint32),
                   st["pos"], st["has_gauss"], st["cached_gaussian"]))


def snapshot(trainer, state) -> dict:
    """Everything ``state.pt`` holds, as a dict of tensors and numbers."""
    learner = trainer.learner
    return {
        "state": flatten(state),
        "learner": learner.state_dict(),
        "optimizers": {name: (opt.state_dict() if opt is not None else None)
                       for name, opt in learner.optimizers.items()},
        "generators": {"trainer": trainer.generator.get_state(),
                       "env": trainer.env.generator.get_state()},
        "host_rng": _host_rng_state(trainer._host_rng),
    }


def load_checkpoint(path: str, trainer, template_state):
    """Restore a checkpoint saved by ``save_checkpoint`` into ``trainer``
    (its learner's parameters and optimiser states, its generators);
    returns the ``TrainState`` in ``template_state``'s structure and on
    its devices."""
    snap = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)
    learner = trainer.learner
    learner.load_state_dict(snap["learner"])
    for name, opt in learner.optimizers.items():
        if opt is not None:
            opt.load_state_dict(snap["optimizers"][name])
    trainer.generator.set_state(snap["generators"]["trainer"])
    trainer.env.generator.set_state(snap["generators"]["env"])
    _set_host_rng_state(trainer._host_rng, snap["host_rng"])
    return unflatten(template_state, snap["state"])


def save_checkpoint(folder: str, trainer, state, extra_stats: dict | None
                    = None, keep: int = 8) -> str:
    """Save ``trainer``'s learner and generators with ``state`` (a
    ``TrainState``) under ``folder/<total_timesteps>/``.  Returns the
    checkpoint's path."""
    ts = int(state.total_timesteps)
    path = os.path.abspath(os.path.join(folder, str(ts)))
    os.makedirs(folder, exist_ok=True)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(snapshot(trainer, state), os.path.join(path, "state.pt"))

    rs = state.return_stat
    stats = {
        "total_timesteps": ts,
        "iterations": int(state.iterations),
        "return_stat": {"count": float(rs.count), "mean": float(rs.mean),
                        "m2": float(rs.m2)},
    }
    if extra_stats:
        stats.update(extra_stats)
    with open(os.path.join(path, "RUNNING_STATS.json"), "w") as f:
        json.dump(stats, f, indent=1)

    # retention (Learner.cpp:236-251)
    if keep > 0:
        for old in _numbered_dirs(folder)[:-keep]:
            shutil.rmtree(os.path.join(folder, str(old)),
                          ignore_errors=True)
    return path


def latest_checkpoint(folder: str) -> str | None:
    nums = _numbered_dirs(folder)
    if not nums:
        return None
    return os.path.join(folder, str(nums[-1]))


def load_latest(folder: str, trainer, template_state):
    """Auto-resume (Learner.cpp:259-279): (state, stats) of the newest
    checkpoint, or (None, None)."""
    path = latest_checkpoint(folder)
    if path is None:
        return None, None
    state = load_checkpoint(path, trainer, template_state)
    with open(os.path.join(path, "RUNNING_STATS.json")) as f:
        stats = json.load(f)
    return state, stats


# ---------------------------------------------------------------------------
# Env-state snapshots (the reference's binary arena serialization,
# Arena::Serialize/DeserializeNew Arena.h:114-117): a tree of tensors
# round-trips through one flat .npz.

def save_env_state(path: str, state) -> None:
    """Snapshot an env or arena state (a tree of tensors) to ``path``
    (.npz), each leaf by its path."""
    np.savez_compressed(path, **{
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)) for k, v in flatten(state).items()})


def load_env_state(path: str, template_state):
    """Restore a snapshot saved by ``save_env_state`` into
    ``template_state``'s structure and devices."""
    with np.load(path) as data:
        flat = {k: torch.from_numpy(data[k]) for k in data.files}
    return unflatten(template_state, {
        k: (v if isinstance(t, torch.Tensor) else type(t)(v.item()))
        for (k, t), v in ((kt, flat[kt[0]])
                          for kt in flatten(template_state).items())})
