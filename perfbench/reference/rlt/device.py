"""Device selection and small tensor-tree helpers shared by the port."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another.  Raises when CUDA is wanted but absent; never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def constant(values, device) -> torch.Tensor:
    """A static float32 vector (a tuple or numpy array) as a tensor on
    ``device``, copied there once and kept: a copy from the host inside a
    physics tick would synchronise with the card."""
    return _constant(tuple(np.asarray(values, np.float32).tolist()), device)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of dataclasses, dicts, lists and
    tuples; other leaves (counters, flags) are kept as they are.  ``rest``
    trees are walked by the first tree's structure: field names for
    dataclasses, keys for dicts, positions for sequences (so a JAX pytree
    with the same field names can ride along)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree

