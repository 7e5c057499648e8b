"""A function over trees of tensors, replayed from one CUDA graph per input
shape.

    post = GraphedFn(env._post_physics, "env.post", device, generator)
    next_state, out = post(state, phys, controls, key=(offset, local_envs))

On a CUDA device the first call for a key (``key`` with the tree's
structure and every leaf's shape and dtype) runs ``fn`` eagerly.  The
second copies its inputs into static buffers, runs ``fn`` once more on a
side stream, so that lazily made library state (cuBLAS's workspace for
that stream) exists before the capture, puts the generator's state back,
and captures ``fn`` on that stream into a private graph.  That call and
every later one copy the inputs in (one ``torch._foreach_copy_`` per
dtype), replay the graph, and hand back fresh copies of the outputs (one
clone per dtype, cut into views), so that what a caller keeps is not
overwritten by the next replay.  On any other device every call runs
``fn`` eagerly.

``fn`` must not read a value back to the host, build a tensor from host
data, or change Python state from call to call: whatever it reads of
Python state at capture is baked into the graph.  Its random numbers come
from ``generator``, which every graph registers: a replay draws what an
eager call from the same generator state draws, and advances the state
alike, so that ``manual_seed`` and ``set_state`` keep their meaning.  A
``fn`` that draws none takes no generator (``None``).  A failed capture
raises.

Counters (``utils/tracing.py``): ``<name>.eager``, ``<name>.graph_captures``,
``<name>.graph_replays``; a span ``<name>.replay`` around copy-in, replay
and copy-out.
"""

from __future__ import annotations

import dataclasses
import gc
import operator

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from reinforcement_learning_torch.utils import tracing

_CONST = object()         # tags a non-tensor leaf in a tree's structure
_FIELDS: dict = {}        # dataclass type -> (field names, their getter)


def flatten(tree, leaves: list):
    """Append ``tree``'s tensor leaves to ``leaves`` in order; return its
    structure, hashable, with None for each tensor leaf.  Trees are
    dataclasses, dicts, lists and tuples; any other leaf is kept as a
    constant."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        keys = tuple(tree)
        return (dict, keys, tuple(flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree), None, tuple(flatten(v, leaves) for v in tree))
    cls = type(tree)
    fields = _FIELDS.get(cls)
    if fields is None:
        if not dataclasses.is_dataclass(tree):
            return (_CONST, tree, ())
        names = tuple(f.name for f in dataclasses.fields(tree))
        fields = _FIELDS[cls] = (names, operator.attrgetter(*names))
    names, get = fields
    values = get(tree) if len(names) > 1 else (get(tree),)
    return (cls, names, tuple([flatten(v, leaves) for v in values]))


def unflatten(spec, leaves):
    """The tree of structure ``spec`` with its tensor leaves drawn in order
    from the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    kind, names, children = spec
    if kind is _CONST:
        return names
    if kind is dict:
        return {k: unflatten(s, leaves) for k, s in zip(names, children)}
    if names is None:
        return kind(unflatten(s, leaves) for s in children)
    return kind(**{n: unflatten(s, leaves) for n, s in zip(names, children)})


def _by_dtype(tensors) -> list:
    """``tensors``' positions, grouped by dtype: [(positions, their
    getter)]."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return [(idx, operator.itemgetter(*idx) if len(idx) > 1
             else lambda x, i=idx[0]: (x[i],)) for idx in groups.values()]


class _Captured:
    """One captured graph: its static inputs by dtype, and its outputs as
    one flat static buffer per dtype with the leaves' places in it."""

    def __init__(self, graph, inputs, out_spec, outputs, n_out):
        self.graph = graph
        self.inputs = inputs        # [(static leaves, getter of sources)]
        self.out_spec = out_spec
        self.outputs = outputs      # [(flat, positions, the leaves)]
        self.n_out = n_out

    def replay(self, leaves):
        for static, get in self.inputs:
            torch._foreach_copy_(static, get(leaves))
        self.graph.replay()
        out = [None] * self.n_out
        for flat, idx, like in self.outputs:
            for i, t in zip(idx, _unflatten_dense_tensors(flat.clone(),
                                                          like)):
                out[i] = t
        return unflatten(self.out_spec, iter(out))


class GraphedFn:
    """``fn(*trees)`` on ``device``, replayed from a CUDA graph per key
    there (see the module's docstring); ``name`` prefixes its counters and
    span."""

    def __init__(self, fn, name: str, device,
                 generator: torch.Generator | None = None):
        self.fn = fn
        self.name = name
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.generator = generator
        self.seen = set()           # keys called once, eagerly
        self.graphs = {}            # key -> _Captured
        self._stream = None

    def __call__(self, *args, key):
        if not self.cuda:
            tracing.count(f"{self.name}.eager")
            return self.fn(*args)
        leaves = []
        spec = flatten(args, leaves)
        k = (key, spec, tuple([t.shape for t in leaves]),
             tuple([t.dtype for t in leaves]))
        captured = self.graphs.get(k)
        if captured is None:
            if k not in self.seen:
                self.seen.add(k)
                tracing.count(f"{self.name}.eager")
                return self.fn(*args)
            captured = self.graphs[k] = self._capture(spec, leaves)
            tracing.count(f"{self.name}.graph_captures")
        tracing.count(f"{self.name}.graph_replays")
        with tracing.span(f"{self.name}.replay"):
            return captured.replay(leaves)

    def _capture(self, spec, leaves) -> _Captured:
        with torch.cuda.device(self.device):
            return self._capture_here(spec, leaves)

    def _capture_here(self, spec, leaves) -> _Captured:
        main = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        side = self._stream
        static = [torch.empty_like(t) for t in leaves]
        inputs = [(list(get(static)), get) for _, get in _by_dtype(static)]
        for s, get in inputs:
            torch._foreach_copy_(s, get(leaves))
        args = unflatten(spec, iter(static))
        gen = self.generator
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        side.wait_stream(main)
        # no collection in the middle of a capture: it could free another
        # graph's memory while this one records
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                before = gen.get_state() if gen is not None else None
                self.fn(*args)                       # warm-up on the side
                if gen is not None:
                    gen.set_state(before)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out_leaves = []
                    out_spec = flatten(self.fn(*args), out_leaves)
                    outputs = []
                    for idx, get in _by_dtype(out_leaves):
                        parts = get(out_leaves)
                        outputs.append((_flatten_dense_tensors(parts), idx,
                                        parts))
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass      # the first error is the one to raise
                    raise
                graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        main.wait_stream(side)
        return _Captured(graph, inputs, out_spec, outputs, len(out_leaves))
