"""The port's tracer: spans and counters at its layer boundaries, in one
process-wide store.

    tracing.enable()
    with tracing.span("env.post"):                  # host clock
        ...

    @tracing.traced("iter.update", device="device")  # and self.device's
    def update(self, ...):
        ...

    tracing.count("kernel.launches")
    torch.cuda.synchronize()
    tracing.summary()

Counters always count: ``count`` adds a host number to a dict entry.
Spans are off by default.  Off, ``span`` returns one shared no-op context
and ``traced`` calls straight through: no allocation, no clock read, no
profiler annotation.  On, a span records its name, the span it opened in
(its parent) and its start and end on ``time.perf_counter_ns``.  A traced
method given a CUDA ``device`` also records a CUDA event pair on that
device's current stream; the pair is read only in ``summary``, once the
caller has waited for the device: the tracer never synchronises and never
reads a device value.
While a ``torch.profiler`` records, each span also opens
``record_function(name)``, so that the spans lie in the profiler's trace on
the kernels' clock.

Spans nest by the order they open and close, so they are for the one thread
that drives training.
"""

from __future__ import annotations

import functools
import operator
import time
from collections import defaultdict

import torch

_clock = time.perf_counter_ns
_on = False
_stack: list = []                      # the open spans, innermost last
_records: list = []                    # the closed ones, in closing order
_counters: defaultdict = defaultdict(int)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "parent", "start", "end", "events", "device_ms",
                 "_annotation")

    def __init__(self, name: str, device):
        self.name = name
        self.parent = _stack[-1] if _stack else None
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.device_ms = None
        self._annotation = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        _stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        if self.events is not None:
            self.events[1].record()
        _stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _records.append(self)
        return False

    def resolve(self):
        """The event pair's device ms, once the end event has completed."""
        if self.events is not None and self.events[1].query():
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that records a span named ``name`` while the tracer is
    on."""
    if not _on:
        return _NOOP
    return _Span(name, None)


def traced(name: str, device: str | None = None):
    """Decorate a method so that each call is a span named ``name``.
    ``device``: the attribute path, from the method's ``self``, of the
    device to time the call on too, on its current stream, where it is a
    CUDA device (``"env.device"``)."""
    get_device = operator.attrgetter(device) if device else None

    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kw):
            if not _on:
                return fn(self, *args, **kw)
            with _Span(name, get_device(self) if get_device else None):
                return fn(self, *args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` (a host number) to the counter ``name``."""
    _counters[name] += n


def reset():
    """Drop the closed spans and zero the counters."""
    _records.clear()
    _counters.clear()


def summary() -> dict:
    """The closed spans by name and the counters:

        {"spans": {name: {"calls", "total_ms", "self_ms"[, "device_ms"]}},
         "counters": {name: n}}

    ``self_ms`` is ``total_ms`` less the time the span's child spans cover;
    ``device_ms`` sums the event pairs that have completed, where the span
    had any."""
    children = defaultdict(int)
    for r in _records:
        if r.parent is not None:
            children[id(r.parent)] += r.end - r.start
    spans = {}
    for r in _records:
        s = spans.setdefault(r.name, {"calls": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        s["calls"] += 1
        s["total_ms"] += (r.end - r.start) / 1e6
        s["self_ms"] += (r.end - r.start - children[id(r)]) / 1e6
        r.resolve()
        if r.device_ms is not None:
            s["device_ms"] = s.get("device_ms", 0.0) + r.device_ms
    return {"spans": spans, "counters": dict(_counters)}
