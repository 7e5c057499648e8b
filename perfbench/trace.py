"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time (the union of its operations' intervals), the
device operations that took most time, the idle gaps labelled by the
benchmark's span that the host was inside, and the device time of each
launch of a named kernel."""

from __future__ import annotations

from collections import defaultdict

NAME_CHARS = 120   # a kernel's name in the breakdown, cut to this length


def _events(prof) -> list:
    """(name, on_device, start_ns, end_ns, is_annotation) per event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), str(e.device_type()).endswith("CUDA"), start,
                    start + e.duration_ns(), e.is_user_annotation()))
    return out


def _merge(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def reduce(prof, window: str, kernel: str, spans: tuple) -> dict:
    """``window``: the annotation (``record_function``) around the traced
    window.  ``kernel``: a substring of the kernel whose launches are
    timed.  ``spans``: the names of the benchmark's spans, which label the
    idle gaps (the innermost one open at a gap's middle)."""
    events = _events(prof)
    lo, hi = next((start, end) for name, dev, start, end, is_ann in events
                  if is_ann and not dev and name == window)
    device, annotations = [], []
    by_op = defaultdict(float)
    launches = []
    for name, on_device, start, end, is_ann in events:
        if end <= lo or start >= hi:
            continue
        if on_device and not is_ann:
            device.append((max(start, lo), min(end, hi)))
            by_op[name] += (end - start) / 1e9
            if kernel in name:
                launches.append((start, (end - start) / 1e9))
        elif is_ann and not on_device and name in spans:
            annotations.append((start, end, name))
    merged = _merge(device)
    busy = sum(end - start for start, end in merged) / 1e9
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    annotations.sort()
    active, nxt = [], 0
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        while nxt < len(annotations) and annotations[nxt][0] <= mid:
            active.append(annotations[nxt])
            nxt += 1
        active = [a for a in active if a[1] >= mid]
        inner = min(active, key=lambda a: a[1] - a[0], default=None)
        gaps[inner[2] if inner else "outside any span"] += (end - start) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top = [(name[:NAME_CHARS], seconds) for name, seconds in top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (hi - lo) / 1e9,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle],
            "kernel_launches": [d for _, d in sorted(launches)]}
