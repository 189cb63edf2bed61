"""Reading the device trace of a traced run (``--trace 1``).

The run is traced by ``torch.profiler`` with the CPU and CUDA activities;
each question runs inside ``record_function("q:<name>")``, the benchmark's
own span.  From the profiler's raw events this module takes the device's
activity intervals (kernels, copies, sets; not the spans the annotations
leave on the device's timeline) and the question spans, on one clock, in
microseconds.
"""

from __future__ import annotations

import bisect
import glob
import os
import re

SPAN = "q:"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernels(root):
    """The names of the port's own kernels: every ``__global__`` function
    of ``vaex_tpu_torch/csrc/*.cu`` and ``*.cuh``, read when the run
    starts."""
    names = set()
    for pattern in ("*.cu", "*.cuh"):
        for path in glob.glob(os.path.join(root, "vaex_tpu_torch", "csrc", pattern)):
            with open(path) as f:
                names.update(GLOBAL.findall(f.read()))
    return sorted(names)


def union(intervals):
    """[(start, end)] merged into disjoint intervals, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals):
    return sum(e - s for s, e in union(intervals))


def events(prof):
    """(device ops [(start, end, name)], question spans [(start, end, name)])
    of a stopped profile, in microseconds, read from its raw events (no
    tree of function events is built)."""
    import torch
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)  # integer ns keep every digit
    device, spans = [], []
    for e in raw:
        name = e.name()
        start = (e.start_ns() - base) * 1e-3
        end = start + e.duration_ns() * 1e-3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith(SPAN):
                device.append((start, end, name))
        elif name.startswith(SPAN):
            spans.append((start, end, name[len(SPAN):]))
    return device, spans


def idle_gaps(device, spans):
    """[(question, idle us)]: the device's idle time between the first
    span's start and the last span's end, split at the busy intervals and
    summed by the question whose span holds each gap's middle ("between
    questions" where none does)."""
    if not spans:
        return []
    t0, t1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    busy = [(max(s, t0), min(e, t1)) for s, e, _ in device if e > t0 and s < t1]
    gaps, at = [], t0
    for s, e in union(busy):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    ordered = sorted(spans)
    starts = [s for s, _, _ in ordered]
    by = {}
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = ordered[i][2] if i >= 0 and ordered[i][1] >= mid else "between questions"
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])


def top_ops(device, n=10, width=120):
    """[(name, total us)] of the device ops that took the most time."""
    by = {}
    for s, e, name in device:
        by[name[:width]] = by.get(name[:width], 0.0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]
