"""Reduction of one profiled scene's torch.profiler trace to what the
per-layer metrics read: device busy time, device operations, the top
operations and idle gaps, and the device time of each kernel range the
recorder opened (the kernels launched inside it, whatever implements
them), against the bound its family gives the call's kind.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from benchmark.harness.record import RANGE_PREFIX


def _span(e):
    """(start, end) in ns of a kineto event."""
    s = e.start_ns()
    return s, s + e.duration_ns()


def _union(intervals):
    """Merged (start, end) intervals of a list of them."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, wall_s: float, frames: int, kernel_calls: list,
           kernels: dict) -> dict:
    """The summary of a profile of `frames` frames that took `wall_s`
    seconds of host time: ``busy_s``, ``window_s``, ``device_ops``,
    ``frames``, ``top_ops`` and ``idle_gaps`` (name, seconds), and
    ``kernels``: per roofline group, the summed bound and device seconds
    of its calls. `kernels` is the family's `KERNELS`: each call's kind
    gives its group and its bound; a kind it lacks raises."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    # the device's operations; the ranges' own device-side spans are not
    dev = [e for e in events if e.device_type() == cuda
           and not e.name().startswith(RANGE_PREFIX)]
    host = [e for e in events if e.device_type() != cuda]

    busy = _union([_span(e) for e in dev])
    busy_ns = sum(e - s for s, e in busy)

    by_name = defaultdict(int)
    for e in dev:
        by_name[e.name()] += e.duration_ns()
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps inside the device's span, named by the innermost host
    # operation running at the gap's middle
    ranges = sorted((_span(e) + (e.name(),)) for e in host
                    if not e.name().startswith(RANGE_PREFIX))
    starts = [r[0] for r in ranges]
    gaps = defaultdict(int)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "idle"
        # the latest-starting host event still running at `mid`
        for j in range(i, max(i - 200, -1), -1):
            if ranges[j][1] >= mid:
                name = ranges[j][2]
                break
        gaps[name] += s1 - e0
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    # device time of each kernel range: the device operations whose launch
    # (the host runtime call with the same correlation id) lies inside it
    launch_at = {e.correlation_id(): e.start_ns() for e in host
                 if e.name().startswith("cu")}
    spans = sorted((_span(e) + (int(e.name()[len(RANGE_PREFIX):]),))
                   for e in host if e.name().startswith(RANGE_PREFIX))
    span_starts = [s[0] for s in spans]
    dev_ns = defaultdict(int)
    for e in dev:
        t = launch_at.get(e.correlation_id())
        if t is None:
            continue
        i = bisect.bisect_right(span_starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            dev_ns[spans[i][2]] += e.duration_ns()
    groups = defaultdict(lambda: {"bound_s": 0.0, "device_s": 0.0,
                                  "calls": 0})
    for idx, (kind, shapes) in enumerate(kernel_calls):
        if kind not in kernels:
            raise LookupError(f"kernel kind {kind!r} is not registered")
        _, _, group, _, bound_s = kernels[kind]
        if idx not in dev_ns:
            continue
        k = groups[group]
        k["bound_s"] += bound_s(shapes)
        k["device_s"] += dev_ns[idx] / 1e9
        k["calls"] += 1
    return {"busy_s": busy_ns / 1e9, "window_s": wall_s,
            "device_ops": len(dev), "frames": frames,
            "top_ops": [[n, v / 1e9] for n, v in top_ops],
            "idle_gaps": [[n, v / 1e9] for n, v in idle_gaps],
            "kernels": dict(groups)}
