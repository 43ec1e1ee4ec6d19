"""The program's own trace of the profiled unit, reduced per layer: the
device's idle time inside each layer's stages, the host's waits on the
device and the kernel launches there, the program's counters, and the
idle gaps named by the innermost program span.

The program (vggsfm_tpu_torch/utils/trace.py) records its stages, spans
and counters while its tracer records, and then marks each span as a
profiler range ``vggsfm.<name>``. A traced run's profiled unit (cell.py's
`_profile`) runs with the tracer off, so `read` profiles the unit once
more after the run: a pipeline of the cell built anew (its pool cut to
the warm-up scene), the unit once to warm it, then once under
torch.profiler with the tracer recording. A program without the tracer
gives nothing to read.

A layer is the set of its stages' ranges, from the timing keys the
configuration lists for it (a key with a leading '-' is subtracted), as
`metrics/_timings.py` sums their seconds.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import time
from collections import defaultdict

import torch

from benchmark.harness import family
from benchmark.harness.record import RANGE_PREFIX as KERNEL_PREFIX

PREFIX = "vggsfm."
# the runtime calls that launch work on the device, and those in which the
# host waits for it
LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")
SYNC = "Synchronize"


def read(rec: dict) -> dict | None:
    """The program's trace of a traced run (``rec["trace"]["program"]``),
    made on the first call; its idle gaps also go to the result line's
    ``breakdown`` as ``idle_spans``. None where the run has no trace or
    the program has no tracer."""
    t = rec.get("trace")
    if not t:
        return None
    if "program" not in t:
        t["program"] = profile_unit(rec["config"], rec["workload"],
                                    rec["device"]["platform"])
        if t["program"] is not None:
            rec.setdefault("breakdown", {})["idle_spans"] = \
                t["program"]["idle_spans"]
    return t["program"]


def profile_unit(cfg: dict, wl: dict, platform: str) -> dict | None:
    """The warm-up unit of the cell, profiled with the program's tracer
    recording, reduced by `reduce`; None where the program has no
    tracer."""
    try:
        ptrace = importlib.import_module("vggsfm_tpu_torch.utils.trace")
    except ImportError:
        return None
    from benchmark.harness.cell import WORK_DIR

    t0 = time.perf_counter()
    device = torch.device("cuda", 0) if platform == "gpu" \
        else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    pipe = family.pipeline_module(cfg).Pipeline(
        cfg, {**wl, "pool": 1}, device, WORK_DIR)
    try:
        pipe.warm_up()
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof, \
                ptrace.recording() as tr:
            frames = pipe.warm_up()
            sync()
        out = reduce(prof.profiler.kineto_results.events(), tr.spans,
                     cfg["timings"], frames)
    finally:
        pipe.recorder.close()
        del pipe
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["pass_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ intervals

def _union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _subtract(a: list, b: list) -> list:
    """The merged intervals `a` minus the merged intervals `b`."""
    out = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def _length(iv: list) -> int:
    return sum(e - s for s, e in iv)


def _overlap(a: list, b: list) -> int:
    """The length of the intersection of two merged interval lists."""
    return _length(a) - _length(_subtract(a, b))


def _inside(times: list, iv: list) -> int:
    """How many of the sorted `times` fall inside the merged `iv`."""
    n = 0
    for s, e in iv:
        n += bisect.bisect_right(times, e) - bisect.bisect_left(times, s)
    return n


def _span(e) -> tuple:
    s = e.start_ns()
    return s, s + e.duration_ns()


# ------------------------------------------------------------ reduction

def reduce(events, spans: list, layers: dict, frames: int) -> dict:
    """Per layer of ``layers`` ({layer: timing keys}): ``seconds`` (its
    stages' ranges), ``idle_s`` (no device operation running inside
    them), ``syncs`` (the host's synchronize calls there, and its
    device-to-host copies made by a blocking call), ``launches`` (kernel
    launch calls there) and ``cast_bytes`` (the ``weights.cast_bytes``
    counted inside its stages). Over the unit: ``unit_s`` and ``idle_s``
    (the events' whole span, and the device's idle time in it),
    ``idle_in_stages_s`` (of that idle time, what falls in a stage),
    ``counters`` (each counter's total) and ``idle_spans``: the ten
    program spans with the most idle gaps, a gap named by the innermost
    span open at its middle. `events` are torch.profiler's kineto events,
    `spans` the program's recorded spans."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, ranges = [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            # the device-side copies of the ranges are not device work
            if not name.startswith((PREFIX, KERNEL_PREFIX)):
                dev.append(e)
        elif name.startswith(PREFIX):
            ranges.append(_span(e) + (name[len(PREFIX):],))
        else:
            host.append(e)
    busy = _union([_span(e) for e in dev])
    every = [_span(e) for e in dev] + [_span(e) for e in host] \
        + [r[:2] for r in ranges]
    unit = [[min(s for s, _ in every), max(e for _, e in every)]] \
        if every else []
    unit_idle = _length(unit) - _overlap(unit, busy)

    key_of = {s["name"]: s["key"] for s in spans if s["kind"] == "stage"}
    by_key = defaultdict(list)
    for s, e, name in ranges:
        if name in key_of:
            by_key[key_of[name]].append((s, e))

    # the host's waits and launches, by the time of the runtime call
    calls = [e for e in host if e.name().startswith("cu")]
    runtime = {e.correlation_id(): e for e in calls}
    syncs = [e.start_ns() for e in calls if SYNC in e.name()]
    for e in dev:
        call = runtime.get(e.correlation_id())
        if (e.name().startswith("Memcpy DtoH") and call is not None
                and "Async" not in call.name()):
            syncs.append(call.start_ns())
    syncs.sort()
    launches = sorted(e.start_ns() for e in calls
                      if e.name().startswith(LAUNCH))

    cast = _cast_bytes_by_layer(spans, layers)
    out_layers = {}
    for layer, keys in layers.items():
        plus = _union(iv for k in keys if not k.startswith("-")
                      for iv in by_key.get(k, ()))
        minus = _union(iv for k in keys if k.startswith("-")
                       for iv in by_key.get(k[1:], ()))
        iv = _subtract(plus, minus)
        out_layers[layer] = {
            "seconds": _length(iv) / 1e9,
            "idle_s": (_length(iv) - _overlap(iv, busy)) / 1e9,
            "syncs": _inside(syncs, iv), "launches": _inside(launches, iv),
            "cast_bytes": cast.get(layer, 0)}

    stages = _union(iv for ivs in by_key.values() for iv in ivs)
    counters = defaultdict(float)
    for s in spans:
        for k, v in s["counters"].items():
            counters[k] += v
    return {"frames": frames, "unit_s": _length(unit) / 1e9,
            "idle_s": unit_idle / 1e9,
            "idle_in_stages_s": (_length(stages) - _overlap(stages, busy))
            / 1e9,
            "layers": out_layers, "counters": dict(counters),
            "idle_spans": _idle_spans(busy, ranges)}


def _cast_bytes_by_layer(spans: list, layers: dict) -> dict:
    """``weights.cast_bytes`` per layer: a span's count belongs to the
    layer of its innermost enclosing stage whose key the layer lists (not
    to it where the key is subtracted)."""
    out = defaultdict(float)
    for s in spans:
        n = s["counters"].get("weights.cast_bytes")
        if not n:
            continue
        for layer, keys in layers.items():
            p = s
            while p is not None:
                if p["kind"] == "stage" and p["key"] in keys:
                    out[layer] += n
                    break
                if p["kind"] == "stage" and "-" + p["key"] in keys:
                    break
                p = None if p["parent"] is None else spans[p["parent"]]
    return dict(out)


def _idle_spans(busy: list, ranges: list, top: int = 10) -> list:
    """[name, seconds] of the `top` program spans with the most idle time
    between device operations; a gap goes to the innermost span open at
    its middle (the ranges nest), "(no span)" where none is."""
    ranges = sorted(ranges)
    gaps = defaultdict(int)
    stack, i = [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "(no span)"] += s1 - e0
    best = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return [[n, v / 1e9] for n, v in best]
