"""The reduction of the program's trace (harness/program_trace.py) on a
hand-built event list that stands in for a profile, and the readers of
the metrics it feeds."""

import importlib

import pytest
import torch

from benchmark.harness import program_trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
MS = 1_000_000


class Ev:
    """What the reduction reads of a kineto event; times in ms."""

    def __init__(self, name, start, end, device=False, corr=0):
        self._n, self._s, self._d = name, int(start * MS), int((end - start)
                                                               * MS)
        self._dev, self._c = device, corr

    def name(self):
        return self._n

    def device_type(self):
        return CUDA if self._dev else CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c


def span(i, name, kind, parent, key=None, **counters):
    return {"name": name, "kind": kind, "key": key, "start_ns": 0,
            "end_ns": 0, "parent": parent, "call": 0, "counters": counters,
            "attrs": {}, "index": i}


# a video call: one window (its tracker call, an LM solve), a joint BA
SPANS = [
    span(0, "video.run", "call", None),
    span(1, "video.window", "stage", 0, "video.windows"),
    span(2, "video.track", "stage", 1, "video.track",
         **{"weights.cast_bytes": 5e5}),
    span(3, "coarse", "stage", 2, "coarse", **{"weights.cast_bytes": 1e6}),
    span(4, "ba.dense", "span", 1,
         **{"ba.iters_run": 8, "ba.iters_useful": 5}),
    span(5, "video.joint_ba", "stage", 0, "video.joint_ba"),
]
LAYERS = {"tracker": ["coarse"],
          "solve": ["video.windows", "-video.track", "video.joint_ba"]}
EVENTS = [
    # the program's ranges, host side, and the device-side copy of one
    Ev("vggsfm.video.run", 0, 100), Ev("vggsfm.video.window", 10, 60),
    Ev("vggsfm.video.track", 10, 30), Ev("vggsfm.coarse", 12, 28),
    Ev("vggsfm.ba.dense", 35, 55), Ev("vggsfm.video.joint_ba", 70, 90),
    Ev("vggsfm.video.window", 10, 60, device=True),
    Ev("bench.kernel.0", 12, 20, device=True),
    # launches and the kernels they launched
    Ev("cudaLaunchKernel", 11, 11.5, corr=1), Ev("k", 12, 20, True, 1),
    Ev("cudaLaunchKernel", 21, 21.5, corr=2), Ev("k", 22, 28, True, 2),
    Ev("cudaLaunchKernel", 35, 35.5, corr=3), Ev("k", 36, 40, True, 3),
    Ev("cudaLaunchKernel", 49, 49.5, corr=4), Ev("k", 50, 52, True, 4),
    Ev("cudaLaunchKernel", 71, 71.5, corr=5), Ev("k", 72, 88, True, 5),
    # waits: in the tracker's window call (subtracted from the solve), in
    # the LM solve, after the call; a blocking and an async copy
    Ev("cudaStreamSynchronize", 29, 29.5, corr=8),
    Ev("cudaStreamSynchronize", 41, 41.5, corr=9),
    Ev("cudaDeviceSynchronize", 95, 96, corr=10),
    Ev("cudaMemcpy", 53, 54, corr=6),
    Ev("Memcpy DtoH (Device -> Pageable)", 53, 54, True, 6),
    Ev("cudaMemcpyAsync", 56, 56.2, corr=7),
    Ev("Memcpy DtoH (Device -> Pageable)", 56, 57, True, 7),
    Ev("aten::mul", 34, 36),
]


def test_reduce_puts_idle_waits_and_launches_in_their_layer():
    """Idle time, waits and launches land in the layer whose stages hold
    them, the subtracted stage's taken out; the device-side copies of the
    ranges count as no device work; each idle gap goes to the innermost
    span open at its middle."""
    out = program_trace.reduce(EVENTS, SPANS, LAYERS, 8)
    tr, so = out["layers"]["tracker"], out["layers"]["solve"]
    # tracker: [12, 28], busy 14 of it; the launch at 21 (that at 11, of
    # the kernel at 12, was called before the stage began)
    assert tr == {"seconds": 0.016, "idle_s": 0.002, "syncs": 0,
                  "launches": 1, "cast_bytes": 1e6}
    # solve: [30, 60] + [70, 90], busy 4 + 2 + 1 + 1 + 16 of it; the sync
    # at 41 and the blocking copy at 53; the launches at 35, 49 and 71
    assert so["seconds"] == pytest.approx(0.050)
    assert so["idle_s"] == pytest.approx(0.026)
    assert (so["syncs"], so["launches"], so["cast_bytes"]) == (2, 3, 0)
    assert out["unit_s"] == pytest.approx(0.1)
    assert out["idle_s"] == pytest.approx(0.1 - 0.038)
    assert out["idle_in_stages_s"] == pytest.approx(0.070 - 0.038)
    assert out["counters"] == {"weights.cast_bytes": 1.5e6,
                               "ba.iters_run": 8, "ba.iters_useful": 5}
    got = {n: round(v * 1e3, 6) for n, v in out["idle_spans"]}
    assert got == {"video.run": 15, "ba.dense": 13, "video.window": 8,
                   "coarse": 2}
    assert [n for n, _ in out["idle_spans"]] == [
        "video.run", "ba.dense", "video.window", "coarse"]


def _record(program):
    return {"trace": {"busy_s": 1.0, "window_s": 2.0, "program": program},
            "breakdown": {}}


@pytest.mark.parametrize("name,want", [
    ("tracker_idle_ms_per_frame", 2.0 / 8),
    ("solve_idle_ms_per_frame", 26.0 / 8),
    ("solve_syncs_per_frame", 2 / 8),
    ("solve_launches_per_frame", 3 / 8),
    ("lm_useful_iter_share", 62.5),
    ("tracker_cast_mb_per_frame", 1.0 / 8),
])
def test_reader(name, want):
    mod = importlib.import_module(f"benchmark.metrics.{name}")
    rec = _record(program_trace.reduce(EVENTS, SPANS, LAYERS, 8))
    assert mod.read(rec) == pytest.approx(want)
    # no trace, and a program without the tracer (its pass gave None)
    assert mod.read({"scenes": []}) is None
    assert mod.read(_record(None)) is None


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """Where the program has no tracer, the pass runs nothing and the
    result line gets no `idle_spans`."""
    real = importlib.import_module

    def no_tracer(name, *a):
        if name == "vggsfm_tpu_torch.utils.trace":
            raise ModuleNotFoundError(name)
        return real(name, *a)

    monkeypatch.setattr(importlib, "import_module", no_tracer)
    rec = {"trace": {"busy_s": 1.0}, "breakdown": {}, "config": {},
           "workload": {}, "device": {"platform": "gpu"}}
    assert program_trace.read(rec) is None
    assert rec["breakdown"] == {} and rec["trace"]["program"] is None
