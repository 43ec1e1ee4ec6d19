"""A model family brought entirely by files of its own (the toy of
benchmark/tests/toy): its pipeline module declares one neural check
against a float32 reference, one kernel kind in a roofline group of its
own, one FLOP census module, one fault and timings layers of its own, and
the harness runs it on the CPU with no file of its own naming it."""

import glob
import importlib
import json
import os
import sys
import time
import types

import pytest
import torch

from benchmark.faults import plant
from benchmark.harness import trace
from benchmark.harness.cell import run_loaded
from benchmark.metrics._timings import ms_per_frame

HERE = os.path.dirname(os.path.abspath(__file__))
MS = 1_000_000


@pytest.fixture
def toy(monkeypatch):
    """The toy's configuration and workload, its pipeline found by the
    name the configuration gives."""
    monkeypatch.setitem(sys.modules, "benchmark.pipelines.toy",
                        importlib.import_module("benchmark.tests.toy."
                                                "pipeline"))

    def load(name):
        with open(os.path.join(HERE, "toy", name)) as f:
            return json.load(f)
    return load("config.json"), load("workload.json")


def _run(cfg, wl, traced):
    return run_loaded(cfg, wl, 2 ** 31 + 11, 0.0, traced,
                      torch.device("cpu"), time.perf_counter())


def test_toy_family_runs_through_the_harness(toy, monkeypatch):
    cfg, wl = toy
    seen = []
    reduce = trace.reduce

    def kept(prof, wall_s, frames, kernel_calls, kernels):
        seen.extend(kernel_calls)
        return reduce(prof, wall_s, frames, kernel_calls, kernels)

    monkeypatch.setattr(trace, "reduce", kept)
    rec = _run(cfg, wl, traced=True)
    assert rec["correct"] is True
    checks = {c["name"]: c for c in rec["checks"]}
    assert list(checks) == ["feat_rel", "frames_solved"]
    assert checks["feat_rel"]["reads"] == "toy net, features"
    assert checks["frames_solved"]["reads"] == \
        "toy solve, cameras, fewest in a scene"
    assert 0 < checks["feat_rel"]["value"] <= 0.02
    # the window's one scene (a window of 0 s ends after it), one net
    # call: two products of 4 x 256 rows, 32 x 64
    assert rec["attempted"] == 1
    assert rec["model_flops"] == 2 * (2 * 4 * 256 * 32 * 64)
    # the profiled warm-up called the toy's kernel once, in its range
    assert seen == [("toymm", {"R": 4 * 256, "C": 32, "H": 64})]
    assert ms_per_frame(rec, "embed") > 0
    assert ms_per_frame(rec, "head") is not None


def test_toy_kernel_counts_in_its_own_roofline_group(toy):
    """A toy kernel call's range and the device operation it launched, on
    a hand-built event list, land in the group `toy` with the toy's
    bound; the toy's reader reads the share."""
    from benchmark.tests.toy import family, toy_roofline

    class Ev:
        def __init__(self, name, start, end, device=False, corr=0):
            self._n, self._s, self._e = name, start * MS, end * MS
            self._dev, self._c = device, corr

        def name(self):
            return self._n

        def device_type(self):
            return torch.autograd.DeviceType.CUDA if self._dev \
                else torch.autograd.DeviceType.CPU

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._e - self._s

        def correlation_id(self):
            return self._c

    events = [Ev("bench.kernel.0", 0, 10), Ev("cudaLaunchKernel", 1, 2,
                                               corr=1),
              Ev("toy_gemm", 3, 11, device=True, corr=1)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    shapes = {"R": 1024, "C": 32, "H": 64}
    out = trace.reduce(prof, 0.02, 4, [("toymm", shapes)], family.KERNELS)
    bound = family.mm_bound(shapes)
    assert out["kernels"] == {"toy": {"bound_s": bound, "device_s": 0.008,
                                      "calls": 1}}
    assert toy_roofline.read({"trace": out}) == \
        pytest.approx(100 * bound / 0.008)


def test_toy_fault_makes_the_run_incorrect(toy, monkeypatch):
    from benchmark.tests.toy import family, pipeline

    cfg, wl = toy
    install, reads = family.FAULTS["feat_scaled"]
    plant(pipeline.Pipeline, install, monkeypatch.setattr)
    rec = _run(cfg, wl, traced=False)
    assert rec["correct"] is False
    assert rec["readings"][reads["toy"]]["f32"] > 0.05


def test_no_harness_file_names_the_toy():
    for path in glob.glob(os.path.join(os.path.dirname(HERE), "harness",
                                       "*.py")):
        with open(path) as f:
            assert "toy" not in f.read().lower(), path
