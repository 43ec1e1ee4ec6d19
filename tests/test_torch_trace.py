"""The port's tracer (vggsfm_tpu_torch/utils/trace.py) and the spans and
counters the pipeline records, on the CPU.

A tiny sparse run (3 frames of 64 px, 32 points, one coarse iteration,
no fine tracking, no robust refinement, the models seeded cheaply), the
dense and sparse LM solvers on a 3-view problem, the oracle video run of
tests/torch_video_cases.py, and one attention block's weights. Times are
compared exactly where both come from the same clock readings.
"""

import contextlib
import copy
import functools

import numpy as np
import pytest
import torch

from tests import torch_video_cases as cases
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch import video as tvideo
from vggsfm_tpu_torch.ba import BAConfig, SparseBAConfig, bundle_adjust
from vggsfm_tpu_torch.ba import bundle_adjust_sparse
from vggsfm_tpu_torch.ba.lm import _SYNC_EVERY
from vggsfm_tpu_torch.models.camera import CameraPredictor
from vggsfm_tpu_torch.models.layers import AttnBlock
from vggsfm_tpu_torch.utils import synth as tsynth
from vggsfm_tpu_torch.utils import trace

# the timings keys of the tiny run below, as the runner writes them
TINY_KEYS = {"camera_init", "fmaps", "query_points", "coarse", "tracking",
             "preliminary", "camera_choice", "sfm", "sfm.init_ba",
             "sfm.refine_poses_0", "sfm.triangulate_and_ba_0",
             "sfm.iterative_global_ba_0"}


def _seeded(module, generator):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


@contextlib.contextmanager
def _cheap_models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trun, "init_tracker_", _seeded)
        mp.setattr(trun, "CameraPredictor", functools.partial(
            CameraPredictor, hidden_size=64, num_heads=4, down_size=28,
            att_depth=2, trunk_depth=2))
        mp.setattr(trun, "init_camera_", _seeded)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """A tiny runner and its frames."""
    cfg = trun.RunnerConfig(precision="f32", query_frame_num=1,
                            max_query_pts=32, query_method="sift+harris",
                            min_vis_points=1, coarse_iters=1,
                            fine_tracking=False, robust_refine=0,
                            ba_iters=1)
    with _cheap_models():
        runner = trun.VGGSfMRunner(cfg, device="cpu")
        runner.camera
    runner.select_query_frames = lambda images: [1]
    images = tsynth.render_two_plane_scene(3, 64, seed=3)["images"]
    return runner, images


def test_recording_off_times_the_stages_and_records_nothing(tiny,
                                                           monkeypatch):
    """With recording off a run has the timings keys it always had and
    makes no span; `span`, `call` and `count` hand back one shared no-op
    and touch no state."""
    runner, images = tiny

    def no_span(*a, **k):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(trace, "_Span", no_span)
    out = runner.sparse_reconstruct(images)
    assert set(out["timings"]) == TINY_KEYS
    assert all(v > 0 for v in out["timings"].values())
    assert not trace.ON and trace._rec is None and not trace._open
    assert trace.span("a") is trace.call("b") is trace.span("c")
    trace.count("x", torch.ones(3))
    assert not trace._stages


def test_recorded_stages_nest_under_one_call(tiny):
    """With recording on, every span of the run carries the id of its one
    `sparse_reconstruct` call, the stages are its timings keys with the
    same seconds, and the sub-stages and spans nest where they run."""
    runner, images = tiny
    with trace.recording() as rec:
        out = runner.sparse_reconstruct(images)
    assert not trace.ON
    spans = rec.spans
    calls = [s for s in spans if s["kind"] == "call"]
    assert [c["name"] for c in calls] == ["sparse_reconstruct"]
    assert {s["call"] for s in spans} == {calls[0]["call"]}
    assert all(s["parent"] is not None for s in spans[1:])
    stages = [s for s in spans if s["kind"] == "stage"]
    assert {s["name"] for s in stages} == set(out["timings"]) == TINY_KEYS
    for key, seconds in out["timings"].items():
        assert sum(s["end_ns"] - s["start_ns"] for s in stages
                   if s["key"] == key) / 1e9 == pytest.approx(seconds)

    def parent(s):
        return spans[s["parent"]]["name"]

    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
        if s["name"] in ("query_points", "coarse"):
            assert parent(s) == "tracking"
        if s["name"].startswith("sfm."):
            assert parent(s) == "sfm"
        if s["name"].startswith("preliminary."):
            assert parent(s) == "preliminary"
        if s["name"] == "ba.iter":
            assert parent(s) == "ba.dense"
    names = {s["name"] for s in spans}
    assert {"preliminary.sample", "preliminary.score", "preliminary.refine",
            "preliminary.pose", "ba.dense", "ba.iter"} <= names
    assert 0 < rec.totals("preliminary.inliers") \
        <= rec.totals("preliminary.valid")
    assert rec.totals("ba.iters_useful") <= rec.totals("ba.iters_run") \
        == sum(s["name"] == "ba.iter" for s in spans)


def _views(S=3, N=30, seed=0):
    """S views of N points, 0.3 px noise, the cameras and points
    perturbed."""
    rng = np.random.default_rng(seed)
    f, W, H = 300.0, 320, 240
    X = rng.uniform([-1, -1, 5], [1, 1, 7], (N, 3))
    extr = np.zeros((S, 3, 4))
    extr[:, :, :3] = np.eye(3)
    extr[:, 0, 3] = -0.3 * np.arange(S)
    cam = X[None] + extr[:, None, :, 3]
    uv = cam[..., :2] / cam[..., 2:] * f + [W / 2, H / 2]
    uv += rng.normal(scale=0.3, size=uv.shape)
    intr = np.tile([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], (S, 1, 1))
    extr[1:, :, 3] += rng.normal(scale=0.02, size=(S - 1, 3))
    X = X + rng.normal(scale=0.02, size=X.shape)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    return t(extr), t(intr), t(X), t(uv)


def _solve(solver, **cfg):
    extr, intr, X, uv = _views()
    S, N = uv.shape[:2]
    if solver == "dense":
        bundle_adjust(extr, intr, X, uv, torch.ones(S, N, dtype=torch.bool),
                      cfg=BAConfig(**cfg))
    else:
        fr, pt = torch.meshgrid(torch.arange(S), torch.arange(N),
                                indexing="ij")
        fr, pt = fr.reshape(-1), pt.reshape(-1)
        bundle_adjust_sparse(extr, intr, X, fr, pt, uv[fr, pt],
                             torch.ones(len(fr)), cfg=SparseBAConfig(**cfg))


@pytest.mark.parametrize("solver", ["dense", "sparse"])
@pytest.mark.parametrize("cfg,useful,run", [
    # `done` set in the first iteration: the loop runs on to the host's
    # first read of the flag
    (dict(function_tolerance=1e9, max_iterations=10), 1, _SYNC_EVERY),
    (dict(function_tolerance=1e9, max_iterations=3), 1, 3),
    # never set: every iteration is useful
    (dict(function_tolerance=0.0, lambda_max=1e30, max_iterations=6), 6, 6),
])
def test_lm_counts_its_iterations(solver, cfg, useful, run):
    """`ba.iters_run` is the iterations the loop ran (its `ba.iter` spans),
    `ba.iters_useful` the index of the first iteration that began with
    `done` set (all of them where none did), both on the solver's span;
    on the CPU none is replayed from a graph (`ba.iters_graphed` 0)."""
    with trace.recording() as rec:
        _solve(solver, **cfg)
    top = [s for s in rec.spans if s["parent"] is None]
    assert [s["name"] for s in top] == [f"ba.{solver}"]
    iters = [s for s in rec.spans if s["name"] == "ba.iter"]
    assert all(s["parent"] == top[0]["index"] for s in iters)
    assert top[0]["counters"] == {"ba.iters_run": run,
                                  "ba.iters_useful": useful,
                                  "ba.iters_graphed": 0}
    assert len(iters) == run


@pytest.mark.parametrize("module_dtype,compute_dtype,per_element", [
    (torch.bfloat16, torch.bfloat16, 2),  # one cast, to bf16
    (torch.bfloat16, torch.float32, 2 + 4),  # rounded to bf16, then f32
    (torch.float32, torch.float32, 0),  # no cast
])
def test_cast_bytes_of_one_blocks_packed_weights(module_dtype, compute_dtype,
                                                 per_element):
    """`weights.cast_bytes` counts the bytes the casts of one block's
    `packed()` calls write, on the innermost span."""
    block = AttnBlock(32, 4, dtype=module_dtype)
    with trace.recording() as rec, trace.span("block"):
        out = block.attn.packed(compute_dtype) \
            + block.mlp.packed(compute_dtype)
    n = sum(p.numel() for p in block.parameters())
    assert sum(t.numel() for t in out) == n
    assert rec.spans[0]["counters"].get("weights.cast_bytes", 0) \
        == per_element * n
    if compute_dtype == module_dtype == torch.bfloat16:
        assert rec.totals("weights.cast_bytes") == sum(
            t.numel() * t.element_size() for t in out)


def test_video_window_spans_rebuild_windows(tiny):
    """On the oracle video run the `video.window` stages (timings key
    `video.windows`) rebuild `VideoRunner.windows`: their notes, their
    seconds and their tracker seconds; each window holds its `video.pnp`
    span and all spans carry the `video.run` call's id. (The oracle
    replaces every use of the sparse runner's models: a copy of the tiny
    runner serves.)"""
    _, vcfg = cases.configs((trun, tvideo))
    sc = cases.make_scene(T=8)
    runner = tvideo.VideoRunner(copy.copy(tiny[0]), vcfg)
    cases.install_oracle(runner, sc)
    with trace.recording() as rec:
        runner.run(sc["video"])
    spans = rec.spans
    assert spans[0]["name"] == "video.run" and spans[0]["kind"] == "call"
    assert {s["call"] for s in spans} == {spans[0]["call"]}

    def below(i, key):
        return sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["key"] == key and _inside(spans, s, i)) / 1e9

    wins = [s for s in spans if s["name"] == "video.window"]
    assert {s["key"] for s in wins} == {"video.windows"}
    rebuilt = [{**s["attrs"], "seconds": (s["end_ns"] - s["start_ns"]) / 1e9,
                "track_seconds": below(s["index"], "video.track")}
               for s in wins]
    assert len(runner.windows) == len(rebuilt) >= 2
    for got, want in zip(rebuilt, runner.windows):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k]), k
    assert sum(w["seconds"] for w in runner.windows) == pytest.approx(
        runner.timings["video.windows"])
    pnp = [s for s in spans if s["name"] == "video.pnp"]
    assert pnp and all(spans[s["parent"]]["name"] == "video.window"
                       for s in pnp)


def _inside(spans, s, i):
    """Whether span `s` lies below the span at index `i`."""
    while s["parent"] is not None:
        if s["parent"] == i:
            return True
        s = spans[s["parent"]]
    return False


def test_profiler_sees_the_ranges_only_while_recording(monkeypatch):
    """While a torch.profiler is active, a solve makes no profiler range
    with the tracer off (a profile of the port is what it was before the
    tracer) and one range `vggsfm.<name>` per recorded span with it on.
    The profiler's flag and range are stood in for: the flag is what the
    tracer reads, the range what it opens."""
    made = []

    class Range:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace._profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    _solve("dense", max_iterations=2)
    assert made == []
    with trace.recording() as rec:
        _solve("dense", max_iterations=2)
    assert made == [trace.RANGE_PREFIX + s["name"] for s in rec.spans]
    assert [s["name"] for s in rec.spans] == ["ba.dense", "ba.iter",
                                             "ba.iter"]
