"""The LM loop's CUDA graph (vggsfm_tpu_torch/ba/lm.py `lm_loop`).

On the card, each solver's graphed loop against its eager loop on the
same inputs (the eager one forced by patching `_graphable`): the dense
solver runs the same kernels at the same shapes, so its outputs, cost
history and counters are bitwise equal; the sparse solver's `index_add_`
sums with atomics, so it is held to the card-vs-CPU bounds of
chip_smoke.py's `sparse_ba_agreement` (final cost within 1e-3 relative,
poses within 1e-2, points within 5e-2). Off the card, and under
`FlopCounterMode`, which must see every iteration's operations, the loop
stays eager: `ba.iters_graphed` 0, the results those of a plain call.

Imports nothing of JAX; the tests marked `cuda` skip without a GPU. On
the card: python -m pytest --noconftest tests/test_torch_lm_graph.py -q
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vggsfm_tpu_torch.ba import (
    BAConfig,
    SparseBAConfig,
    bundle_adjust,
    bundle_adjust_sparse,
)
from vggsfm_tpu_torch.ba import lm
from vggsfm_tpu_torch.utils import trace


def _scene(S=5, N=300, K=0, seed=0):
    """S views (focal 600, 640 x 480) of N points 6-10 in front, 0.5 px
    noise, 10% of the observations masked out; the cameras start with
    3 cm of translation noise and a 2% focal error, the points with 5 cm.
    Returns numpy (extr, intr, X, tracks, mask, extra)."""
    rng = np.random.default_rng(seed)
    f = 600.0
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (N, 3))
    extr = np.zeros((S, 3, 4))
    for s in range(S):
        a = 0.08 * s
        extr[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        extr[s, :, 3] = [-0.4 * s, 0.02 * s, 0.03 * s]
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], X) + extr[:, None, :, 3]
    tracks = cam[..., :2] / cam[..., 2:] * f + [320.0, 240.0]
    tracks += rng.normal(scale=0.5, size=tracks.shape)
    mask = rng.uniform(size=(S, N)) > 0.1
    intr = np.tile([[f * 1.02, 0, 320.0], [0, f * 1.02, 240.0], [0, 0, 1]],
                   (S, 1, 1))
    extr[1:, :, 3] += rng.normal(scale=0.03, size=(S - 1, 3))
    X = X + rng.normal(scale=0.05, size=X.shape)
    extra = rng.normal(scale=0.01, size=(S, K)) if K else None
    return extr, intr, X, tracks, mask, extra


def _t(a, dev, dtype=torch.float32):
    return None if a is None else torch.as_tensor(np.asarray(a)).to(dev,
                                                                    dtype)


# the dense cases: (scene keywords, BAConfig keywords, point_free rule)
DENSE = {
    "full": (dict(), dict(max_iterations=10), False),
    "pose_only_huber": (dict(), dict(max_iterations=9, pose_only=True,
                                     robust_loss="huber", loss_scale=2.0),
                        False),
    "shared_k1": (dict(K=1), dict(max_iterations=10, shared_intrinsics=True),
                  False),
    # a loose tolerance: `done` is set early and the loop leaves at a read
    "cauchy_frozen_points": (dict(), dict(max_iterations=12,
                                          robust_loss="cauchy",
                                          loss_scale=3.0,
                                          function_tolerance=1e-2), True),
}
# the eager-path test's case: `shared_k1`'s options on a small scene
SMALL = (dict(S=3, N=40, K=1), dict(max_iterations=4,
                                     shared_intrinsics=True), False)


def _dense(dev, spec):
    """One dense call, `spec` a (scene, BAConfig, point_free) triple."""
    scene_kw, cfg_kw, freeze = spec
    extr, intr, X, tracks, mask, extra = _scene(**scene_kw)
    point_free = None
    if freeze:  # every third point frozen
        point_free = _t(np.arange(X.shape[0]) % 3 != 0, dev, torch.bool)
    with trace.recording() as rec:
        out = bundle_adjust(_t(extr, dev), _t(intr, dev), _t(X, dev),
                            _t(tracks, dev), _t(mask, dev, torch.bool),
                            extra_params=_t(extra, dev),
                            point_free=point_free, cfg=BAConfig(**cfg_kw))
    return out, rec


def _sparse(dev):
    """The video joint BA's options at a small size: shared focal and
    radial term, Cauchy, 12 LM iterations x 30 PCG rounds."""
    extr, intr, X, tracks, mask, extra = _scene(S=6, N=400, K=1, seed=3)
    fr, pt = np.nonzero(mask)
    cfg = SparseBAConfig(max_iterations=12, shared_intrinsics=True,
                         cg_iters=30, robust_loss="cauchy", loss_scale=4.0)
    with trace.recording() as rec:
        out = bundle_adjust_sparse(
            _t(extr, dev), _t(intr, dev), _t(X, dev), _t(fr, dev, torch.long),
            _t(pt, dev, torch.long), _t(tracks[fr, pt], dev),
            torch.ones(len(fr), device=dev), extra_params=_t(extra, dev),
            cfg=cfg)
    return out, rec


def _counts(rec):
    return {k: rec.totals(k) for k in
            ("ba.iters_run", "ba.iters_useful", "ba.iters_graphed")}


def _eager(monkeypatch, fn, *args):
    with monkeypatch.context() as m:
        m.setattr(lm, "_graphable", lambda *a: False)
        return fn(*args)


def _flat(out):
    """A solver's outputs as a list of tensors (the info dict's last)."""
    *arrays, info = out
    return [a for a in arrays if a is not None] + [
        info["cost"], info["initial_cost"], info["final_cost"]]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DENSE))
def test_dense_graphed_loop_is_bitwise_the_eager_loop(case, monkeypatch):
    """Outputs, cost history and counters equal bit for bit; every
    iteration after the first of the call replayed from the graph."""
    _need_cuda()
    got, rec = _dense("cuda", DENSE[case])
    want, rec_e = _eager(monkeypatch, _dense, "cuda", DENSE[case])
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b)
    c, c_e = _counts(rec), _counts(rec_e)
    assert c["ba.iters_run"] == c_e["ba.iters_run"] > 1
    assert c["ba.iters_useful"] == c_e["ba.iters_useful"]
    assert c_e["ba.iters_graphed"] == 0
    assert c["ba.iters_graphed"] == c["ba.iters_run"] - 1  # one call
    if case == "cauchy_frozen_points":
        assert c["ba.iters_run"] < DENSE[case][1]["max_iterations"]


@pytest.mark.cuda
def test_sparse_graphed_loop_matches_the_eager_loop(monkeypatch):
    """Within the sparse solver's card bounds (the module docstring);
    the counters equal."""
    _need_cuda()
    got, rec = _sparse("cuda")
    want, rec_e = _eager(monkeypatch, _sparse, "cuda")
    gf, wf = float(got[4]["final_cost"]), float(want[4]["final_cost"])
    assert abs(gf - wf) <= 1e-3 * wf
    assert gf < 0.1 * float(want[4]["initial_cost"])
    assert float((got[0] - want[0]).abs().max()) <= 1e-2
    assert float((got[3] - want[3]).abs().max()) <= 5e-2
    c, c_e = _counts(rec), _counts(rec_e)
    assert c["ba.iters_run"] == c_e["ba.iters_run"] > 1
    assert c["ba.iters_graphed"] == c["ba.iters_run"] - 1
    assert c_e["ba.iters_graphed"] == 0


@pytest.mark.parametrize("where", [
    "cpu", "cpu_flop_counter",
    pytest.param("cuda_flop_counter", marks=pytest.mark.cuda)])
def test_lm_loop_stays_eager_off_the_card_and_under_the_flop_counter(
        where, monkeypatch):
    """A CPU call, and a call under `FlopCounterMode` (which counts the
    matrix products of every iteration), replay nothing from a graph and
    give the plain eager call's results bit for bit."""
    dev = where.split("_")[0]
    if dev == "cuda":
        _need_cuda()
    if where.endswith("flop_counter"):
        with FlopCounterMode(display=False) as fc:
            got, rec = _dense(dev, SMALL)
        assert fc.get_total_flops() > 0
    else:
        got, rec = _dense(dev, SMALL)
    want, _ = _eager(monkeypatch, _dense, dev, SMALL)
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b)
    c = _counts(rec)
    assert c["ba.iters_graphed"] == 0 and c["ba.iters_run"] > 1
