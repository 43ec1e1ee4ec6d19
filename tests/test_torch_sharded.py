"""The sharded pipeline step of the port (parallel/sharded.py) and the two
pieces only it reaches, the channel-first (`cfirst`) correlation pyramid
and the NHWC fine path of `refine_track`, against the JAX package on the
CPU, on the same weights (the port's seeded init, converted by the JAX
package's `convert_tracker`) and inputs.

Tolerances (f32): the pyramid exact; the correlation 1e-5 (f32 sums of
32 products in another order); `refine_track` 1e-2 px and its score
1e-3, as tests/test_torch_tracker.py holds the flat path; the NHWC path
against the port's flat path 1e-3 px (the fine encoder's last upsample
is one interpolation matrix on the flat path). The whole step on a
textured scene (`render_two_plane_scene`, 6 frames at 128 px, baseline
0.1, 64 Harris points; the JAX step's tracks triangulate to >= 8 valid
points and its BA cost is non-zero, both asserted): the tracks' share
within 1e-2 px >= 99%, the visibility 1e-3, the cameras 2e-3, the cost
5e-3 relative and the valid points within 1e-2 of their distance. The
step's BA (10 LM iterations, focal refined, only frame 0 fixed, so the
scale is free) is stopped before convergence on random-weight tracks:
one rounding moves it along its weak directions (tests/test_torch_ba.py
states the same of the solver alone), and the preliminary cameras' 128
RANSAC draws see near-ties. On the 4-frame scene at baseline 0.15 the
7e-5 px that part the two packages' tracks flip the preliminary's RANSAC
winner (its cameras 0.18 apart, 9 inlier flags), and the step's cost
then reads 0.56 in the port and 3.40 in JAX. The port on 2 gloo ranks
against the port on 1: the same valid points, tracks 1e-4 px, the
visibility 1e-4 (the matching init's products batched over half the
tracks round differently, and its cycle distance carries that), the
cameras 1e-3 (tests/test_multihost.py holds the JAX sharded solver to
its one-device solve at 2e-3), the valid points within 1e-3 of their
distance, the cost 1e-3 relative (the camera system's sums reassociated
over two ranks move the unconverged solve as one rounding does).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.models import TrackerPredictor as JTracker
from vggsfm_tpu.models import tracker as jtr
from vggsfm_tpu.models.convert import convert_tracker
from vggsfm_tpu.models.refine import refine_track as j_refine
from vggsfm_tpu.parallel import make_mesh as j_make_mesh
from vggsfm_tpu.parallel import sharded_track_and_reconstruct as j_step
from vggsfm_tpu.twoview.utils import generate_samples
from vggsfm_tpu_torch.models import tracker as ttr
from vggsfm_tpu_torch.models.refine import refine_track as t_refine
from vggsfm_tpu_torch.models.tracker import TrackerPredictor, init_tracker_
from vggsfm_tpu_torch.ops.triangulation import generate_ransac_pairs
from vggsfm_tpu_torch.parallel.mesh import make_mesh
from vggsfm_tpu_torch.parallel.sharded import (
    sharded_pipeline_step,
    sharded_track_and_reconstruct,
)
from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_cases as cases  # noqa: E402

S, R, N = 6, 128, 64


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: beside the other test workers, more threads
    only oversubscribe the cores. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _jax_params(tm):
    sd = {f"track_predictor.{k}": v.numpy()
          for k, v in tm.state_dict().items()}
    return {"params": convert_tracker(sd)}


# ------------------------------------------------------------ pyramid

def test_cfirst_pyramid_matches_jax(rng):
    """Exact: both sum each 2x2 window in row-major order. XLA sums a
    window whose output is a single cell as (a + b) + (c + d), so the 1x1
    level is held within one f32 ulp of its magnitude."""
    f = rng.normal(size=(1, 2, 13, 10, 4)).astype(np.float32)
    jp = jtr.build_corr_pyramid(jnp.asarray(f), 5, cfirst=True)
    tp = ttr.build_corr_pyramid(_t(f), 5, cfirst=True)
    assert len(tp) == len(jp) == 4  # stops once a level is < 2 wide
    for a, b in zip(tp, jp):
        assert a.shape == b.shape and a.is_contiguous()
        if a.shape[-2:] == (1, 1):
            b = np.asarray(b)
            _close(a, b, 0, np.finfo(np.float32).eps)
        else:
            _close(a, b, 0)


def test_corr_through_cfirst_matches_nhwc_and_jax(rng):
    """One track per map (the fine case): the correlation read from the
    channel-first levels in place equals the NHWC levels' and the JAX
    cfirst route's, tracks inside, on and across the borders."""
    B, Sn, H, W, C = 5, 3, 31, 31, 32
    fmaps = rng.normal(size=(B, Sn, H, W, C)).astype(np.float32)
    coords = rng.uniform(-3, 34, size=(B, Sn, 1, 2)).astype(np.float32)
    feats = rng.normal(size=(B, Sn, 1, C)).astype(np.float32)
    cf = ttr.build_corr_pyramid(_t(fmaps), 3, cfirst=True)
    nhwc = ttr.build_corr_pyramid(_t(fmaps), 3)
    out = ttr.corr_sample(cf, _t(coords), _t(feats), 3, cfirst=True)
    _close(out, ttr.corr_sample(nhwc, _t(coords), _t(feats), 3), 1e-5)
    jp = jtr.build_corr_pyramid(jnp.asarray(fmaps), 3, cfirst=True)
    ref = jtr.corr_sample(jp, jnp.asarray(coords), jnp.asarray(feats), 3,
                          cfirst=True)
    _close(out, ref, 1e-5)


def test_fine_predictor_takes_the_cfirst_pyramid_by_the_jax_rule(
        monkeypatch):
    """fine, N == 1, HH * WW <= 4096, C < 128, NHWC maps -> cfirst."""
    seen = []
    orig = ttr.build_corr_pyramid

    def spy(fmaps, levels, cfirst=False):
        seen.append(cfirst)
        return orig(fmaps, levels, cfirst)

    monkeypatch.setattr(ttr, "build_corr_pyramid", spy)
    tm = TrackerPredictor()
    fp = tm.fine_predictor.eval()
    maps = torch.randn(2, 3, 31, 31, 32)
    with torch.no_grad():
        fp(torch.full((2, 1, 2), 15.0), maps, iters=1)
        fp(torch.full((2, 2, 2), 15.0), maps, iters=1)  # N = 2: NHWC
    assert seen == [True, False]


# ------------------------------------------------------------ NHWC fine

@pytest.fixture(scope="module")
def scene():
    sc = render_two_plane_scene(num_frames=S, image_size=R, baseline=0.1)
    return sc


@pytest.fixture(scope="module")
def fine_weights():
    """Seeded weights whose fine flow head moves the tracks."""
    tm = TrackerPredictor()
    init_tracker_(tm, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        fh = tm.fine_predictor.updateformer.flow_head.weight
        fh.copy_(_t(rng.normal(scale=0.01, size=fh.shape).astype(
            np.float32)))
    return tm.eval(), _jax_params(tm)


def _t_refine(tm, images, coarse, flat):
    def fnet(x):
        return tm.fine_fnet(x, flat_cfirst=flat)

    def ftrack(q, f, iters, rf, mi, hw=None):
        return tm.fine_predictor(q, f, iters=iters, return_feat=rf,
                                 matching_init=mi, fmaps_flat_hw=hw)

    with torch.no_grad():
        return t_refine(_t(images), fnet, ftrack, _t(coarse), fine_iters=2,
                        flat_fnet=flat)


def test_refine_track_nhwc_matches_jax_and_the_flat_path(rng, scene,
                                                         fine_weights):
    """`refine_track(flat_fnet=False)` with the dsnt score (no NCC
    polish), 2 fine iterations, patches clamped at the frame edges."""
    tm, params = fine_weights
    images = scene["images"][None, :2]
    coarse = rng.uniform(10, 118, size=(1, 2, 8, 2)).astype(np.float32)
    coarse[0, 0, :2] = [[2.5, 3.0], [125.0, 120.5]]
    jm = JTracker()

    def j_run(p, im, tr):
        def fnet(x):
            return jm.apply(p, x, method="apply_fine_fnet")

        def ftrack(q, f, iters, rf, mi):
            return jm.apply(p, q, f, iters, rf, mi,
                            method="apply_fine_predictor")

        return j_refine(im, fnet, ftrack, tr, fine_iters=2, flat_fnet=False)

    jref, jscore = jax.jit(j_run)(params, images, coarse)
    ref, score = _t_refine(tm, images, coarse, flat=False)
    _close(ref, jref, 1e-2)
    _close(score, jscore, 1e-3)
    moved = np.abs(np.asarray(jref)[0, 1] - coarse[0, 1]).max()
    assert moved > 0.05, moved
    ref_flat, score_flat = _t_refine(tm, images, coarse, flat=True)
    _close(ref, ref_flat, 1e-3)
    _close(score, score_flat, 1e-4)


def test_refine_track_nhwc_refuses_flat_features():
    """flat_fnet=False with a flat channel-first fnet raises: the NHWC
    path never takes the flat branch quietly."""
    tm = TrackerPredictor().eval()
    images = torch.rand(1, 2, 64, 64, 3)
    coarse = torch.full((1, 2, 2, 2), 32.0)
    with pytest.raises(ValueError, match="NHWC"):
        with torch.no_grad():
            t_refine(images, lambda x: tm.fine_fnet(x, flat_cfirst=True),
                     None, coarse, flat_fnet=False)


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def step_runs(scene, tmp_path_factory):
    """The JAX step on a 2-device mesh, the port's on one rank (no process
    group) and on two gloo ranks, on the same weights, scene and draws."""
    tm = TrackerPredictor()
    init_tracker_(tm, torch.Generator().manual_seed(0))
    tm.eval()
    images = scene["images"][None]
    key_draws, _ = generate_samples(jax.random.PRNGKey(0), N, 128, 7)
    idx = _t(key_draws).long()

    jstep = j_step(JTracker(), j_make_mesh(2))
    jout = [np.asarray(x) for x in jstep(_jax_params(tm),
                                          jnp.asarray(images),
                                          max_query_pts=N)]
    one = sharded_track_and_reconstruct(tm, make_mesh(device="cpu"))
    out1 = one(images, max_query_pts=N, sample_idx=idx)
    inp = {"sd": tm.state_dict(), "images": _t(images), "n": N,
           "sample_idx": idx}
    two = cases.run_ranks("sharded_job", 2,
                          str(tmp_path_factory.mktemp("pg")), inp)
    return jout, (out1, one.valid_points), two, one


def test_sharded_step_matches_jax(step_runs, scene):
    jout, (out1, valid), _, one = step_runs
    jtracks, jvis, jpts, jextr, jcost = jout
    tracks, vis, pts, extr, cost = out1
    assert tracks.shape == (1, S, N, 2) and pts.shape == (N, 3)
    # the JAX step's scene condition: its tracks triangulate to >= 8 valid
    # points (the port's stage on the JAX tracks and cameras) and BA has
    # a non-zero cost
    assert float(jcost) > 0.0
    pre = one.preliminary(_t(jtracks), _t(jvis), R, R,
                          _t(generate_samples(jax.random.PRNGKey(0), N, 128,
                                              7)[0]).long())
    pairs = torch.as_tensor(generate_ransac_pairs(S, 8, 0)).long()
    _, inl, _ = one.triangulate(pre[0], pre[1], _t(jtracks)[0],
                                _t(jvis)[0], pre[2], pairs)
    assert int((inl >= 2).sum()) >= 8
    assert int(valid.sum()) >= 8

    d = np.abs(tracks.numpy() - jtracks).max(-1)
    assert (d <= 1e-2).mean() >= 0.99, d.max()
    _close(vis, jvis, 1e-3)
    _close(extr, jextr, 2e-3)
    assert abs(float(cost) - float(jcost)) <= 5e-3 * float(jcost)
    v = valid.numpy()
    dist = np.linalg.norm(pts.numpy()[v] - jpts[v], axis=-1)
    assert (dist <= 1e-2 * np.linalg.norm(jpts[v], axis=-1)).all(), \
        dist.max()


def test_sharded_step_two_ranks_match_one(step_runs):
    _, (out1, valid), two, _ = step_runs
    for r in two:
        assert torch.equal(r["valid"], valid)
        tracks, vis, pts, extr, cost = r["step"]
        _close(tracks, out1[0], 1e-4)
        _close(vis, out1[1], 1e-4)
        dist = np.linalg.norm((pts - out1[2])[valid].numpy(), axis=-1)
        assert (dist <= 1e-3 * np.linalg.norm(
            out1[2][valid].numpy(), axis=-1)).all(), dist.max()
        _close(extr, out1[3], 1e-3)
        _close(cost, out1[4], 0, 1e-3)
    for a, b in zip(two[0]["step"], two[1]["step"]):
        assert torch.equal(a, b)  # gathered or replicated on every rank


def test_sharded_pipeline_step_alias():
    mesh = make_mesh(device="cpu")
    tm = TrackerPredictor()
    step = sharded_pipeline_step(tm, mesh)
    assert step.tracker is tm and step.points.size == 1
    with pytest.raises(ValueError, match="do not split"):
        step.points.size = 2  # an odd N over two ranks of the points axis
        step(torch.rand(1, 2, 64, 64, 3), query_points=torch.rand(1, 3, 2))
