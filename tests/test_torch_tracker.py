"""The port's tracker against the JAX package's, on the same inputs and
the same weights (JAX params carried over by `tracker_state_dict_from_jax`,
flow heads made non-zero so the formers move the tracks).

Tolerances (f32, CPU): 1e-5 absolute for the correlation and sampling
functions (short f32 sums of O(1) values); 1e-4 for the update former
(a deep stack of f32 matmuls summed in another order); 1e-2 px for tracks
after the iterative tracker, where per-iteration differences of ~1e-5 feed
the next iteration's correlation lookups. Inputs are continuous random
values, so argmax steps see no exact ties; where a smooth map puts
near-ties under an argmax, both sides get the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.models import TrackerPredictor as JTracker
from vggsfm_tpu.models import tracker as jtr
from vggsfm_tpu.models.refine import ncc_subpixel_refine as j_ncc
from vggsfm_tpu.models.refine import refine_track as j_refine
from vggsfm_tpu_torch.models import convert as cv
from vggsfm_tpu_torch.models import tracker as ttr
from vggsfm_tpu_torch.models.refine import extract_patches as t_extract
from vggsfm_tpu_torch.models.refine import ncc_subpixel_refine as t_ncc
from vggsfm_tpu_torch.models.refine import refine_track as t_refine


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


# ------------------------------------------------------------ correlation

def test_corr_pyramid(rng):
    f = rng.normal(size=(1, 2, 13, 10, 4)).astype(np.float32)
    jp = jtr.build_corr_pyramid(jnp.asarray(f), 5)
    tp = ttr.build_corr_pyramid(_t(f), 5)
    assert len(tp) == len(jp) == 4  # stops once a level is < 2 wide
    for a, b in zip(tp, jp):
        _close(a, b, 1e-6)
    flat = f.transpose(0, 1, 4, 2, 3).reshape(1, 2, 4, 130)
    jl, jh = jtr.build_corr_pyramid_flat(jnp.asarray(flat), (13, 10), 5)
    tl, th = ttr.build_corr_pyramid_flat(_t(flat), (13, 10), 5)
    assert th == jh
    for a, b in zip(tl, jl):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("N", [70, 10])
def test_corr_sample_both_branches(rng, N):
    """The JAX function's two NHWC routes (N >= 64: full correlation map +
    windows; N < 64: the gather) against the port's kernel route (on the
    CPU its plain version, a gather). Tracks sit inside, on and across the
    map borders, so the zero-padded taps (half-in corners included) are
    exercised."""
    B, S, H, W, C = 1, 2, 12, 14, 16
    fmaps = rng.normal(size=(B, S, H, W, C)).astype(np.float32)
    coords = rng.uniform(-3, 16, size=(B, S, N, 2)).astype(np.float32)
    feats = rng.normal(size=(B, S, N, C)).astype(np.float32)
    jp = jtr.build_corr_pyramid(jnp.asarray(fmaps), 3)
    ref = jtr.corr_sample(jp, jnp.asarray(coords), jnp.asarray(feats), 3)
    tp = ttr.build_corr_pyramid(_t(fmaps), 3)
    _close(ttr.corr_sample(tp, _t(coords), _t(feats), 3), ref, 1e-5)


def test_corr_sample_few_tracks_reaches_the_kernel_off_cpu():
    """Off the CPU the correlation goes to the kernel's wrapper, not to a
    plain stand-in: without a GPU its build raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    pyr = [torch.empty(1, 2, 8, 8, 16, device="meta")]
    with pytest.raises(RuntimeError, match="nvcc"):
        ttr.corr_sample(pyr, torch.empty(1, 2, 10, 2, device="meta"),
                        torch.empty(1, 2, 10, 16, device="meta"), 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flat_correlation_in_both_dtypes(rng, dtype):
    """The fine path's flat channel-first correlation, one track per
    patch over 3 levels (15^2, 7^2, 3^2), against `jtr.corr_sample_flat` on
    the same pyramid. f32: 1e-5. bf16: the JAX function rounds its
    full correlation map and the window's combine to bf16, the port once at
    the end: tests/test_torch_corr.py `bf16_bound` (2^-5 of the four
    cells' sum of |products| / sqrt(C))."""
    from tests.test_torch_corr import bf16_bound

    B, S, C, H, W, N, r = 5, 4, 32, 15, 15, 1, 3
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(B, S, C, H * W))).astype(jdt)
    coords = rng.uniform(-1, 16, size=(B, S, N, 2)).astype(np.float32)
    jf = jnp.asarray(rng.normal(size=(B, S, N, C))).astype(jdt)
    jl, jh = jtr.build_corr_pyramid_flat(x, (H, W), 3)
    ref = _t(np.asarray(jtr.corr_sample_flat(jl, jh, jnp.asarray(coords),
                                             jf, r)).astype(np.float32))
    tl = [_t(np.asarray(lv).astype(np.float32)).to(dtype) for lv in jl]
    tf = _t(np.asarray(jf).astype(np.float32)).to(dtype)
    out = ttr.corr_sample_flat(tl, jh, _t(coords), tf, r)
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref).abs().reshape(B * S, N, -1)
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
        return
    maps = [lv.reshape(B * S, C, h, w).permute(0, 2, 3, 1)
            for lv, (h, w) in zip(tl, jh)]
    bound = bf16_bound(maps, _t(coords).reshape(B * S, N, 2),
                       tf.reshape(B * S, N, C), r)
    assert bool((err <= bound).all()), float((err / bound).max())


def test_flat_correlation_and_sampling(rng):
    B, S, C, H, W, N = 3, 4, 8, 15, 15, 1
    x = rng.normal(size=(B, S, C, H * W)).astype(np.float32)
    coords = rng.uniform(-1, 16, size=(B, S, N, 2)).astype(np.float32)
    feats = rng.normal(size=(B, S, N, C)).astype(np.float32)
    jl, jh = jtr.build_corr_pyramid_flat(jnp.asarray(x), (H, W), 3)
    tl, th = ttr.build_corr_pyramid_flat(_t(x), (H, W), 3)
    _close(ttr.corr_sample_flat(tl, th, _t(coords), _t(feats), 3),
           jtr.corr_sample_flat(jl, jh, jnp.asarray(coords),
                                jnp.asarray(feats), 3), 1e-5)
    qp = rng.uniform(-1, 16, size=(B, 5, 2)).astype(np.float32)
    _close(ttr._sample_flat(_t(x[:, 0]), _t(qp), (H, W)),
           jtr._sample_flat(jnp.asarray(x[:, 0]), jnp.asarray(qp), (H, W)),
           1e-5)
    qf = rng.normal(size=(B, 5, C)).astype(np.float32)
    _close(ttr._global_match_flat(_t(x), _t(qf), _t(qp), (H, W)),
           jtr._global_match_flat(jnp.asarray(x), jnp.asarray(qf),
                                  jnp.asarray(qp), (H, W)), 1e-5)


@pytest.mark.parametrize("cycle", [False, True])
def test_global_match_coords(rng, cycle):
    B, S, H, W, C, N = 1, 3, 10, 12, 16, 9
    fmaps = rng.normal(size=(B, S, H, W, C)).astype(np.float32)
    qf = rng.normal(size=(B, N, C)).astype(np.float32)
    qp = rng.uniform(0, 9, size=(B, N, 2)).astype(np.float32)
    ref = jtr.global_match_coords(jnp.asarray(fmaps), jnp.asarray(qf),
                                  jnp.asarray(qp), cycle=cycle)
    out = ttr.global_match_coords(_t(fmaps), _t(qf), _t(qp), cycle=cycle)
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
        else:
            _close(a, b, 1e-5)


# ------------------------------------------------------- modules, slice

def test_update_former(rng):
    """2 time + 2 space layers, 4 virtual tracks, narrow width; the time
    blocks take the whole-block op, the cross blocks fused_ln_mlp."""
    B, N, T, Din = 1, 6, 5, 20
    jm = jtr.EfficientUpdateFormer(space_depth=2, time_depth=2,
                                   hidden_size=32, num_heads=4,
                                   output_dim=10, num_virtual_tracks=4)
    x = rng.normal(size=(B, N, T, Din)).astype(np.float32)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    p["params"]["flow_head"]["kernel"] = (
        rng.normal(size=(32, 10)).astype(np.float32) * 0.1)
    sd = {}
    cv._update_former(sd, "m", p["params"])
    tm = ttr.EfficientUpdateFormer(space_depth=2, time_depth=2,
                                   input_dim=Din, hidden_size=32,
                                   num_heads=4, output_dim=10,
                                   num_virtual_tracks=4)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    _close(tm(_t(x)), jm.apply(p, x), 1e-4)


@pytest.fixture(scope="module")
def tracker_pair():
    """JAX tracker params (random init, non-zero flow heads) and the port
    loaded with the same weights."""
    rng = np.random.default_rng(1)
    jm = JTracker()
    im = jnp.zeros((1, 2, 64, 64, 3), jnp.float32)
    q = jnp.full((1, 4, 2), 20.0, jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k, i, qq: jm.init(k, i, qq, method="init_all"))(
            jax.random.PRNGKey(0), im, q))
    for pred, hid, out in (("coarse_predictor", 384, 130),
                           ("fine_predictor", 256, 34)):
        params["params"][pred]["updateformer"]["flow_head"]["kernel"] = (
            rng.normal(size=(hid, out)).astype(np.float32) * 0.01)
    tm = ttr.TrackerPredictor()
    tm.load_state_dict(cv.tracker_state_dict_from_jax(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def scene():
    """Two smooth-textured 128^2 frames, the second shifted by (3, 2);
    ~16 px texture cells, which random-weight features can match."""
    rng = np.random.default_rng(2)
    tex = rng.uniform(size=(9, 9, 3)).astype(np.float32)
    big = np.asarray(jax.image.resize(tex, (140, 140, 3), "cubic"))
    frames = np.stack([big[:128, :128], big[2:130, 3:131]])[None]
    return np.clip(frames, 0, 1)


@pytest.mark.parametrize("N,minit,iters", [(32, False, 2), (64, False, 2),
                                           (64, True, 1)])
def test_tracker_coarse_matches_jax(rng, tracker_pair, scene, N, minit,
                                    iters):
    """Full-width TrackerPredictor, coarse: N = 32 runs the gather
    correlation branch, N = 64 the full-map branch; with matching init
    the cycle-consistency visibility too. The matching init leaves ~1e-6
    px differences in the start coordinates, which the flow embedding's
    frequencies (up to ~1000 rad per cell) turn into ~1e-3 input changes:
    ~5e-4 px after one iteration, ~40x more per further iteration with
    random weights, so that case runs one iteration."""
    jm, params, tm = tracker_pair
    qp = rng.uniform(16, 112, size=(1, N, 2)).astype(np.float32)
    fmaps = None
    if minit:
        # the argmax of the matching init sits on near-ties between
        # neighbouring cells of a smooth map; feed both trackers the same
        # feature maps (the encoders are compared without matching init)
        fmaps = jax.jit(lambda p, i: jm.apply(
            p, i, method="process_images_to_fmaps"))(params, scene)
    jtrack, jvis = jax.jit(lambda p, i, q, f: jm.apply(
        p, i, q, fmaps=f, coarse_iters=iters, matching_init=minit,
        matching_vis=minit))(params, scene, qp, fmaps)
    with torch.no_grad():
        track, vis = tm(_t(scene), _t(qp),
                        fmaps=None if fmaps is None else _t(fmaps),
                        coarse_iters=iters, matching_init=minit,
                        matching_vis=minit)
    _close(track, jtrack, 1e-2)
    _close(vis, jvis, 1e-3)
    assert np.abs(np.asarray(jtrack)[:, 1] - qp).max() > 0.05  # tracks moved


def test_refine_track_matches_jax(rng, tracker_pair, scene):
    """Fine refinement on the flat channel-first path, 2 fine iterations,
    with the dsnt confidence score."""
    jm, params, tm = tracker_pair
    N = 16
    coarse = rng.uniform(10, 118, size=(1, 2, N, 2)).astype(np.float32)
    coarse[0, 0, :2] = [[2.5, 3.0], [125.0, 120.5]]  # patch clamped at edges

    def j_run(p, im, tr):
        def fnet(x):
            return jm.apply(p, x, True, method="apply_fine_fnet")

        def ftrack(q, f, iters, rf, mi, hw=None):
            return jm.apply(p, q, f, iters, rf, mi, hw,
                            method="apply_fine_predictor")

        return j_refine(im, fnet, ftrack, tr, fine_iters=2, flat_fnet=True)

    jref, jscore = jax.jit(j_run)(params, scene, coarse)

    def fnet(x):
        return tm.fine_fnet(x, flat_cfirst=True)

    def ftrack(q, f, iters, rf, mi, hw=None):
        return tm.fine_predictor(q, f, iters=iters, return_feat=rf,
                                 matching_init=mi, fmaps_flat_hw=hw)

    with torch.no_grad():
        ref, score = t_refine(_t(scene), fnet, ftrack, _t(coarse),
                              fine_iters=2)
    _close(ref, jref, 1e-2)
    _close(score, jscore, 1e-3)


def test_extract_patches_and_ncc(rng, scene):
    centers = rng.uniform(-2, 130, size=(1, 2, 12, 2)).astype(np.float32)
    from vggsfm_tpu.models.refine import extract_patches as j_extract

    jp, jtl = j_extract(jnp.asarray(scene), jnp.asarray(centers), 15)
    tp, ttl = t_extract(_t(scene), _t(centers), 15)
    _close(tp, jp, 0)
    np.testing.assert_array_equal(ttl.numpy(), np.asarray(jtl))
    # NCC polish: estimates near the truth, some near the borders (the
    # search region shifts inside the frame and re-centres)
    truth = rng.uniform(12, 116, size=(1, 12, 2)).astype(np.float32)
    coords = np.stack([truth, truth - np.float32([3, 2])], axis=1)
    coords = coords + rng.normal(size=coords.shape).astype(np.float32)
    coords[0, 1, :2] = [[1.2, 2.7], [126.4, 125.1]]
    jout, jconf = j_ncc(jnp.asarray(scene), jnp.asarray(coords))
    tout, tconf = t_ncc(_t(scene), _t(coords))
    # the parabola fit divides by the NCC peak's curvature, small on a
    # smooth texture (neighbours within ~1e-3 of the peak): f32 rounding
    # of ~1e-7 in the NCC values moves the sub-pixel offset by ~1e-4 px
    _close(tout, jout, 1e-3)
    _close(tconf, jconf, 1e-4)


def test_ncc_border_tracks_off_the_tiled_frame_shape(rng):
    """At a frame shape outside the JAX package's tiled branch
    (W % 128 != 0) each search tap is clamped to the frame, not the region
    shifted inside it: tracks within 6 px of every border match JAX."""
    H, W = 120, 100
    tex = rng.uniform(size=(9, 9, 3)).astype(np.float32)
    big = np.asarray(jax.image.resize(tex, (132, 112, 3), "cubic"))
    scene = np.clip(np.stack([big[:H, :W], big[2:H + 2, 3:W + 3]])[None],
                    0, 1)
    truth = np.float32([[3.5, 60.2], [96.3, 40.7], [50.1, 2.4],
                        [30.8, 116.6], [5.2, 4.1], [95.5, 117.3],
                        [2.2, 100.9], [97.9, 1.6]])[None]
    coords = np.stack([truth, truth - np.float32([3, 2])], axis=1)
    coords = coords + rng.normal(size=coords.shape).astype(np.float32) * 0.7
    coords[:, 0] = truth
    jout, jconf = j_ncc(jnp.asarray(scene), jnp.asarray(coords))
    tout, tconf = t_ncc(_t(scene), _t(coords))
    _close(tout, jout, 1e-3)  # as test_extract_patches_and_ncc
    _close(tconf, jconf, 1e-4)
