"""The port's SfM solve against the JAX package's, on the same seeded
scenes, on the CPU: the LORANSAC track triangulation and point filter
(ops/triangulation.py), PnP (twoview/pnp.py), pose refinement
(sfm/refine.py), the solve itself (sfm/triangulator.py) and the gauge
normalization (sfm/normalize.py).

The random draws of the JAX package come from `jax.random`, which torch
cannot reproduce: the port is handed the draws the JAX calls made (PnP
minimal sets, `draws`). The ransac pair schedule is numpy in both.

Tolerances, each stated where it is used: exact where the arithmetic is
the same (schedules, medians, masks of well-separated values); 1e-4 to
1e-3 relative on f32 geometry summed in another order; masks equal
except for observations within rounding of their threshold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.geometry.metrics import pose_auc30 as jauc30
from vggsfm_tpu.ops import triangulation as jtri
from vggsfm_tpu.sfm import normalize as jnorm
from vggsfm_tpu.sfm import refine as jref
from vggsfm_tpu.sfm import triangulator as jsfm
from vggsfm_tpu.twoview import pnp as jpnp
from vggsfm_tpu.twoview import utils as jtu
from vggsfm_tpu_torch.geometry.cameras import project_points
from vggsfm_tpu_torch.geometry.metrics import pose_auc30 as tauc30
from vggsfm_tpu_torch.geometry.metrics import relative_pose_errors
from vggsfm_tpu_torch.ops import triangulation as ttri
from vggsfm_tpu_torch.sfm import normalize as tnorm
from vggsfm_tpu_torch.sfm import refine as tref
from vggsfm_tpu_torch.sfm import triangulator as tsfm
from vggsfm_tpu_torch.twoview import pnp as tpnp

W, H = 640, 480


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_scene(seed, S=4, N=150, noise_px=0.3, outlier_frac=0.1,
               focal=None):
    """tests/test_sfm.py's scene: S cameras on an arc (focal max(W, H),
    or `focal`) around N points 6-10 in front, relative to frame 0,
    `noise_px` pixel noise, and in each frame >= 1 a random
    `outlier_frac` of the observations moved 30-120 px. Returns f32 (extrinsics (S, 3, 4),
    intrinsics (S, 3, 3), points (N, 3), tracks (S, N, 2), vis (S, N))."""
    rng = np.random.default_rng(seed)
    f = float(focal or max(W, H))
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(N, 3))
    extr = np.zeros((S, 3, 4))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    for s in range(S):
        a = 0.12 * (s - S / 2)
        extr[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        extr[s, :, 3] = [0.5 * (s - S / 2), 0.03 * s, 0.05 * s]
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], X) + extr[:, None, :, 3]
    uv = np.einsum("ij,snj->sni", K, cam)
    tracks = uv[..., :2] / uv[..., 2:]
    R0, t0 = extr[0, :, :3].copy(), extr[0, :, 3].copy()
    for s in range(S):
        extr[s, :, :3] = extr[s, :, :3] @ R0.T
        extr[s, :, 3] = extr[s, :, 3] - extr[s, :, :3] @ t0
    X = (R0 @ X.T).T + t0
    tracks += rng.normal(scale=noise_px, size=tracks.shape)
    n_out = int(outlier_frac * N)
    for s in range(1, S):
        sel = rng.choice(N, n_out, replace=False)
        tracks[s, sel] += rng.uniform(30, 120, size=(n_out, 2))
    intr = np.tile(K, (S, 1, 1))
    vis = np.ones((S, N))
    return [a.astype(np.float32) for a in (extr, intr, X, tracks, vis)]


def _jax_pnp_draws(seed, N):
    """The JAX package's PnP draws for `PRNGKey(seed)` over N points."""
    key = jax.random.PRNGKey(seed)
    sub = None
    if N > tref.PNP_CAP:
        sub = _t(jax.random.permutation(jax.random.fold_in(key, 1),
                                        N)[:tref.PNP_CAP]).long()
    idx, _ = jtu.generate_samples(key, min(N, tref.PNP_CAP), tref.PNP_ITERS,
                                  6)
    return sub, _t(idx).long()


def _rot_err_deg(a, b):
    Ra, Rb = torch.as_tensor(np.array(a))[..., :3], b[..., :3]
    cos = ((Ra * Rb).sum((-2, -1)) - 1) / 2
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1, 1)))


# ------------------------------------------------------------ triangulation

@pytest.mark.parametrize("S,iters", [(4, 256), (6, 5), (8, 28)])
def test_generate_ransac_pairs_is_the_jax_packages(S, iters):
    np.testing.assert_array_equal(
        ttri.generate_ransac_pairs(S, iters, seed=3),
        jtri.generate_ransac_pairs(S, iters, seed=3))


def test_normalized_angular_error_and_indicator():
    """Angular errors within 1e-6 rad; the indicator within 1e-6 and the
    inlier counts and masks equal (no error lies within 1e-4 of the
    threshold)."""
    rng = np.random.default_rng(0)
    extr, _, X, tracks, _ = make_scene(0, S=4, N=30)
    tn = (tracks - np.array([W / 2, H / 2])) / max(W, H)
    cand = (X[:, None] + rng.normal(scale=0.02, size=(30, 5, 3))).astype(
        np.float32)
    tn_nt = np.swapaxes(tn, 0, 1).astype(np.float32)
    e_t = ttri.normalized_angular_error(_t(cand), _t(tn_nt), _t(extr))
    e_j = np.asarray(jtri.normalized_angular_error(
        jnp.asarray(cand), jnp.asarray(tn_nt), jnp.asarray(extr)))
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=0, atol=1e-6)
    thr = 2.0 * math.pi / 180
    assert np.abs(e_j - thr).min() > 1e-4
    out_t = ttri._residual_indicator(_t(e_j), thr, 2 * math.pi)
    out_j = jtri._residual_indicator(jnp.asarray(e_j), thr, 2 * math.pi)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=0, atol=1e-6)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_local_refine_takes_the_lower_index_among_tied_counts():
    """Every candidate of a track ties on its inlier count: the round
    must refine the same candidates as `jax.lax.top_k` (the lower
    indices), so the refined points agree (within 1e-4 relative) and so
    do their angular errors (within 1e-3 rad: f32 arccos resolves angles
    near 0 to ~3.5e-4 rad)."""
    extr, _, _, tracks, _ = make_scene(1, S=5, N=20)
    tn = np.swapaxes((tracks - np.array([W / 2, H / 2])) / max(W, H), 0, 1)
    tn = tn.astype(np.float32)
    N, S = tn.shape[:2]
    rng = np.random.default_rng(1)
    # 12 candidates, every one with 3 inliers, on different frames
    mask = np.zeros((N, 12, S), bool)
    for n in range(N):
        for k in range(12):
            mask[n, k, rng.choice(S, 3, replace=False)] = True
    inv = np.zeros((N, S), bool)
    p_t, e_t = ttri._local_refine(_t(tn), _t(extr), _t(mask), 4, 1.5,
                                  _t(inv))
    p_j, e_j = jax.jit(jtri._local_refine, static_argnums=(3, 4, 6))(
        jnp.asarray(tn), jnp.asarray(extr), jnp.asarray(mask), 4, 1.5,
        jnp.asarray(inv), 2.0 * math.pi / 180)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0,
                               atol=1e-3)


def test_triangulate_tracks_matches_jax():
    """6 frames (15 pair trials, shuffled to 12), 200 tracks, visibility
    and scores that penalize some observations: the inlier counts and
    masks equal on >= 99% of the tracks. The angular errors are f32
    arccos values, quantized near 0 by ~3.5e-4 rad, so the mean inlier
    residuals of a track's candidates of one count can tie, and either
    package may keep another candidate of the same quality: the points of
    the tracks with equal counts within 1e-2 relative, and every point of
    both within 2 deg of each of its inlier observations. The chunked run
    equals one chunk exactly (the chunk bounds memory only)."""
    extr, _, _, tracks, _ = make_scene(2, S=6, N=200)
    tn = ((tracks - np.array([W / 2, H / 2])) / max(W, H)).astype(np.float32)
    rng = np.random.default_rng(2)
    vis = rng.uniform(0, 1, tracks.shape[:2]).astype(np.float32)
    score = rng.uniform(0.3, 1, tracks.shape[:2]).astype(np.float32)
    kw = dict(max_ransac_iters=12, seed=5)
    p_t, n_t, m_t = ttri.triangulate_tracks(_t(extr), _t(tn), _t(vis),
                                            _t(score), **kw)
    p_j, n_j, m_j = map(np.asarray, jtri.triangulate_tracks(
        jnp.asarray(extr), jnp.asarray(tn), jnp.asarray(vis),
        jnp.asarray(score), **kw))
    same = n_t.numpy() == n_j
    assert same.mean() >= 0.99, same.mean()
    assert (m_t.numpy() == m_j).all(-1).mean() >= 0.99
    rel = (np.linalg.norm(p_t.numpy() - p_j, axis=-1)
           / np.linalg.norm(p_j, axis=-1))
    assert rel[same & (n_j >= 2)].max() <= 1e-2, rel.max()
    assert (n_j >= 3).mean() > 0.5
    for p, m in ((p_t, m_t), (_t(p_j), _t(m_j))):
        err = ttri.normalized_angular_error(p[:, None], _t(tn).transpose(0, 1),
                                            _t(extr))[:, 0]
        assert bool((err[m] <= 2.0 * math.pi / 180).all())
    chunked = ttri.triangulate_tracks(_t(extr), _t(tn), _t(vis), _t(score),
                                      max_tri_points_num=6 * 64, **kw)
    for a, b in zip(chunked, (p_t, n_t, m_t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("check_triangle", [False, True])
def test_filter_points3d_matches_jax(check_triangle):
    """Masks equal (reprojection errors are not within 1e-3 px of the
    threshold), with SIMPLE_RADIAL distortion, an observation mask, a
    point behind the cameras and one beyond `hard_max`."""
    extr, intr, X, tracks, _ = make_scene(3, S=4, N=100)
    X = X.copy()
    X[0, 2] = -5.0
    X[1] = 400.0
    extra = np.full((4, 1), 0.01, np.float32)
    obs = np.random.default_rng(3).uniform(size=(4, 100)) > 0.2
    args = (X, tracks, extr, intr, extra)
    kw = dict(max_reproj_error=3.0, min_tri_angle=3.0,
              check_triangle=check_triangle)
    v_t, d_t = ttri.filter_points3d(*map(_t, args), obs_mask=_t(obs), **kw)
    v_j, d_j = jtri.filter_points3d(*map(jnp.asarray, args),
                                    obs_mask=jnp.asarray(obs), **kw)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert 0 < int(v_t.sum()) < 100


# --------------------------------------------------------------- the solve

def test_find_best_initial_pair_matches_jax():
    """The threshold relaxation on the device: the chosen inliers and
    pair equal, for a first, a relaxed and a never acceptable
    threshold."""
    rng = np.random.default_rng(4)
    for scale in (40.0, 6.0, 1.0):
        inl = rng.uniform(size=(3, 400)) > 0.3
        che = rng.uniform(size=(3, 400)) > 0.1
        ang = rng.uniform(0, scale, size=(3, 400)).astype(np.float32)
        tot_t, idx_t = tsfm.find_best_initial_pair(_t(inl), _t(che),
                                                   _t(ang), 16.0)
        tot_j, idx_j = jsfm.find_best_initial_pair(
            jnp.asarray(inl), jnp.asarray(che), jnp.asarray(ang), 16.0)
        np.testing.assert_array_equal(tot_t.numpy(), np.asarray(tot_j))
        assert int(idx_t) == int(idx_j) and idx_t.dim() == 0


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 4.0, 2.0],                   # even count: mean of 2 and 3
    [3.0, 1.0, 4.0, 2.0, 5.0],              # odd
    [7.0, float("nan"), 1.0, float("inf"), 2.5, float("nan")],  # even, inf
    [float("nan")] * 3])                    # none: NaN
def test_nanmedian_is_jnp_nanmedian(values):
    """`init_ba`'s median: `jnp.nanmedian` averages the two middle values
    of an even count (`torch.nanmedian` takes the lower)."""
    x = np.asarray(values, np.float32)
    out = float(tsfm._nanmedian(_t(x)))
    ref = float(jnp.nanmedian(jnp.asarray(x)))
    assert out == ref or (math.isnan(out) and math.isnan(ref))


def test_init_ba_matches_jax_on_an_even_inlier_count():
    """`init_ba` on a scene whose pair inliers are an even count (the
    median gate's mean of two): the kept tracks equal. The two-view BA
    frees both focals and the pair's scale, directions it constrains
    weakly, so the comparison is gauge-free: rotations within 0.2 deg,
    translation directions within 0.5 deg, focals within 1% and the
    mean reprojection error of the kept tracks within 0.02 px."""
    extr, intr, X, tracks, vis = make_scene(5, S=4, N=150)
    extr_n = extr.copy()
    extr_n[1:, :, 3] += np.random.default_rng(5).normal(scale=0.05,
                                                       size=(3, 3))
    extr_n = extr_n.astype(np.float32)
    tn = ((tracks - np.array([W / 2, H / 2])) / max(W, H)).astype(np.float32)
    pts_pair, cheir, angles = ttri.triangulate_by_pair(_t(extr_n), _t(tn))
    inl = np.ones((3, 150), bool)
    inl[:, 7] = False
    total, idx = tsfm.find_best_initial_pair(_t(inl), cheir, angles, 16.0)
    assert int(total[idx].sum()) % 2 == 0, int(total[idx].sum())
    out_t = tsfm.init_ba(_t(extr_n), _t(intr), None, _t(tracks), pts_pair,
                         total, idx, (W, H), tsfm.SfmConfig())
    out_j = jsfm.init_ba(jnp.asarray(extr_n), jnp.asarray(intr), None,
                         jnp.asarray(tracks), jnp.asarray(pts_pair.numpy()),
                         jnp.asarray(total.numpy()), jnp.asarray(int(idx)),
                         (W, H), jsfm.SfmConfig())
    keep = out_t[4]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(out_j[4]))
    assert int(keep.sum()) > 100
    ej = _t(out_j[0])
    assert float(_rot_err_deg(ej, out_t[0]).max()) < 0.2
    tj, tt = ej[1:, :, 3], out_t[0][1:, :, 3]
    cos = (tj * tt).sum(-1) / (tj.norm(dim=-1) * tt.norm(dim=-1))
    assert float(torch.rad2deg(torch.arccos(cos.clamp(max=1))).max()) < 0.5
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               rtol=1e-2)
    pair = [0, int(idx) + 1]

    def reproj(e, i, p):
        pix = project_points(p, e[pair], i[pair])
        return float((pix - _t(tracks)[pair]).norm(dim=-1)[:, keep].mean())

    assert abs(reproj(out_t[0], out_t[1], out_t[3])
               - reproj(ej, _t(out_j[1]), _t(out_j[3]))) < 0.02


@pytest.mark.parametrize("f_trials", [1, 17])
def test_absolute_pose_ransac_matches_jax(f_trials):
    """PnP on the JAX package's minimal sets: the same winning focal,
    rotations within 0.25 deg and translations within 5e-3 (the f32 DLT
    on unnormalized points is itself ~0.1-0.5 deg and ~1e-2 off the
    planted pose, and its rounding differs between the packages), inlier
    masks equal on >= 99%. With the 17-focal sweep the input focal is 2x
    off, so the sweep's factor 0.5 finds the planted one."""
    # the shapes of the solve's scene below: JAX compiles PnP once
    extr, intr, X, tracks, vis = make_scene(6, S=4, N=150)
    intr_in = intr.copy()
    if f_trials > 1:
        intr_in[:, :2, :2] *= 2.0
    pts = np.broadcast_to(X[None], (4,) + X.shape).copy()
    obs = vis > 0
    key = jax.random.PRNGKey(7)
    idx, _ = jtu.generate_samples(key, 150, 256, 6)
    out_j = jpnp.absolute_pose_ransac(
        jnp.asarray(pts), jnp.asarray(tracks), jnp.asarray(intr_in), key,
        valid_mask=jnp.asarray(obs), f_trials=f_trials)
    out_t = tpnp.absolute_pose_ransac(
        _t(pts), _t(tracks), _t(intr_in), valid_mask=_t(obs),
        f_trials=f_trials, sample_idx=_t(idx).long())
    np.testing.assert_allclose(out_t["intrinsics"].numpy(),
                               np.asarray(out_j["intrinsics"]), rtol=1e-6)
    np.testing.assert_allclose(out_t["extrinsics"].numpy(),
                               np.asarray(out_j["extrinsics"]), rtol=0,
                               atol=5e-3)
    assert float(_rot_err_deg(out_j["extrinsics"],
                              out_t["extrinsics"]).max()) < 0.25
    same = out_t["inlier_mask"].numpy() == np.asarray(out_j["inlier_mask"])
    assert same.mean() >= 0.99
    # the recovered poses are the planted ones
    assert float(_rot_err_deg(extr, out_t["extrinsics"]).max()) < 0.5
    with pytest.raises(ValueError):
        tpnp.absolute_pose_ransac(_t(pts), _t(tracks), _t(intr_in),
                                  sample_idx=_t(idx).long(), refine="epnp")


def test_refine_poses_matches_jax():
    """Forced refinement with the JAX draws, focal frozen, on a scene of
    focal 200: frame 2's translation is 2 off (PnP at the current focal
    rescues it), frame 3's focal is 200 / 3.875, below the validity
    window, so only the 17-focal sweep (its factor 3.875) makes it valid.
    Every frame valid in both, the planted focal found, rotations within
    0.05 deg and translations within 5e-3 of each other (the PnP DLT's
    f32 rounding, as above) and within 0.5 deg of the planted ones."""
    extr, intr, X, tracks, vis = make_scene(7, S=4, N=150, focal=200.0)
    extr_in, intr_in = extr.copy(), intr.copy()
    extr_in[2, :, 3] += 2.0
    intr_in[3, :2, :2] /= 3.875
    obs = vis > 0
    args = (extr_in, intr_in, X, tracks, obs)
    kw = dict(force_estimate=True, refine_intrinsics=False)
    out_j = jref.refine_poses(*map(jnp.asarray, args), (W, H),
                              pnp_key=jax.random.PRNGKey(99), **kw)
    out_t = tref.refine_poses(*map(_t, args), (W, H),
                              draws=_jax_pnp_draws(99, 150), **kw)
    assert bool(out_t[3].all()) and bool(np.asarray(out_j[3]).all())
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               rtol=1e-5)
    np.testing.assert_allclose(out_t[1][:, 0, 0].numpy(), 200.0, rtol=1e-5)
    assert float(_rot_err_deg(out_j[0], out_t[0]).max()) < 0.05
    np.testing.assert_allclose(out_t[0][..., 3].numpy(),
                               np.asarray(out_j[0])[..., 3], rtol=0,
                               atol=5e-3)
    assert float(_rot_err_deg(extr, out_t[0]).max()) < 0.5


def test_run_sfm_matches_jax():
    """tests/test_sfm.py's noisy scene (4 frames, 150 tracks, 10% outlier
    observations, 5 cm of translation noise on the initial cameras) with
    the JAX draws: cameras within 0.1 deg and 2e-3, focals within 1e-3
    relative, valid_tracks and valid_2d_mask equal on >= 98%, the same
    initial pair, both AUC@30 against the planted cameras above 0.9 and
    within 0.02 of each other."""
    extr, intr, X, tracks, vis = make_scene(8, S=4, N=150)
    rng = np.random.default_rng(8)
    extr_n = extr.copy()
    extr_n[1:, :, 3] += rng.normal(scale=0.05, size=(3, 3))
    kw = dict(ba_max_iterations=15, max_ransac_iters=128, robust_refine=1,
              ba_iters=1)
    args = (extr_n, intr, tracks, vis)
    out_j = jax.device_get(jsfm.run_sfm(*map(jnp.asarray, args), (W, H),
                                        cfg=jsfm.SfmConfig(**kw)))
    out_t = tsfm.run_sfm(*map(_t, args), (W, H), cfg=tsfm.SfmConfig(**kw),
                         draws={99: _jax_pnp_draws(99, 150),
                                100: _jax_pnp_draws(100, 150)})
    assert int(out_t["init_idx"]) == int(out_j["init_idx"])
    assert float(_rot_err_deg(out_j["extrinsics"],
                              out_t["extrinsics"]).max()) < 0.1
    np.testing.assert_allclose(out_t["extrinsics"].numpy(),
                               out_j["extrinsics"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(out_t["intrinsics"].numpy(),
                               out_j["intrinsics"], rtol=1e-3)
    for k in ("valid_tracks", "valid_2d_mask", "valid_frame_mask"):
        same = (out_t[k].numpy() == out_j[k]).mean()
        assert same >= (1.0 if k == "valid_frame_mask" else 0.98), (k, same)
    gt = _t(extr)
    auc_t = float(tauc30(out_t["extrinsics"], gt))
    auc_j = float(jauc30(jnp.asarray(out_j["extrinsics"]), jnp.asarray(extr)))
    assert auc_t > 0.9 and auc_j > 0.9 and abs(auc_t - auc_j) <= 0.02
    r_err, _, mask = relative_pose_errors(out_t["extrinsics"], gt)
    assert float(r_err[mask].max()) < 1.0


def test_normalize_reconstruction_matches_numpy():
    """The COLMAP gauge normalization in f64 against the numpy original
    (within 1e-6 relative after the cast to f32), with unregistered
    frames and with none registered."""
    rng = np.random.default_rng(9)
    extr, _, X, _, _ = make_scene(9, S=6, N=50)
    extr[:, :, 3] += rng.normal(size=(6, 3)).astype(np.float32)
    for reg in (np.array([1, 1, 0, 1, 1, 1], bool), np.zeros(6, bool),
                None):
        e_np, x_np = extr.copy(), X.copy()
        s_np, c_np = jnorm.normalize_reconstruction(e_np, x_np,
                                                    registered=reg)
        e_t, x_t, s_t, c_t = tnorm.normalize_reconstruction(
            _t(extr), _t(X), registered=None if reg is None else _t(reg))
        assert e_t.dtype == x_t.dtype == torch.float32
        np.testing.assert_allclose(float(s_t), s_np, rtol=1e-12)
        np.testing.assert_allclose(c_t.numpy(), c_np, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(e_t.numpy(), e_np, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x_t.numpy(), x_np, rtol=1e-6, atol=1e-6)
