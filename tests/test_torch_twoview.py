"""The port's two-view geometry, preliminary cameras and camera-init choice
against the JAX package's, on the same seeded inputs, on the CPU:
twoview/utils.py, fundamental.py, essential.py, preliminary.py, the
runner's `_score_camera_init` / `_choose_camera_init` and
`sparse_reconstruct` through the SfM solve, and utils/synth.py.

The RANSAC minimal sets of the JAX package come from `jax.random`, which
torch cannot reproduce: the port is handed the indices the JAX
`generate_samples` drew (`sample_idx`).

Tolerances: the elementwise functions 1e-5 relative (f32 sums in another
order); fundamental matrices (Frobenius-normalized) equal up to sign
within 1e-4; inlier masks equal except for tracks whose residual lies
within 1e-3 (relative) of the threshold; extrinsics within 1e-4. Each
RANSAC test first asserts that the JAX winner leads every different
candidate by a margin, so a near-tie cannot make it flaky.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu import runner as jrun
from vggsfm_tpu.twoview import essential as jess
from vggsfm_tpu.twoview import fundamental as jfund
from vggsfm_tpu.twoview import preliminary as jpre
from vggsfm_tpu.twoview import utils as jtu
from vggsfm_tpu.utils import synth as jsynth
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch.twoview import essential as tess
from vggsfm_tpu_torch.twoview import fundamental as tfund
from vggsfm_tpu_torch.twoview import preliminary as tpre
from vggsfm_tpu_torch.twoview import utils as ttu
from vggsfm_tpu_torch.utils import synth as tsynth

W, H = 320, 240



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These are many small ops: intra-op threads gain them nothing, and
    in a run of several test workers on the same cores their barriers
    cost many times the ops (the file took minutes so). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=1e-5, atol=None):
    ref = np.asarray(ref)
    if atol is None:
        atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rtol,
                               atol=atol)


def _same_up_to_sign(F, G, atol):
    """(..., 3, 3) matrices equal up to a sign each."""
    F, G = np.asarray(F), np.asarray(G)
    d = np.minimum(np.abs(F - G).max((-2, -1)), np.abs(F + G).max((-2, -1)))
    assert np.all(d <= atol), d.max()


def _rot(ax, ay):
    cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return Rx @ Ry


def make_scene(seed, S=3, N=256, noise=0.3, outlier_frac=0.3):
    """S pinhole views (focal max(W, H), the default intrinsics) of N
    points 4-8 in front; frame 0 the identity. In frames >= 1 the first
    `outlier_frac` of the tracks are uniform pixels. Returns tracks
    (1, S, N, 2), extrinsics (S, 3, 4), K (3, 3), the outlier count."""
    rng = np.random.default_rng(seed)
    f = float(max(W, H))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], size=(N, 3))
    extr = np.zeros((S, 3, 4))
    extr[0, :, :3] = np.eye(3)
    for s in range(1, S):
        extr[s, :, :3] = _rot(0.02 * s, -0.06 * s)
        extr[s, :, 3] = [0.4 * s, 0.05 * s, 0.02]
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], X) + extr[:, None, :, 3]
    pix = np.einsum("ij,snj->sni", K, cam)
    tracks = pix[..., :2] / pix[..., 2:]
    tracks += rng.normal(scale=noise, size=tracks.shape)
    n_out = int(outlier_frac * N)
    tracks[1:, :n_out] = rng.uniform([0, 0], [W, H], size=(S - 1, n_out, 2))
    return (tracks[None].astype(np.float32), extr.astype(np.float32),
            K.astype(np.float32), n_out)


def _jax_samples(key, N, iters):
    idx, valid = jtu.generate_samples(key, N, iters, 7)
    return np.asarray(idx), np.asarray(valid)


@partial(jax.jit, static_argnames=("iters", "lo_num", "thres"))
def _jax_candidates(points1, points2, sample_idx, trial_valid, valid_mask,
                    iters, lo_num, thres):
    """Every candidate of the JAX `estimate_fundamental` (the minimal
    sets' roots and both refinement rounds) with its score: the same
    steps, returned before the argmax."""
    B = points1.shape[0]
    left = jnp.take(points1, sample_idx, axis=1).reshape(-1, 7, 2)
    right = jnp.take(points2, sample_idx, axis=1).reshape(-1, 7, 2)
    F7, root_valid = jfund.run_7point(left, right)
    F7 = F7.reshape(B, iters * 3, 3, 3)
    cand = (root_valid.reshape(B, iters, 3)
            & trial_valid[None, :, None]).reshape(B, -1)
    num0, mean0 = jfund._stream_scores(points1, points2, F7, cand,
                                       valid_mask, thres, 128, True)
    _, sel1 = jax.lax.top_k(jnp.where(cand, num0, -1), lo_num)
    F1 = jfund._stream_local_refine(
        points1, points2, jnp.take_along_axis(F7, sel1[..., None, None], 1),
        valid_mask, thres, 32, True)
    v1 = jnp.ones(F1.shape[:2], bool)
    num1, mean1 = jfund._stream_scores(points1, points2, F1, v1, valid_mask,
                                       thres, 128, True)
    _, sel2 = jax.lax.top_k(num1, lo_num // 2)
    F2 = jfund._stream_local_refine(
        points1, points2, jnp.take_along_axis(F1, sel2[..., None, None], 1),
        valid_mask, thres, 32, True)
    v2 = jnp.ones(F2.shape[:2], bool)
    num2, mean2 = jfund._stream_scores(points1, points2, F2, v2, valid_mask,
                                       thres, 128, True)
    score = jtu.residual_indicator(
        jnp.concatenate([num0, num1, num2], 1),
        jnp.concatenate([mean0, mean1, mean2], 1),
        jnp.concatenate([cand, v1, v2], 1))
    return jnp.concatenate([F7, F1, F2], 1), score


def _assert_winner_margin(fmat, points1, points2, idx, valid, valid_mask,
                          iters, lo_num, thres, margin=1e-3):
    """The JAX winner `fmat` (B, 3, 3) is the first top-scored candidate;
    every candidate that differs from it (by more than 1e-3 up to sign)
    and comes before it scores `margin` lower, and every later one scores
    no higher. (A score is the inlier count plus 1 - mean/1e6, rounded in
    f32: candidates of one count tie exactly, and the first one wins.)"""
    Fs, score = _jax_candidates(
        jnp.asarray(points1), jnp.asarray(points2), jnp.asarray(idx),
        jnp.asarray(valid), jnp.asarray(valid_mask), iters=iters,
        lo_num=lo_num, thres=thres)
    Fs, score = np.asarray(Fs), np.asarray(score)
    for b in range(Fs.shape[0]):
        best = int(np.argmax(score[b]))
        _same_up_to_sign(Fs[b, best], np.asarray(fmat)[b], 1e-6)
        d = np.minimum(np.abs(Fs[b] - Fs[b, best]).max((-2, -1)),
                       np.abs(Fs[b] + Fs[b, best]).max((-2, -1)))
        other = d > 1e-3
        before = other & (np.arange(len(d)) < best)
        if before.any():
            assert score[b, best] - score[b][before].max() > margin, b
        assert score[b][other].max() <= score[b, best], b


def _assert_masks_match(t_mask, j_mask, j_res, thres):
    t_mask, j_mask = np.asarray(t_mask), np.asarray(j_mask)
    near = np.abs(np.asarray(j_res) - thres) <= 1e-3 * thres
    assert np.array_equal(t_mask[~near], j_mask[~near])


# ------------------------------------------------------------------ utils

def test_generate_samples_masks_repeated_indices():
    g = torch.Generator().manual_seed(3)
    idx, valid = ttu.generate_samples(g, 9, 500, 7)
    assert idx.shape == (500, 7) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 9
    dup = np.array([len(set(r)) < 7 for r in idx.numpy()])
    assert np.array_equal(valid.numpy(), ~dup) and dup.any() and not dup.all()
    # the same generator state, the same sets; the JAX rule on JAX draws
    idx2, _ = ttu.generate_samples(torch.Generator().manual_seed(3), 9, 500,
                                   7)
    assert torch.equal(idx, idx2)
    jidx, jvalid = _jax_samples(jax.random.PRNGKey(0), 12, 300)
    assert np.array_equal(ttu.trial_validity(_t(jidx)).numpy(), jvalid)


@pytest.mark.parametrize("colmap_style", [False, True])
def test_normalize_points_masked(rng, colmap_style):
    pts = rng.uniform(0, 300, size=(3, 40, 2)).astype(np.float32)
    mask = rng.uniform(size=(3, 40)) > 0.3
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        jp, jT = jtu.normalize_points_masked(jnp.asarray(pts), jm,
                                             colmap_style=colmap_style)
        tp, tT = ttu.normalize_points_masked(_t(pts), tm,
                                             colmap_style=colmap_style)
        _close(tp, jp)
        _close(tT, jT)


@pytest.mark.parametrize("squared", [True, False])
def test_sampson_epipolar_distance(rng, squared):
    p1 = rng.uniform(0, 300, size=(2, 50, 2)).astype(np.float32)
    p2 = rng.uniform(0, 300, size=(2, 50, 2)).astype(np.float32)
    F = rng.normal(size=(2, 5, 3, 3)).astype(np.float32)
    F /= np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    _close(ttu.sampson_epipolar_distance(_t(p1), _t(p2), _t(F), squared),
           jtu.sampson_epipolar_distance(jnp.asarray(p1), jnp.asarray(p2),
                                         jnp.asarray(F), squared),
           rtol=1e-4)


def test_residual_indicator(rng):
    num = rng.integers(0, 5, size=(3, 30)).astype(np.int32)
    mean = rng.uniform(0, 4, size=(3, 30)).astype(np.float32)
    valid = rng.uniform(size=(3, 30)) > 0.2
    for v in (None, valid):
        _close(ttu.residual_indicator(_t(num).long(), _t(mean),
                                      None if v is None else _t(v)),
               jtu.residual_indicator(jnp.asarray(num), jnp.asarray(mean),
                                      None if v is None else
                                      jnp.asarray(v)))


def test_triangulate_point_pair_and_cheirality():
    tracks, extr, K, _ = make_scene(1, S=2, N=60, noise=0.0,
                                    outlier_frac=0.0)
    n = (tracks[0] - K[:2, 2]) / K[0, 0]  # normalized
    n[1, :6] = -n[1, :6] * 3  # some points behind a camera
    R, t = extr[1:, :, :3], extr[1:, :, 3]
    eye = np.eye(3, 4, dtype=np.float32)[None]
    jX = jtu.triangulate_point_pair(jnp.asarray(eye), jnp.asarray(extr[1:]),
                                    jnp.asarray(n[:1]), jnp.asarray(n[1:]))
    tX = ttu.triangulate_point_pair(_t(eye), _t(extr[1:]), _t(n[:1]),
                                    _t(n[1:]))
    _close(tX, jX, rtol=1e-4)
    jc, _ = jtu.check_cheirality(jnp.asarray(R), jnp.asarray(t),
                                 jnp.asarray(n[:1]), jnp.asarray(n[1:]))
    tc, _ = ttu.check_cheirality(_t(R), _t(t), _t(n[:1]), _t(n[1:]))
    assert int(tc[0]) == int(jc[0]) < 60


# ------------------------------------------------------------ fundamental

def test_run_8point_masked():
    tracks, _, _, n_out = make_scene(2, S=2, N=120)
    p1, p2 = tracks[0, :1], tracks[0, 1:]
    mask = np.ones((1, 120), np.float32)
    mask[:, :n_out] = 0.0
    jF = jfund.run_8point(jnp.asarray(p1), jnp.asarray(p2),
                          jnp.asarray(mask))
    tF = tfund.run_8point(_t(p1), _t(p2), _t(mask))
    _same_up_to_sign(tF, jF, 1e-4)
    assert abs(float(torch.linalg.det(tF[0]))) < 1e-6


def _set_dist(F, Gs):
    """Distance, up to sign, from F (3, 3) to the nearest of Gs."""
    return min(min(np.abs(F - G).max(), np.abs(F + G).max()) for G in Gs)


def test_run_7point():
    """64 minimal sets of 7 distinct points. The solutions are the roots
    of a cubic over a two-dimensional nullspace, which f32 finds only to
    its rounding over the gap to the normal matrix's third eigenvalue
    (here 1e-6-1e-4 of the largest): set by set the two packages' f32
    roundings move a solution by up to ~1e-2. So both are held to the
    exact solutions (the port in f64), as sets (the slots' order may
    differ where the nullspace basis does): over the 64 sets the port's
    median error is within 2x the JAX package's and its largest within
    4x, and the median is below 1e-3. The valid slots agree but for a
    near-double root."""
    rng = np.random.default_rng(4)
    tracks, _, _, _ = make_scene(3, S=2, N=400, outlier_frac=0.0)
    idx = np.stack([rng.permutation(400)[:7] for _ in range(64)])
    left, right = tracks[0, 0][idx], tracks[0, 1][idx]
    jF, jv = jfund.run_7point(jnp.asarray(left), jnp.asarray(right))
    tF, tv = tfund.run_7point(_t(left), _t(right))
    xF, xv = tfund.run_7point(_t(left).double(), _t(right).double())
    jv, tv, jF, tF = np.asarray(jv), tv.numpy(), np.asarray(jF), tF.numpy()
    xv, xF = xv.numpy(), xF.numpy()
    assert jv.sum() > 64
    # a near-double root sits by the cubic's discriminant = 0 boundary,
    # where rounding decides between one real root and three: there the
    # valid slots may differ, and JAX's two closest solutions lie within
    # 5e-2 of each other while the third stands apart
    flip = np.nonzero((tv != jv).any(-1))[0]
    assert len(flip) <= 1
    for b in flip:
        F = jF[b][jv[b]]
        gaps = sorted(_set_dist(F[i], F[k:k + 1])
                      for i in range(len(F)) for k in range(i + 1, len(F)))
        assert gaps[0] < 5e-2 and gaps[1] > 10 * gaps[0], gaps
    t_err, j_err = [], []
    for b in range(64):
        if b in flip or not (xv[b] == jv[b]).all():
            continue
        x = xF[b][xv[b]]
        t_err.append(max(_set_dist(F, x) for F in tF[b][tv[b]]))
        j_err.append(max(_set_dist(F, x) for F in jF[b][jv[b]]))
    assert len(t_err) >= 60
    assert np.median(t_err) <= min(1e-3, 2 * np.median(j_err))
    assert max(t_err) <= 4 * max(j_err)


def test_estimate_fundamental_with_injected_samples():
    """Two pairs of a scene with 30% outliers, 5% of the correspondences
    masked out, at the runner's RANSAC settings (1024 minimal sets, 128
    refined candidates: the JAX compile does not grow with them, and the
    margin check's compile is shared with the preliminary test)."""
    tracks, _, _, n_out = make_scene(5)
    S, N = tracks.shape[1:3]
    p1 = np.broadcast_to(tracks[0, :1], (S - 1, N, 2)).copy()
    p2 = tracks[0, 1:].copy()
    vm = np.random.default_rng(6).uniform(size=(S - 1, N)) > 0.05
    iters, lo_num, thres = 1024, 128, 16.0
    key = jax.random.PRNGKey(2)
    idx, valid = _jax_samples(key, N, iters)
    jo = jfund.estimate_fundamental(jnp.asarray(p1), jnp.asarray(p2), key,
                                    max_ransac_iters=iters, max_error=4.0,
                                    lo_num=lo_num,
                                    valid_mask=jnp.asarray(vm))
    _assert_winner_margin(jo["fmat"], p1, p2, idx, valid, vm, iters,
                          lo_num, thres)
    to = tfund.estimate_fundamental(_t(p1), _t(p2), None,
                                    max_ransac_iters=iters, max_error=4.0,
                                    lo_num=lo_num, valid_mask=_t(vm),
                                    sample_idx=_t(idx))
    _same_up_to_sign(to["fmat"], jo["fmat"], 1e-4)
    _assert_masks_match(to["inlier_mask"], jo["inlier_mask"],
                        jo["residuals"], thres)
    _close(to["residuals"], jo["residuals"], rtol=1e-3, atol=1e-3)
    assert np.array_equal(to["inlier_num"].numpy(),
                          np.asarray(jo["inlier_num"]))
    # most inliers in; an outlier lands within 4 px of its epipolar line
    # by chance about one time in ten
    m = to["inlier_mask"].numpy()
    assert m[:, :n_out].mean() < 0.2 and m[:, n_out:].mean() > 0.8


# -------------------------------------------------------------- essential

def test_essential_decomposition_and_cheirality():
    tracks, extr, K, _ = make_scene(7, S=2, N=100, noise=0.0,
                                    outlier_frac=0.0)
    t = extr[1, :, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ tx @ extr[1, :, :3] @ np.linalg.inv(K)
    F = (F / np.linalg.norm(F))[None].astype(np.float32)
    Kb = K[None]
    jE = jess.essential_from_fundamental(jnp.asarray(F), jnp.asarray(Kb),
                                         jnp.asarray(Kb))
    tE = tess.essential_from_fundamental(_t(F), _t(Kb), _t(Kb))
    _close(tE, jE)
    jR, jt = jess.decompose_essential_matrix(jE)
    tR, tt = tess.decompose_essential_matrix(tE)
    _close(tR, jR, rtol=1e-4, atol=1e-4)
    _close(tt, jt, rtol=1e-4, atol=1e-4)
    fl = np.array([[K[0, 0], K[1, 1], K[0, 0], K[1, 1]]], np.float32)
    pp = np.array([[K[0, 2], K[1, 2], K[0, 2], K[1, 2]]], np.float32)
    args = (tracks[0, :1], tracks[0, 1:], fl, pp)
    jRb, jtb = jess.remove_cheirality(jR, jt, *map(jnp.asarray, args))
    tRb, ttb = tess.remove_cheirality(tR, tt, *map(_t, args))
    _close(tRb, jRb, rtol=1e-4, atol=1e-4)
    _close(ttb, jtb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tRb[0].numpy(), extr[1, :, :3], atol=1e-3)


# ------------------------------------------------------------ preliminary

def test_default_intrinsics():
    _close(tpre.default_intrinsics(W, H), jpre.default_intrinsics(W, H))


@pytest.fixture(scope="module")
def prelim_case():
    """Three frames, 30% outliers, some tracks not visible or of low
    score, and the JAX `estimate_preliminary_cameras` on them at the
    runner's key (PRNGKey(seed + 1), seed 0) and settings (1024 minimal
    sets, 128 refined candidates, 4 px), with the samples it drew."""
    tracks, extr, _, _ = make_scene(8)
    S, N = tracks.shape[1:3]
    rng = np.random.default_rng(108)
    vis = rng.uniform(0.5, 1.0, size=(1, S, N)).astype(np.float32)
    vis[0, 1:, -8:] = 0.01  # not visible
    score = np.ones((1, S, N), np.float32)
    score[0, 2, -20:-8] = 0.2  # low confidence
    key = jax.random.PRNGKey(1)
    idx, valid = _jax_samples(key, N, 1024)
    jo = jpre.estimate_preliminary_cameras(
        jnp.asarray(tracks), jnp.asarray(vis), W, H, key,
        tracks_score=jnp.asarray(score), max_error=4.0,
        max_ransac_iters=1024, lo_num=128)
    return tracks, vis, score, extr, idx, valid, jo


def test_estimate_preliminary_cameras_with_injected_samples(prelim_case):
    tracks, vis, score, extr, idx, valid, jo = prelim_case
    S, N = tracks.shape[1:3]
    query = np.broadcast_to(tracks[0, :1], (S - 1, N, 2))
    vm = ((vis >= 0.05) & (score >= 0.5))[0, 1:]
    _assert_winner_margin(jo["fmat"][0], query, tracks[0, 1:], idx, valid,
                          vm, 1024, 128, 16.0)
    to = tpre.estimate_preliminary_cameras(
        _t(tracks), _t(vis), W, H, tracks_score=_t(score), max_error=4.0,
        max_ransac_iters=1024, lo_num=128, sample_idx=_t(idx))
    assert set(to) == set(jo)
    _close(to["extrinsics"], jo["extrinsics"], rtol=0, atol=1e-4)
    _same_up_to_sign(to["fmat"], jo["fmat"], 1e-4)
    _assert_masks_match(to["fmat_inlier_mask"], jo["fmat_inlier_mask"],
                        jo["fmat_residuals"], 16.0)
    _close(to["default_intri"], jo["default_intri"])
    # near the planted relative rotations (0.3 px noise at a 320 px focal)
    R = to["extrinsics"][0, 1:, :, :3].numpy()
    cos = (np.einsum("sij,sij->s", R, extr[1:, :, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 5.0


# ------------------------------------------------- the camera-init choice

def _planted(focal, seed=0):
    """4 cameras around points ~4 away, intrinsics at `focal`, exact
    tracks (as tests/test_runner.py's camera-init competition)."""
    rng = np.random.default_rng(seed)
    S, N, sz = 4, 96, 512.0
    pts = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    extr = np.zeros((S, 3, 4), np.float32)
    for i in range(S):
        a = 0.08 * i
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
        extr[i, :, 3] = [0.3 * i, 0.0, 0.0]
    intr = np.zeros((S, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = focal
    intr[:, :2, 2] = sz / 2
    intr[:, 2, 2] = 1.0
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], pts) + extr[:, None, :, 3]
    uv = cam[..., :2] / cam[..., 2:3]
    tracks = uv * 512.0 + sz / 2  # observed by the camera of focal 512
    return extr, intr, tracks.astype(np.float32)


@pytest.mark.parametrize("focal", [512.0, 0.2 * 512.0, 5.0 * 512.0, 300.0])
def test_score_camera_init(focal):
    """Planted cameras; at the decode clamp's floor and ceiling a focal is
    saturated and scores -1."""
    extr, intr, tracks = _planted(focal)
    S, N = tracks.shape[:2]
    vis = np.ones((S, N), np.float32)
    vis[1, :10] = 0.0
    fm = np.ones((S - 1, N), bool)
    fm[2, 10:30] = False
    args = (extr, intr, tracks, vis, fm)
    j = int(jrun._score_camera_init(*map(jnp.asarray, args), 512.0))
    t = trun._score_camera_init(*map(_t, args), 512.0)
    assert t.dim() == 0 and int(t) == j
    assert (j == -1) == (focal in (0.2 * 512.0, 5.0 * 512.0))
    assert focal != 512.0 or j > 0


@pytest.fixture(scope="module")
def cpu_runner():
    """A port runner on the CPU for its stages (seeded tracker weights;
    the stages tested here use none)."""
    return trun.VGGSfMRunner(trun.RunnerConfig(precision="f32"),
                             device="cpu")


@pytest.mark.parametrize("neural", ["good", "saturated"])
def test_camera_init_choice_matches_jax(cpu_runner, prelim_case, neural):
    """The slice: the same tracks, visibilities, scores and neural
    cameras through the JAX `estimate_preliminary_cameras` (the runner's
    key and settings) plus its hybrid choice, and through the port's
    runner stages `preliminary` (the JAX samples injected) and
    `_choose_camera_init`: the same chosen cameras."""
    tracks, vis, score, extr, idx, _, jo = prelim_case
    S = tracks.shape[1]
    assert cpu_runner.cfg.seed == 0 and cpu_runner.cfg.fmat_thres == 4.0
    # neural cameras: the planted ones slightly off, at a sane focal or at
    # the decode clamp's floor
    rng = np.random.default_rng(11)
    extr_n = extr.copy()
    extr_n[1:, :, 3] *= 1.05
    extr_n[1:, :, 3] += rng.normal(scale=0.01, size=(S - 1, 3))
    f = float(max(W, H)) * (1.0 if neural == "good" else 0.2)
    intr_n = np.broadcast_to(np.array(
        [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32),
        (S, 3, 3)).copy()

    intr_tv = jnp.broadcast_to(jo["default_intri"], (S, 3, 3))
    scale = intr_tv[0, 0, 0]
    fm = jo["fmat_inlier_mask"][0]
    s_n = int(jrun._score_camera_init(jnp.asarray(extr_n),
                                      jnp.asarray(intr_n),
                                      jnp.asarray(tracks[0]),
                                      jnp.asarray(vis[0]), fm, scale))
    s_t = int(jrun._score_camera_init(jo["extrinsics"][0], intr_tv,
                                      jnp.asarray(tracks[0]),
                                      jnp.asarray(vis[0]), fm, scale))
    # integer supports: equal supports are an exact tie, which the rule
    # gives to the neural cameras
    want_e = np.asarray(jo["extrinsics"][0]) if s_t > s_n else extr_n
    want_i = np.asarray(intr_tv) if s_t > s_n else intr_n

    pre = cpu_runner.preliminary(_t(tracks), _t(vis), _t(score), W, H,
                                 sample_idx=_t(idx))
    e, i, scores = cpu_runner._choose_camera_init(_t(extr_n), _t(intr_n),
                                                  pre, _t(tracks), _t(vis))
    assert scores.tolist() == [s_n, s_t]
    assert (s_n == -1) == (neural == "saturated")
    _close(e, want_e, rtol=0, atol=1e-4)
    _close(i, want_i)
    assert "preliminary" in cpu_runner.timings
    for mode, want in (("neural", (extr_n, intr_n)),
                       ("twoview", (pre["extrinsics"][0], intr_tv))):
        cpu_runner.cfg.camera_init = mode
        try:
            got = cpu_runner._choose_camera_init(_t(extr_n), _t(intr_n), pre,
                                                 _t(tracks), _t(vis))
        finally:
            cpu_runner.cfg.camera_init = "hybrid"
        _close(got[0], want[0], rtol=0, atol=1e-4)
        _close(got[1], np.asarray(want[1]))
        assert got[2] is None


# -------------------------------------------------------------- the scene

def test_render_two_plane_scene_is_the_jax_packages():
    j = jsynth.render_two_plane_scene(3, 48, seed=1)
    t = tsynth.render_two_plane_scene(3, 48, seed=1)
    assert set(j) == set(t)
    for k in j:
        assert np.array_equal(j[k], t[k]), k


# ----------------------------------------------------- sparse_reconstruct

def test_sparse_reconstruct_equals_its_stages():
    """4 frames, 128 px, 64 points, f32, seeded weights (a tiny camera
    predictor), one query frame: the keys and shapes, and the same outputs
    as the stages called in order, the SfM solve and its normalization
    included. With `center_order` and a ranking that puts frame 2 first,
    the run swaps frames 2 and 0 for every stage and the per-frame outputs
    back."""
    from vggsfm_tpu_torch.models.camera import CameraPredictor, init_camera_

    S, R, K = 4, 128, 64
    images = tsynth.render_two_plane_scene(S, R, seed=3)["images"]
    cfg = trun.RunnerConfig(precision="f32", query_frame_num=1,
                            max_query_pts=K, query_method="sift+harris",
                            min_vis_points=1, center_order=True)
    runner = trun.VGGSfMRunner(cfg, device="cpu")
    camera = CameraPredictor(hidden_size=64, num_heads=4, down_size=28,
                             att_depth=2, trunk_depth=2)
    init_camera_(camera, torch.Generator().manual_seed(0))
    runner._camera = camera.eval()
    runner.select_query_frames = lambda imgs: [2]
    out = runner.sparse_reconstruct(images)

    P = K
    assert out["pred_track"].shape == (1, S, P, 2)
    assert out["pred_vis"].shape == out["pred_score"].shape == (1, S, P)
    for k in ("extrinsics", "init_extrinsics"):
        assert out[k].shape == (S, 3, 4)
    for k in ("intrinsics", "init_intrinsics"):
        assert out[k].shape == (S, 3, 3)
    assert out["points3d"].shape == (P, 3)
    assert out["valid_tracks"].shape == (P,)
    assert out["valid_2d_mask"].shape == (S, P)
    assert out["valid_frame_mask"].shape == (S,)
    assert out["extra_params"] is None and out["init_idx"].shape == ()
    assert out["init_scores"].shape == (2,)
    assert list(out["center_perm"]) == [2, 1, 0, 3]
    assert out["query_indices"] == [0]
    assert set(out["preliminary"]) == {"extrinsics", "fmat",
                                       "fmat_inlier_mask", "fmat_residuals",
                                       "default_intri"}
    assert {"camera_init", "fmaps", "tracking", "preliminary",
            "camera_choice", "sfm", "sfm.init_ba", "sfm.refine_poses_0",
            "sfm.triangulate_and_ba_0", "sfm.iterative_global_ba_1"
            } <= set(out["timings"])
    for k in ("pred_track", "pred_vis", "pred_score", "extrinsics",
              "intrinsics", "init_extrinsics", "init_intrinsics",
              "points3d"):
        assert bool(torch.isfinite(out[k]).all()), k

    # the same stages in order on the swapped frames
    perm = [2, 1, 0, 3]
    imgs = torch.as_tensor(images)[perm][None]
    qi = [0]
    e0, i0 = runner.camera_init(imgs, qi)
    track, vis, score = runner.track_frames(imgs, runner.fmaps(imgs), qi)
    pre = runner.preliminary(track, vis, score, R, R)
    e, i, scores = runner._choose_camera_init(e0, i0, pre, track, vis)
    assert torch.equal(out["pred_track"], track[:, perm])
    assert torch.equal(out["pred_vis"], vis[:, perm])
    assert torch.equal(out["pred_score"], score[:, perm])
    assert torch.equal(out["init_extrinsics"], e[perm])
    assert torch.equal(out["init_intrinsics"], i[perm])
    assert torch.equal(out["init_scores"], scores)
    for k, v in pre.items():
        assert torch.equal(out["preliminary"][k], v), k
    sol = runner.solve(e, i, track, vis, score, pre, R, R)
    for k in ("extrinsics", "intrinsics", "valid_frame_mask",
              "valid_2d_mask"):
        assert torch.equal(out[k], sol[k][perm]), k
    for k in ("points3d", "valid_tracks", "init_idx"):
        assert torch.equal(out[k], sol[k]), k
    # the anchor frame of the solve is the caller's frame 2
    torch.testing.assert_close(out["init_extrinsics"][2],
                               torch.eye(3, 4), atol=1e-5, rtol=0)
