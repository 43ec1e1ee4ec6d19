"""The port's remaining two-view solvers against the JAX package's, on the
same seeded inputs, on the CPU: twoview/homography.py (the DLT, the
transfer error, LORANSAC, the Malis-Vargas decomposition),
twoview/five_point.py (the coefficient matrices, the root finder, the
solutions, LORANSAC), twoview/epnp.py and `absolute_pose_ransac(refine=
"epnp")`. Mirrors tests/test_homography.py, test_five_point.py and
test_epnp.py.

The RANSAC minimal sets of the JAX package come from `jax.random`, which
torch cannot reproduce: the port is handed the indices the JAX
`generate_samples` drew (`sample_idx`).

Tolerances (f32 on both sides):
- homographies (Frobenius-normalized) within 1e-5, the decomposition's
  R, t, n within 1e-4; transfer errors 1e-5 relative;
- the five-point solver on the JAX package's nullspace basis (the four
  nullspace eigenvalues are rounding noise, so the basis itself is
  arbitrary and each package's differs): coefficient matrices within
  1e-6 of their largest entry; the sign changes on the grid equal; the
  roots within 1e-4 relative on 95% of the slots, and held as sets to
  the f64 roots of the same matrices with a median error within 2x the
  JAX package's and a largest within 4x (both bisect f32 LU
  determinants, whose signs near a root are rounding noise over a band
  that reaches 4e-3 relative on an ill-conditioned root); the solutions E, slot
  by slot and up to sign, within 1e-3 on 85% of the slots valid in both
  (92% measured),
  and held as sets to the port's f64 solutions on the same basis with a
  median error within 2x the JAX package's and a largest within 4x (an
  E from a near-double root is ill-conditioned in both: up to ~2e-2); the
  valid slots (constraint residual < 1e-2) equal but for 3% of them;
- the RANSAC winners up to sign within 1e-4 (H, poses) or 2e-3 (E, whose
  candidates come from each package's own basis: where the winners'
  inlier counts differ by one, the stated rounding case, each is held to
  the planted pose instead); inlier masks equal but for points whose JAX
  residual lies within 1e-2 (relative) of the threshold, and the counts
  equal up to those points;
- EPnP extrinsics within 1e-4 (the candidate that wins is the same), the
  winner's reprojection error within 1e-3 relative or 5e-6 (noise-free,
  it is f32 rounding: ~1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_homography import make_planar_scene, transfer_err
from tests.test_pnp import make_pnp_scene
from tests.test_twoview import make_two_view_scene
from vggsfm_tpu import twoview as jtv
from vggsfm_tpu.ops.eigh import eigh_small as jeigh
from vggsfm_tpu.ops.eigh import smallest_eigenvector as jsmallest
from vggsfm_tpu.twoview import epnp as jepnp
from vggsfm_tpu.twoview import five_point as j5
from vggsfm_tpu.twoview import homography as jh
from vggsfm_tpu.twoview import pnp as jpnp
from vggsfm_tpu.twoview import utils as jtu
from vggsfm_tpu_torch import twoview as ttv
from vggsfm_tpu_torch.twoview import epnp as tepnp
from vggsfm_tpu_torch.twoview import five_point as t5
from vggsfm_tpu_torch.twoview import homography as th
from vggsfm_tpu_torch.twoview import pnp as tpnp


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside the other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _up_to_sign(A, B):
    """(..., 3, 3) -> (...,) the largest difference, up to a sign each."""
    A, B = np.asarray(A), np.asarray(B)
    return np.minimum(np.abs(A - B).max((-2, -1)),
                      np.abs(A + B).max((-2, -1)))


def _masks_match(t_mask, j_mask, j_res, thres):
    """Equal but where the JAX residual lies within 1e-2 of the
    threshold; returns how many points differ."""
    t_mask, j_mask = np.asarray(t_mask), np.asarray(j_mask)
    near = np.abs(np.asarray(j_res) - thres) <= 1e-2 * thres
    assert np.array_equal(t_mask[~near], j_mask[~near])
    return int((t_mask != j_mask).sum())


def _draws(key, n, iters, k):
    idx, _ = jtu.generate_samples(key, n, iters, k)
    return np.asarray(idx)


def test_exports_match_the_jax_package():
    """twoview/__init__.py exports what the JAX package's does."""
    names = [n for n in dir(jtv) if not n.startswith("_")
             and callable(getattr(jtv, n))]
    assert len(names) >= 16
    assert [n for n in names if not hasattr(ttv, n)] == []


# ------------------------------------------------------------ homography

def test_homography_dlt_and_transfer_error(rng):
    """The DLT unweighted, masked and weighted over a batch of planar
    pairs; the one-way transfer error of those and perturbed candidates,
    some pointing points behind the camera."""
    scenes = [make_planar_scene(rng, n=60, noise=0.3) for _ in range(3)]
    p1 = np.stack([s[0] for s in scenes]).astype(np.float32)
    p2 = np.stack([s[1] for s in scenes]).astype(np.float32)
    w = rng.uniform(size=p1.shape[:2]).astype(np.float32)
    w[:, :10] = 0.0
    Hs = []
    for m in (None, (w > 0.3).astype(np.float32), w):
        jH = jax.jit(jh.run_homography_dlt)(
            jnp.asarray(p1), jnp.asarray(p2),
            None if m is None else jnp.asarray(m))
        tH = th.run_homography_dlt(_t(p1), _t(p2),
                                   None if m is None else _t(m))
        assert np.abs(tH.numpy() - np.asarray(jH)).max() <= 1e-5
        Hs.append(np.asarray(jH))
    for b in range(3):
        assert np.median(transfer_err(Hs[0][b], p1[b], p2[b])) < 1.0
    H = np.stack(Hs, axis=1)  # (3, 3 candidates, 3, 3)
    H = np.concatenate([H, H + rng.normal(scale=0.05, size=H.shape),
                        -H[:, :1]], axis=1).astype(np.float32)
    for sq in (True, False):
        je = np.asarray(jh.oneway_transfer_error(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(H), squared=sq))
        te = th.oneway_transfer_error(_t(p1), _t(p2), _t(H),
                                      squared=sq).numpy()
        np.testing.assert_allclose(te, je, rtol=1e-5, atol=1e-5)
        assert (je >= 1e3).any() and (je < 4).any()  # behind: BIG_RESIDUAL


def test_estimate_homography_with_the_jax_draws():
    """LORANSAC over two planar pairs (0.3 px noise, 30% outliers), the
    JAX package's 512 draws, lo_num 32."""
    rng = np.random.default_rng(1)
    scenes = [make_planar_scene(rng, n=300, noise=0.3, outlier_frac=0.3)
              for _ in range(2)]
    p1 = np.stack([s[0] for s in scenes]).astype(np.float32)
    p2 = np.stack([s[1] for s in scenes]).astype(np.float32)
    n_out = scenes[0][-1]
    key = jax.random.PRNGKey(0)
    j = jh.estimate_homography(jnp.asarray(p1), jnp.asarray(p2), key,
                               max_ransac_iters=512, lo_num=32)
    t = th.estimate_homography(_t(p1), _t(p2),
                               sample_idx=_t(_draws(key, 300, 512, 4)),
                               max_ransac_iters=512, lo_num=32)
    assert np.abs(t["hmat"].numpy() - np.asarray(j["hmat"])).max() <= 1e-4
    j_res = np.asarray(jh.oneway_transfer_error(
        jnp.asarray(p1), jnp.asarray(p2), j["hmat"][:, None]))[:, 0]
    flips = _masks_match(t["inlier_mask"], j["inlier_mask"], j_res, 16.0)
    assert abs(int((t["inlier_num"] - _t(j["inlier_num"])).abs().sum())) \
        <= flips
    for b in range(2):
        H = t["hmat"][b].numpy()
        assert np.median(transfer_err(H, p1[b, n_out:], p2[b, n_out:])) < 1
        assert t["inlier_mask"][b, :n_out].sum() < 0.1 * n_out
    # the generator route draws its own sets
    g = th.estimate_homography(_t(p1), _t(p2), torch.Generator().manual_seed(
        0), max_ransac_iters=512, lo_num=32)
    assert (g["inlier_num"] > 0.6 * 300).all()


def test_decompose_homography_matrix(rng):
    """The planted homography and one fitted by the DLT to noisy points
    (0.5 px): all four candidates (R, t, n) equal the JAX package's, and
    one of them is the planted pose."""
    x1, x2, H_gt, K, R_gt, t_gt, *_ = make_planar_scene(rng, noise=0.5)
    H_fit = th.run_homography_dlt(_t(x1).float()[None],
                                  _t(x2).float()[None])[0].numpy()
    H = np.stack([H_gt, H_fit]).astype(np.float32)
    Ks = np.stack([K, K]).astype(np.float32)
    jout = jh.decompose_homography_matrix(jnp.asarray(H), jnp.asarray(Ks),
                                          jnp.asarray(Ks))
    tout = th.decompose_homography_matrix(_t(H), _t(Ks), _t(Ks))
    for a, b in zip(tout, jout):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4
    for Rs, ts in zip(tout[0].numpy(), tout[1].numpy()):
        best = min(range(4), key=lambda i: np.abs(Rs[i] - R_gt).max())
        assert np.abs(Rs[best] - R_gt).max() < 1e-2
        assert abs(float(ts[best] @ (t_gt / np.linalg.norm(t_gt)))) > 0.99


# ------------------------------------------------------------ five-point

@jax.jit
def _jax_5point_steps(points1, points2):
    """The steps of the JAX `run_5point` with their intermediates: the
    nullspace basis, and per sample the coefficient matrices, the roots
    and the solutions with their constraint residuals (e_from_z and the
    residual as the JAX function writes them)."""
    with jax.default_matmul_precision("highest"):
        x1, y1 = points1[..., 0], points1[..., 1]
        x2, y2 = points2[..., 0], points2[..., 1]
        A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                       jnp.ones_like(x1)], axis=-1)
        _, V = jeigh(jnp.einsum("bni,bnj->bij", A, A), num_sweeps=10,
                     sort=True)
        basis = jnp.stack([V[..., :, 3], V[..., :, 2], V[..., :, 1],
                           V[..., :, 0]], axis=1).reshape(-1, 4, 3, 3)

        def solve_one(Eb):
            Ms = j5._coefficient_matrices(Eb)
            roots, valid = j5._real_roots_of_det(Ms)

            def e_from_z(z):
                Mz = Ms[0] + z * Ms[1] + z**2 * Ms[2] + z**3 * Ms[3]
                m = jsmallest(jnp.einsum("ji,jk->ik", Mz, Mz),
                              num_sweeps=10)
                denom = jnp.where(jnp.abs(m[9]) < 1e-12, 1e-12, m[9])
                wv = jnp.stack([m[7] / denom, m[8] / denom, z,
                                jnp.ones_like(z)])
                E = jnp.einsum("b,bij->ij", wv, Eb)
                return E / jnp.maximum(jnp.linalg.norm(E), 1e-12)

            Es = jax.vmap(e_from_z)(roots)
            res = jax.vmap(lambda E: jnp.abs(jnp.linalg.det(E))
                           + jnp.linalg.norm(2 * (E @ E.T) @ E
                                             - jnp.trace(E @ E.T) * E))(Es)
            return jnp.stack(Ms), roots, valid, Es, valid & (res < 1e-2)

        return basis, jax.vmap(solve_one)(basis)


def _normalized_pair(rng, n, noise=0.0, outlier_frac=0.0):
    x1, x2, _, E_gt, _, _, K, n_out = make_two_view_scene(
        rng, n=n, noise=noise, outlier_frac=outlier_frac)
    x1n = ((x1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    x2n = ((x2 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    return x1n, x2n, E_gt / np.linalg.norm(E_gt), K, n_out


def _set_errors(Es, valid, ref, ref_valid):
    """Each valid E's distance, up to sign, to the nearest valid ref."""
    out = []
    for b in range(len(Es)):
        G = ref[b][ref_valid[b]]
        for k in np.nonzero(valid[b])[0]:
            out.append(_up_to_sign(Es[b, k][None], G).min())
    return np.asarray(out)


def test_five_point_on_the_jax_basis():
    """64 minimal sets of 5 distinct points of a noisy pair, each solved
    by both packages on the JAX package's nullspace basis."""
    rng = np.random.default_rng(1)
    x1n, x2n, *_ = _normalized_pair(rng, 200, noise=0.5)
    sets = np.stack([rng.permutation(200)[:5] for _ in range(64)])
    basis, (jMs, jroots, jvalid, jE, jEvalid) = jax.tree.map(
        np.asarray, _jax_5point_steps(jnp.asarray(x1n[sets]),
                                      jnp.asarray(x2n[sets])))
    tMs = t5._coefficient_matrices(_t(basis)).numpy()
    assert np.abs(tMs - jMs).max() <= 1e-6 * np.abs(jMs).max()

    troots, tvalid = (a.numpy() for a in t5._real_roots_of_det(_t(jMs)))
    assert np.array_equal(tvalid, jvalid) and jvalid.sum() > 128
    rel = np.abs(troots - jroots) / np.maximum(1.0, np.abs(jroots))
    assert np.mean(rel[jvalid] <= 1e-4) >= 0.95
    # both held to the roots of the same M in f64, as sets
    xroots, xvalid = (a.numpy() for a in t5._real_roots_of_det(
        _t(jMs).double()))

    def root_err(r):
        return np.asarray([
            (np.abs(r[b, k] - xroots[b][xvalid[b]])
             / max(1.0, abs(r[b, k]))).min()
            for b in range(len(r)) for k in np.nonzero(jvalid[b])[0]])

    t_err, j_err = root_err(troots), root_err(jroots)
    assert np.median(t_err) <= max(2 * np.median(j_err), 1e-6)
    assert t_err.max() <= 4 * j_err.max()

    tE, tEvalid = (a.numpy() for a in t5._solve_basis(_t(basis)))
    both = tEvalid & jEvalid
    assert (tEvalid != jEvalid).sum() <= 0.03 * jEvalid.sum()
    assert (_up_to_sign(tE, jE)[both] <= 1e-3).mean() >= 0.85
    xE, xvalid = (a.numpy() for a in t5._solve_basis(_t(basis).double()))
    t_err = _set_errors(tE, tEvalid, xE, xvalid)
    j_err = _set_errors(jE, jEvalid, xE, xvalid)
    assert np.median(t_err) <= max(2 * np.median(j_err), 1e-6)
    assert np.median(t_err) < 1e-4
    assert t_err.max() <= 4 * j_err.max()


def test_run_5point_finds_the_planted_essential():
    """Noise-free minimal sets: both packages find the planted E in every
    set, within 3e-2 up to sign (an ill-conditioned set: the JAX
    package's worst here is 2.1e-2, its f64 solution 2e-5) and with a
    median error below 1e-3; every valid solution of the port satisfies
    the five epipolar constraints."""
    rng = np.random.default_rng(3)
    x1n, x2n, E_gt, *_ = _normalized_pair(rng, 100)
    sets = np.stack([rng.permutation(100)[:5] for _ in range(16)])
    jE, jv = (np.asarray(a) for a in jax.jit(j5.run_5point)(
        jnp.asarray(x1n[sets]), jnp.asarray(x2n[sets])))
    tE, tv = (a.numpy() for a in ttv.run_5point(_t(x1n[sets]),
                                                _t(x2n[sets]), chunk=5))
    for E, v in ((jE, jv), (tE, tv)):
        d = np.where(v, _up_to_sign(E, E_gt[None, None]), np.inf).min(1)
        assert d.max() < 3e-2 and np.median(d) < 1e-3
    p1 = np.concatenate([x1n[sets], np.ones((16, 5, 1))], -1)
    p2 = np.concatenate([x2n[sets], np.ones((16, 5, 1))], -1)
    resid = np.abs(np.einsum("bni,bkij,bnj->bkn", p2, tE, p1)).max(-1)
    assert resid[tv].max() < 1e-4


def test_estimate_essential_with_the_jax_draws():
    """LORANSAC over two noisy pairs (0.3 px, 20% outliers), the JAX
    package's 64 draws of 5. Each package's candidates are the minimal
    sets' solutions in its own nullspace basis, equal within their f32
    conditioning (up to ~2e-2, above): a candidate whose inliers differ by
    a point at the threshold may then win by one inlier in either
    package. Where the winners' counts are equal, E agrees within 2e-3
    and the masks but for points at the threshold; else the counts
    differ by one. Both winners recover the planted pose and reject the
    outliers."""
    rng = np.random.default_rng(0)
    pairs = [_normalized_pair(rng, 200, noise=0.3, outlier_frac=0.2)
             for _ in range(2)]
    p1 = np.stack([p[0] for p in pairs])
    p2 = np.stack([p[1] for p in pairs])
    f = float(pairs[0][3][0, 0])
    thres = (2.0 / f) ** 2
    key = jax.random.PRNGKey(0)
    j = j5.estimate_essential(jnp.asarray(p1), jnp.asarray(p2), key,
                              max_ransac_iters=64, max_error=2.0,
                              focal_length=f)
    t = t5.estimate_essential(_t(p1), _t(p2),
                              sample_idx=_t(_draws(key, 200, 64, 5)),
                              max_ransac_iters=64, max_error=2.0,
                              focal_length=f)
    j_res = np.asarray(jtu.sampson_epipolar_distance(
        jnp.asarray(p1), jnp.asarray(p2), j["emat"][:, None]))[:, 0]
    tn, jn = t["inlier_num"].numpy(), np.asarray(j["inlier_num"])
    assert np.abs(tn - jn).max() <= 1 and (tn == jn).any()
    for b, (_, _, E_gt, _, n_out) in enumerate(pairs):
        if tn[b] == jn[b]:
            assert _up_to_sign(t["emat"][b].numpy(), j["emat"][b]) <= 2e-3
            _masks_match(t["inlier_mask"][b], j["inlier_mask"][b],
                         j_res[b], thres)
        for E, mask in ((t["emat"][b].numpy(), t["inlier_mask"][b].numpy()),
                        (np.asarray(j["emat"][b]), j["inlier_mask"][b])):
            assert _up_to_sign(E, E_gt) < 0.1
            assert int(np.sum(mask[:n_out])) < 0.15 * n_out
            assert int(np.sum(mask)) > 0.8 * (200 - n_out)


# ----------------------------------------------------------------- EPnP

_PNP_CASES = ["exact", "exact_2", "weights_reject_corruption", "noisy",
              "planar"]


@functools.lru_cache(maxsize=None)
def _pnp_batch():
    """The EPnP cases as one batch of 120 points each, solved once by each
    package (a weight of 1 where a case has none, as the JAX package
    weighs unweighted calls): world points, normalized image points,
    weights and the planted (R, t) per case, then both outputs."""
    rng = np.random.default_rng(0)
    Xs, ys, ws, Rs, ts = [], [], [], [], []
    for name in _PNP_CASES:
        X, x, K, R, t, _ = make_pnp_scene(
            rng, P=120, noise=0.0 if name.startswith("exact") else 0.1)
        w = np.ones(120)
        if name == "weights_reject_corruption":
            w[:30] = 0.0
            x[:30] += 5.0 * K[0, 0]
        elif name == "planar":
            X[:, 2] = 6.0 + 0.001 * rng.normal(size=120)
            uv = (K @ ((R @ X.T).T + t).T).T
            x = uv[:, :2] / uv[:, 2:]
        Xs.append(X)
        ys.append((x - K[:2, 2]) / K[0, 0])
        ws.append(w)
        Rs.append(R)
        ts.append(t)
    X, y, w = (np.stack(a).astype(np.float32) for a in (Xs, ys, ws))
    j = jax.jit(jepnp.efficient_pnp)(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(w))
    t = tepnp.efficient_pnp(_t(X), _t(y), _t(w))
    return (np.stack(Rs), np.stack(ts), {k: np.asarray(v) for k, v in
                                         j.items()},
            {k: v.numpy() for k, v in t.items()})


@pytest.mark.parametrize("case", _PNP_CASES)
def test_efficient_pnp(case):
    """EPnP on one case of the batch: exact (two of them), a quarter of
    the points corrupted and weighted 0, 0.1 px noise, near-planar."""
    i = _PNP_CASES.index(case)
    R, t, j, out = _pnp_batch()
    E = out["extrinsics"][i]
    assert np.abs(E - j["extrinsics"][i]).max() <= 1e-4
    np.testing.assert_allclose(out["err_2d"][i], j["err_2d"][i],
                               rtol=1e-3, atol=5e-6)
    assert np.abs(E[:, :3] - R[i]).max() < 2e-2
    assert np.abs(E[:, 3] - t[i]).max() < 0.1


def test_absolute_pose_ransac_epnp_with_the_jax_draws():
    """LORANSAC PnP with the EPnP refinement over two frames (0.3 px
    noise, 25% outliers), the JAX package's 128 draws of 6, 16 refined
    candidates, 3 focal trials; an unknown mode raises."""
    rng = np.random.default_rng(3)
    scenes = [make_pnp_scene(rng, P=300, noise=0.3, outlier_frac=0.25)
              for _ in range(2)]
    X = np.stack([s[0] for s in scenes]).astype(np.float32)
    x = np.stack([s[1] for s in scenes]).astype(np.float32)
    K = np.stack([s[2] for s in scenes]).astype(np.float32)
    key = jax.random.PRNGKey(0)
    kw = dict(max_ransac_iters=128, lo_num=16, f_trials=3, refine="epnp")
    j = jpnp.absolute_pose_ransac(jnp.asarray(X), jnp.asarray(x),
                                  jnp.asarray(K), key, **kw)
    t = tpnp.absolute_pose_ransac(_t(X), _t(x), _t(K),
                                  sample_idx=_t(_draws(key, 300, 128, 6)),
                                  **kw)
    assert np.abs(t["extrinsics"].numpy()
                  - np.asarray(j["extrinsics"])).max() <= 1e-4
    assert np.array_equal(t["intrinsics"].numpy(), np.asarray(j["intrinsics"]))
    assert np.array_equal(t["inlier_num"].numpy(), np.asarray(j["inlier_num"]))
    for b, (_, _, _, R, tt, n_out) in enumerate(scenes):
        np.testing.assert_allclose(t["extrinsics"][b, :, :3].numpy(), R,
                                   atol=2e-2)
        np.testing.assert_allclose(t["extrinsics"][b, :, 3].numpy(), tt,
                                   atol=6e-2)
        assert int(t["inlier_num"][b]) > 0.8 * (300 - n_out)
    with pytest.raises(ValueError, match="refine"):
        tpnp.absolute_pose_ransac(_t(X), _t(x), _t(K),
                                  sample_idx=_t(_draws(key, 300, 128, 6)),
                                  refine="gauss")
