"""The port's geometry and small linear algebra against the JAX package's,
on the same seeded inputs, on the CPU: utils/precision.py,
geometry/rotations.py, distortion.py, cameras.py, metrics.py, ops/eigh.py,
svd3.py, polynomial.py and the camera-init part of ops/triangulation.py.

Tolerances: rotations, cameras, distortion, metrics and triangulation
1e-5 relative (short f32 sums in another order; an absolute floor of
1e-5 of the inputs' scale where a value crosses zero); eigenvalues 1e-4
of the matrix norm, eigenvectors up to sign; `svd3x3` / `project_rank2`
within 1e-5 of the matrix norm, reconstruction and singular values;
`solve_cubic` the same roots (1e-4 relative) and the same valid slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.geometry import cameras as jcam
from vggsfm_tpu.geometry import distortion as jdist
from vggsfm_tpu.geometry import metrics as jmet
from vggsfm_tpu.geometry import rotations as jrot
from vggsfm_tpu.ops import eigh as jeigh
from vggsfm_tpu.ops import polynomial as jpoly
from vggsfm_tpu.ops import svd3 as jsvd
from vggsfm_tpu.ops import triangulation as jtri
from vggsfm_tpu_torch.geometry import cameras as tcam
from vggsfm_tpu_torch.geometry import distortion as tdist
from vggsfm_tpu_torch.geometry import metrics as tmet
from vggsfm_tpu_torch.geometry import rotations as trot
from vggsfm_tpu_torch.ops import eigh as teigh
from vggsfm_tpu_torch.ops import polynomial as tpoly
from vggsfm_tpu_torch.ops import svd3 as tsvd
from vggsfm_tpu_torch.ops import triangulation as ttri
from vggsfm_tpu_torch.utils.precision import default_precision, f32_matmuls



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


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))


def _cameras(rng, S):
    """S cameras near the identity looking down +z at points ~4 away."""
    aa = rng.normal(scale=0.1, size=(S, 3)).astype(np.float32)
    R = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    t = rng.normal(scale=0.3, size=(S, 3, 1)).astype(np.float32)
    return np.concatenate([R, t], axis=-1)


# ------------------------------------------------------------- precision

def test_f32_matmuls_turns_tf32_off_and_restores():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    @f32_matmuls
    def inside():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            assert inside() == (False, False)
            with f32_matmuls():
                assert not torch.backends.cudnn.allow_tf32
                with f32_matmuls():
                    pass
                assert not torch.backends.cuda.matmul.allow_tf32
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (on, on)
        with pytest.raises(ValueError):
            with f32_matmuls():
                torch.backends.cudnn.allow_tf32 = True
                raise ValueError  # restored on the way out as well
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_default_precision_pins_pytorch_defaults_and_restores():
    """VGGT's heads: full-f32 products and TF32 convolutions whatever the
    caller set (a benchmark's reference turns both off for its process)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)

    @default_precision
    def inside():
        with f32_matmuls():  # nested: the geometry inside a head
            nested = torch.backends.cudnn.allow_tf32
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32, nested)

    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            assert inside() == (False, True, False)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (on, on)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ------------------------------------------------------------- rotations

def test_quaternion_multiply_and_invert(rng):
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    _close(trot.quaternion_multiply(_t(a), _t(b)),
           jrot.quaternion_multiply(jnp.asarray(a), jnp.asarray(b)))
    _close(trot.quaternion_invert(_t(a)),
           jrot.quaternion_invert(jnp.asarray(a)))


@pytest.mark.parametrize("scale", [1.0, 1e-4, 0.0])
def test_axis_angle_to_matrix(rng, scale):
    """Ordinary angles, the Taylor branch near zero, and zero itself."""
    aa = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    _close(trot.axis_angle_to_matrix(_t(aa)),
           jrot.axis_angle_to_matrix(jnp.asarray(aa)))


def test_so3_geodesic_angle(rng):
    R1, R2 = _rotations(rng, 64), _rotations(rng, 64)
    _close(trot.so3_geodesic_angle(_t(R1), _t(R2)),
           jrot.so3_geodesic_angle(jnp.asarray(R1), jnp.asarray(R2)))


# ------------------------------------------------------------ distortion

@pytest.mark.parametrize("K", [1, 2, 4])
def test_distortion_terms_jacobian_and_undistortion(rng, K):
    params = (rng.normal(size=(3, K)) * 0.05).astype(np.float32)
    uv = rng.uniform(-0.6, 0.6, size=(3, 50, 2)).astype(np.float32)
    u, v = uv[..., 0], uv[..., 1]
    jp, ju, jv = jnp.asarray(params), jnp.asarray(u), jnp.asarray(v)
    for got, want in zip(tdist.apply_distortion(_t(params), _t(u), _t(v)),
                         jdist.apply_distortion(jp, ju, jv)):
        _close(got, want)
    for got, want in zip(
            tdist._distortion_jacobian(_t(params), _t(u), _t(v)),
            jdist._distortion_jacobian(jp, ju, jv)):
        _close(got, want)
    _close(tdist.undistort_points(_t(params), _t(uv)),
           jdist.undistort_points(jp, jnp.asarray(uv)))
    _close(tdist.single_undistortion(_t(params), _t(uv)),
           jdist.single_undistortion(jp, jnp.asarray(uv)))


# --------------------------------------------------------------- cameras

@pytest.mark.parametrize("K", [None, 1, 4])
def test_projection_and_back(rng, K):
    S, P = 4, 80
    extr = _cameras(rng, S)
    f = rng.uniform(200, 400, size=(S, 2)).astype(np.float32)
    pp = rng.uniform(100, 150, size=(S, 2)).astype(np.float32)
    intr = np.asarray(jcam.build_intrinsics(jnp.asarray(f), jnp.asarray(pp)))
    pts = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    extra = (None if K is None else
             (rng.normal(size=(S, K)) * 0.02).astype(np.float32))
    jx = None if extra is None else jnp.asarray(extra)
    tx = None if extra is None else _t(extra)

    _close(tcam.camera_centers(_t(extr)),
           jcam.camera_centers(jnp.asarray(extr)))
    j2d, jcam3 = jcam.project_points(jnp.asarray(pts), jnp.asarray(extr),
                                     jnp.asarray(intr), jx,
                                     return_points_cam=True)
    t2d, tcam3 = tcam.project_points(_t(pts), _t(extr), _t(intr), tx,
                                     return_points_cam=True)
    _close(t2d, j2d)
    _close(tcam3, jcam3)
    _close(tcam.project_points(_t(pts), _t(extr), only_points_cam=True),
           jcam3)
    _close(tcam.img_from_cam(_t(intr), tcam3, tx),
           jcam.img_from_cam(jnp.asarray(intr), jcam3, jx))
    back = tcam.cam_from_img(t2d, _t(intr), tx)
    _close(back, jcam.cam_from_img(j2d, jnp.asarray(intr), jx))
    # the round trip lands on the camera-space rays
    ray = (tcam3[:, :2] / tcam3[:, 2:]).transpose(1, 2)
    assert float((back - ray).abs().max()) < 1e-4


def test_img_from_cam_maps_points_at_infinity_to_default(rng):
    intr = np.asarray(jcam.build_intrinsics(jnp.full((2,), 300.0),
                                            jnp.full((2,), 100.0)))
    pc = rng.normal(size=(3, 10)).astype(np.float32)
    pc[2, :3] = 0.0
    got = tcam.img_from_cam(_t(intr), _t(pc), default=-7.0)
    _close(got, jcam.img_from_cam(jnp.asarray(intr), jnp.asarray(pc),
                                  default=-7.0))
    assert float(got[0, 0]) == -7.0


# --------------------------------------------------------------- metrics

def test_relative_pose_errors_and_auc(rng):
    S = 6
    gt = _cameras(rng, S)
    pred = gt.copy()
    pred[:, :, 3] += rng.normal(scale=0.05, size=(S, 3)).astype(np.float32)
    pred[:, :, :3] = np.einsum("sij,sjk->sik", _cameras(rng, S)[:, :, :3],
                               gt[:, :, :3])
    jr, jt, jm = jmet.relative_pose_errors(jnp.asarray(pred),
                                           jnp.asarray(gt))
    tr, tt, tm = tmet.relative_pose_errors(_t(pred), _t(gt))
    # the pairs i < j (a camera against itself has no translation
    # direction); an angle near 0 comes from an arccos near 1, which
    # amplifies the f32 rounding of its argument: compare what was
    # rounded, the cosines
    m = np.array(jm)
    for t, j in ((tr, jr), (tt, jt)):
        _close(torch.cos(torch.deg2rad(t[_t(m)])), np.cos(np.deg2rad(j))[m])
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    for mask in (None, jm):
        tmask = None if mask is None else _t(mask)
        _close(tmet.calculate_auc(tr, tt, tmask),
               jmet.calculate_auc(jnp.asarray(tr.numpy()),
                                  jnp.asarray(tt.numpy()), mask))
    _close(tmet.pose_auc30(_t(pred), _t(gt)),
           jmet.pose_auc30(jnp.asarray(pred), jnp.asarray(gt)))
    assert float(tmet.pose_auc30(_t(gt), _t(gt))) > 0.96


@pytest.mark.parametrize("ambiguity", [True, False])
def test_translation_angle(rng, ambiguity):
    a = rng.normal(size=(40, 3)).astype(np.float32)
    b = rng.normal(size=(40, 3)).astype(np.float32)
    b[:5] = -a[:5]
    t = tmet.translation_angle_deg(_t(a), _t(b), ambiguity=ambiguity)
    j = jmet.translation_angle_deg(jnp.asarray(a), jnp.asarray(b),
                                   ambiguity=ambiguity)
    _close(torch.cos(torch.deg2rad(t)), np.cos(np.deg2rad(j)))


# ------------------------------------------------------------------ eigh

def _sym(rng, batch, n, scale=1.0):
    """Symmetric matrices Q diag(w) Qᵀ, eigenvalues 1..n x scale each
    moved by up to 0.3 x scale (gaps of at least 0.4 x scale)."""
    Q = np.linalg.qr(rng.normal(size=(batch, n, n)))[0]
    w = (np.arange(1, n + 1) + rng.uniform(-0.3, 0.3, size=(batch, n))
         ) * scale
    return np.einsum("bij,bj,bkj->bik", Q, w, Q).astype(np.float32)


def _same_up_to_sign(V, W, atol):
    """Columns equal up to a sign each."""
    s = np.sign(np.sum(V * W, axis=-2, keepdims=True))
    np.testing.assert_allclose(V * s, W, atol=atol)


@pytest.mark.parametrize("n,sweeps", [(3, 8), (4, 6), (9, 8)])
def test_eigh_small(rng, n, sweeps):
    """Both Jacobi orders: one rotation at a time (n <= 6) and the
    parallel rounds (n = 9, the fundamental-matrix normal matrices)."""
    A = _sym(rng, 64, n)
    jw, jV = jeigh.eigh_small(jnp.asarray(A), num_sweeps=sweeps)
    tw, tV = teigh.eigh_small(_t(A), num_sweeps=sweeps)
    norm = np.linalg.norm(A, axis=(-2, -1))[:, None]
    assert np.all(np.abs(tw.numpy() - np.asarray(jw)) <= 1e-4 * norm)
    # eigenvectors of separated eigenvalues (relative gap > 1e-2)
    w = np.asarray(jw)
    gap = np.min(np.diff(w, axis=-1), axis=-1) / norm[:, 0]
    sep = gap > 1e-2
    assert sep.sum() > 32
    _same_up_to_sign(tV.numpy()[sep], np.asarray(jV)[sep], 1e-3)
    # and the factorization holds
    rec = tV @ torch.diag_embed(tw) @ tV.transpose(-1, -2)
    assert float((rec - _t(A)).abs().max()) <= 1e-4 * norm.max()


def test_eigh_unsorted_and_badly_scaled(rng):
    A = _sym(rng, 16, 4, scale=1e3)
    jw, jV = jeigh.eigh_small(jnp.asarray(A), sort=False)
    tw, tV = teigh.eigh_small(_t(A), sort=False)
    norm = np.linalg.norm(A, axis=(-2, -1))[:, None]
    assert np.all(np.abs(tw.numpy() - np.asarray(jw)) <= 1e-4 * norm)


@pytest.mark.parametrize("n", [4, 9])
def test_smallest_eigenvector(rng, n):
    A = _sym(rng, 64, n)
    j = np.asarray(jeigh.smallest_eigenvector(jnp.asarray(A)))
    t = teigh.smallest_eigenvector(_t(A)).numpy()
    w = np.linalg.eigvalsh(A.astype(np.float64))
    sep = (w[:, 1] - w[:, 0]) / w[:, -1] > 1e-2
    s = np.sign(np.sum(j * t, axis=-1, keepdims=True))
    np.testing.assert_allclose((t * s)[sep], j[sep], atol=1e-3)


# ------------------------------------------------------------------ svd3

def test_svd3x3_and_project_rank2(rng):
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A[:16, :, 2] = A[:16, :, 0] + A[:16, :, 1]  # rank 2, as E and F are
    jU, jS, jV = jsvd.svd3x3(jnp.asarray(A))
    tU, tS, tV = tsvd.svd3x3(_t(A))
    norm = np.linalg.norm(A, axis=(-2, -1))
    err = np.abs(tS.numpy() - np.asarray(jS)).max(-1)
    assert np.all(err <= 1e-5 * norm)
    rec = tU @ torch.diag_embed(tS) @ tV.transpose(-1, -2)
    assert np.all((rec - _t(A)).abs().amax((-2, -1)).numpy()
                  <= 1e-5 * norm * 4)
    assert np.allclose(torch.linalg.det(tU).numpy(), 1.0, atol=1e-5)
    assert np.allclose(torch.linalg.det(tV).numpy(), 1.0, atol=1e-5)
    jr = np.asarray(jsvd.project_rank2(jnp.asarray(A)))
    tr = tsvd.project_rank2(_t(A)).numpy()
    assert np.all(np.abs(tr - jr).max((-2, -1)) <= 1e-5 * norm * 4)
    assert np.all(np.abs(np.linalg.det(tr)) <= 1e-4 * norm ** 3)


# ------------------------------------------------------------ polynomial

CUBICS = [[1.0, -6.0, 11.0, -6.0],   # roots 1, 2, 3
          [1.0, 0.0, 1.0, 10.0],     # one real root, -2
          [0.0, 1.0, -3.0, 2.0],     # quadratic: 1, 2
          [0.0, 1.0, 0.0, 1.0],      # quadratic without real roots
          [0.0, 0.0, 2.0, -4.0],     # linear: 2
          [0.0, 0.0, 0.0, 1.0]]      # no root


def test_solve_cubic(rng):
    coeffs = np.concatenate([np.asarray(CUBICS, np.float32),
                             rng.normal(size=(200, 4)).astype(np.float32)])
    jr, jv = jpoly.solve_cubic(jnp.asarray(coeffs))
    tr, tv = tpoly.solve_cubic(_t(coeffs))
    jr, jv = np.asarray(jr), np.asarray(jv)
    assert np.array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tr.numpy()[jv], jr[jv], rtol=1e-4,
                               atol=1e-4)
    got = np.sort(tr.numpy()[0])
    np.testing.assert_allclose(got, [1, 2, 3], atol=1e-4)


# --------------------------------------------------------- triangulation

def _tracks(rng, S, N, noise=0.0):
    extr = _cameras(rng, S)
    extr[0] = np.eye(3, 4)
    pts = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], pts) + extr[:, None, :, 3]
    uv = cam[..., :2] / cam[..., 2:3]
    uv += rng.normal(scale=noise, size=uv.shape).astype(np.float32)
    return extr, pts, uv.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_multiview_dlt(rng, masked):
    S, N = 5, 64
    extr, pts, uv = _tracks(rng, S, N, noise=1e-4)
    cams = np.broadcast_to(extr, (N, S, 3, 4))
    pts_v = uv.transpose(1, 0, 2)  # (N, S, 2)
    mask = (rng.uniform(size=(N, S)) > 0.3).astype(np.float32)
    mask[:, :2] = 1.0
    jm = jnp.asarray(mask) if masked else None
    tm = _t(mask) if masked else None
    j = jtri.multiview_dlt(jnp.asarray(cams), jnp.asarray(pts_v), jm)
    t = ttri.multiview_dlt(_t(cams), _t(pts_v), tm)
    _close(t, j, rtol=1e-4)  # an f32 eigenvector divided by its w
    assert float((t - _t(pts)).abs().max()) < 0.05


def test_cheirality_and_angles(rng):
    S, N = 4, 50
    extr, pts, _ = _tracks(rng, S, N)
    pts[:5, 2] = -pts[:5, 2]  # behind the cameras
    cams = np.broadcast_to(extr, (N, S, 3, 4))
    assert np.array_equal(
        ttri.cheirality_invalid(_t(cams), _t(pts)).numpy(),
        np.asarray(jtri.cheirality_invalid(jnp.asarray(cams),
                                           jnp.asarray(pts))))
    _close(ttri.triangulation_angles(_t(cams), _t(pts)),
           jtri.triangulation_angles(jnp.asarray(cams), jnp.asarray(pts)),
           rtol=1e-4, atol=1e-3)  # degrees, through arccos


def test_triangulate_by_pair(rng):
    S, N = 5, 96
    extr, _, uv = _tracks(rng, S, N, noise=1e-3)
    uv[:, :6] = rng.uniform(-1, 1, size=(S, 6, 2))  # no common point
    jp, jc, ja = jtri.triangulate_by_pair(jnp.asarray(extr),
                                          jnp.asarray(uv))
    tp, tc, ta = ttri.triangulate_by_pair(_t(extr), _t(uv))
    ok = np.asarray(jc)
    assert np.array_equal(tc.numpy(), ok)
    _close(tp[:, 6:], np.asarray(jp)[:, 6:], rtol=1e-4)
    _close(ta, ja, rtol=1e-4, atol=1e-3)
