"""Batched Efficient PnP (EPnP): absolute pose from control-point
barycentric coordinates (PyTorch). Counterpart of
vggsfm_tpu/twoview/epnp.py (reference
vggsfm/two_view_geo/perspective_n_points.py:321-437, `efficient_pnp`,
Moreno-Noguer et al., IJCV 2009; the reference's LORANSAC local
refinement for absolute pose, two_view_geo/pnp.py:140).

The same mechanics as the JAX package:
  * the barycentric coordinates are closed-form: with control points
    c_i = e_i + mean (i = 1..3), c_4 = mean, the alphas are
    [x - mean, 1 - sum(x - mean)];
  * the control points' squared pairwise distances are the constant
    [2, 2, 1, 2, 1, 1];
  * the 12x12 nullspace comes from the batched Jacobi eigensolver
    (`ops/eigh.py`), and the beta least-squares problems (6 x k, k <= 5)
    from ridge-regularized normal equations;
  * the weighted Umeyama alignment (scale and rotation) uses the 3x3 SVD
    of `ops/svd3.py` (proper rotations).

Batched over any leading axes; nothing here reads a tensor on the host.
"""

from __future__ import annotations

import functools

import torch

from vggsfm_tpu_torch.ops.eigh import eigh_small
from vggsfm_tpu_torch.ops.svd3 import svd3x3
from vggsfm_tpu_torch.utils.precision import f32_matmuls

# squared pairwise distances between the 4 control points
# c_i = e_i + m (i = 1..3), c_4 = m, in the pair order
# (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
_CW_DST = (2.0, 2.0, 1.0, 2.0, 1.0, 1.0)
# column indices into the quadratic-term layout
# [B11 B22 B33 B44 B12 B13 B14 B23 B24 B34]
_CASE_COLS = ((0, 4, 5, 6), (0, 4, 1), (0, 4, 1, 5, 7))
_PAIRS4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the points axis: x (..., P, D), w (..., P)."""
    num = (x * w[..., None]).sum(-2)
    return num / torch.clamp(w.sum(-1)[..., None], min=1e-9)


def _umeyama(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor):
    """Weighted similarity alignment s X R + T ~= Y of X, Y (..., P, 3)
    under weights (..., P), row-vector convention (pytorch3d
    corresponding_points_alignment with estimate_scale=True) -> (R
    (..., 3, 3), T (..., 3), s (...,))."""
    Xm, Ym = _wmean(X, w), _wmean(Y, w)
    Xc = X - Xm[..., None, :]
    Yc = Y - Ym[..., None, :]
    M = torch.matmul((Xc * w[..., None]).transpose(-1, -2), Yc)
    U, S, V = svd3x3(M)
    R = torch.matmul(U, V.transpose(-1, -2))  # det +1
    xvar = (w[..., None] * Xc * Xc).sum((-1, -2))
    s = S.sum(-1) / torch.clamp(xvar, min=1e-12)
    T = Ym - s[..., None] * torch.matmul(Xm[..., None, :], R)[..., 0, :]
    return R, T, s


@functools.lru_cache(maxsize=None)
def _cw_dst(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """_CW_DST on `device`, made once per (dtype, device): a host-to-device
    copy waits for the device."""
    return torch.tensor(_CW_DST, dtype=dtype, device=device)


def _solve_case(kernel_dsts: torch.Tensor, cols, ridge: float = 1e-9):
    """Least squares over the quadratic-term columns `cols`: beta (..., k)
    with kernel_dsts[..., cols] @ beta ~= the control distances, by the
    ridge-regularized normal equations (no singularity check: that is a
    host sync on the GPU)."""
    # slices, not a list index: that would be copied to the device
    A = torch.stack([kernel_dsts[..., c] for c in cols], dim=-1)  # (.., 6, k)
    b = _cw_dst(A.dtype, A.device)
    AtA = torch.matmul(A.transpose(-1, -2), A)
    Atb = (A * b[:, None]).sum(-2)
    AtA = AtA + ridge * torch.eye(len(cols), dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]


def _bsign(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 0, 1.0, -1.0).to(t.dtype)


def _coords_case1(beta: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """[B11 B12 B13 B14] -> all four coordinates over sqrt(B11)."""
    beta = beta * _bsign(beta[..., :1])
    return beta / torch.clamp(torch.sqrt(beta[..., :1]), min=eps)


def _coords_case2(beta: torch.Tensor) -> torch.Tensor:
    """[B11 B12 B22] -> [sqrt|B11| sign(B12), gated sqrt|B22|, 0, 0]."""
    c0 = torch.sqrt(beta[..., 0].abs()) * _bsign(beta[..., 1])
    same = ((beta[..., 0] >= 0) == (beta[..., 2] >= 0)).to(beta.dtype)
    c1 = torch.sqrt(beta[..., 2].abs()) * same
    z = torch.zeros_like(c0)
    return torch.stack([c0, c1, z, z], dim=-1)


def _coords_case3(beta: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """[B11 B12 B22 B13 B23] -> [c0, c1, B13 / c0, 0]."""
    c0 = torch.sqrt(beta[..., 0].abs()) * _bsign(beta[..., 1])
    same = ((beta[..., 0] >= 0) == (beta[..., 2] >= 0)).to(beta.dtype)
    c1 = torch.sqrt(beta[..., 2].abs()) * same
    c2 = beta[..., 3] / torch.where(c0.abs() < eps, eps, c0)
    return torch.stack([c0, c1, c2, torch.zeros_like(c0)], dim=-1)


def _score_candidate(c_cam, alphas, x_world, y, w):
    """Resolve one control-point candidate's scale and sign and score it:
    c_cam (..., 4, 3) control points in camera coordinates (up to scale
    and sign) -> (R, T, err_2d), row-vector convention
    (x_world @ R + T ~ camera coordinates, as the reference's
    EpnpSolution)."""
    x_cam = torch.matmul(alphas, c_cam)  # (..., P, 3)
    # the global sign: the weighted mean depth must be positive
    zmean = _wmean(x_cam[..., 2:], w)[..., 0]
    x_cam = x_cam * torch.where(zmean < 0, -1.0, 1.0)[..., None, None]

    R, T, s = _umeyama(x_world, x_cam, w)
    T = T / torch.clamp(s, min=1e-9)[..., None]
    x_rot = torch.matmul(x_world, R) + T[..., None, :]

    proj = x_rot[..., :2] / torch.clamp(x_rot[..., 2:], min=1e-9)
    dist = torch.sqrt(((y - proj) ** 2).sum(-1))
    err_2d = (dist * w).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)
    return R, T, err_2d


@f32_matmuls
def efficient_pnp(x: torch.Tensor, y: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  num_sweeps: int = 12) -> dict:
    """EPnP absolute pose, batched over any leading axes: world points
    x (..., P, 3), normalized (intrinsics-free) image points y (..., P, 2),
    optional non-negative weights or inlier mask (..., P).

    Returns dict ``extrinsics`` (..., 3, 4), world->cam in the
    column-vector convention (Xc = R Xw + t), and ``err_2d`` (...,), the
    weighted mean normalized reprojection distance of the winner. Four
    candidates (the raw kernel vector and 3 quadratic beta cases) are
    scored by reprojection error; the best wins per batch element."""
    P = x.shape[-2]
    lead = x.shape[:-2]
    w = (torch.ones(lead + (P,), dtype=x.dtype, device=x.device)
         if weights is None else weights.to(x.dtype))

    m = _wmean(x, w)
    a123 = x - m[..., None, :]
    alphas = torch.cat([a123, 1.0 - a123.sum(-1, keepdim=True)], dim=-1)
    aw = alphas * w[..., None]  # the weighted alphas (reference _build_M)

    # the rows of M: per point a u-row with per-control-point coefficients
    # (1, 0, -u) and a v-row (0, 1, -v); unknowns (4 control points) x
    # (x, y, z). MtM = Muᵀ Mu + Mvᵀ Mv
    u, v = y[..., 0:1], y[..., 1:2]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    cu = torch.cat([one, zero, -u], dim=-1)  # (..., P, 3)
    cv = torch.cat([zero, one, -v], dim=-1)
    Mu = (aw[..., :, None] * cu[..., None, :]).reshape(lead + (P, 12))
    Mv = (aw[..., :, None] * cv[..., None, :]).reshape(lead + (P, 12))
    MtM = (torch.matmul(Mu.transpose(-1, -2), Mu)
           + torch.matmul(Mv.transpose(-1, -2), Mv))

    _, V = eigh_small(MtM, num_sweeps=num_sweeps, sort=True)  # ascending
    # the smallest 4 eigenvectors, as (..., control point, xyz, 4)
    kernel = V[..., :4].reshape(lead + (4, 3, 4))

    # pairwise differences of the kernel vectors across control points
    dv = torch.stack([kernel[..., i, :, :] - kernel[..., j, :, :]
                      for i, j in _PAIRS4], dim=-3)  # (..., 6, 3, 4)
    rows_ii = (dv * dv).sum(-2)  # (..., 6, 4)
    rows_2ij = 2.0 * torch.stack(
        [(dv[..., i] * dv[..., j]).sum(-1) for i, j in _PAIRS4],
        dim=-1)  # (..., 6, 6)
    kernel_dsts = torch.cat([rows_ii, rows_2ij], dim=-1)

    coords = [
        _coords_case1(_solve_case(kernel_dsts, _CASE_COLS[0])),
        _coords_case2(_solve_case(kernel_dsts, _CASE_COLS[1])),
        _coords_case3(_solve_case(kernel_dsts, _CASE_COLS[2])),
    ]
    cands = [kernel[..., 0]] + [(kernel * c[..., None, None, :]).sum(-1)
                                for c in coords]

    Rs, Ts, errs = zip(*(_score_candidate(c, alphas, x, y, w)
                         for c in cands))
    err = torch.stack(errs, dim=-1)  # (..., 4)
    best = torch.argmin(err, dim=-1)
    Rbest = torch.take_along_dim(torch.stack(Rs, dim=-3),
                                 best[..., None, None, None], dim=-3)[
        ..., 0, :, :]
    Tbest = torch.take_along_dim(torch.stack(Ts, dim=-2),
                                 best[..., None, None], dim=-2)[..., 0, :]
    err_best = torch.take_along_dim(err, best[..., None], dim=-1)[..., 0]

    # row-vector (x @ R + T) -> the column-vector extrinsic [Rᵀ | T]
    extr = torch.cat([Rbest.transpose(-1, -2), Tbest[..., None]], dim=-1)
    return {"extrinsics": extr, "err_2d": err_best}
