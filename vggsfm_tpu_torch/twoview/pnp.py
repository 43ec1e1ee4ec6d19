"""Absolute pose (PnP) by batched DLT and LORANSAC with a focal sweep
(PyTorch). Counterpart of vggsfm_tpu/twoview/pnp.py (reference
vggsfm/two_view_geo/pnp.py:38-231, COLMAP's focal-sweep absolute pose
estimation with fixed budgets).

The minimal solver is a 6-point DLT: the smallest eigenvector of the
12x12 normal matrix (`ops/eigh.py`), its rotation factor projected to
SO(3) by the 3x3 SVD (`ops/svd3.py`). Local refinement re-solves the same
DLT over each candidate's inlier set, mask-weighted (`refine="dlt"`).
The minimal sets come from the caller's `torch.Generator` or are given as
`sample_idx`; the trial-chunked counting pass is a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch

from vggsfm_tpu_torch.extractors.dog import top_k_stable
from vggsfm_tpu_torch.ops.eigh import smallest_eigenvector
from vggsfm_tpu_torch.ops.svd3 import svd3x3
from vggsfm_tpu_torch.twoview.utils import (
    BIG_RESIDUAL,
    generate_samples,
    residual_indicator,
    trial_validity,
)
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def generate_focal_factors(num_samples: int = 50, max_ratio: float = 5.0,
                           min_ratio: float = 0.2) -> np.ndarray:
    """COLMAP's quadratic focal sweep, then 1.0 (pnp.py:216-231)."""
    out = []
    fstep = 1.0 / num_samples
    fscale = max_ratio - min_ratio
    focal = 0.0
    for _ in range(num_samples):
        out.append(min_ratio + fscale * focal * focal)
        focal += fstep
    out.append(1.0)
    return np.asarray(out, np.float32)


def _dlt_normal_matrix(points3D, points2D_norm, weights):
    """The 12x12 DLT normal matrix AᵀA of one point block: rows
    [X 0 -uX ; 0 X -vX] for P = [p1; p2; p3], each weighted."""
    Xh = torch.cat([points3D, torch.ones_like(points3D[..., :1])], dim=-1)
    Xh = Xh.expand(*points2D_norm.shape[:-1], 4)
    u = points2D_norm[..., 0:1]
    v = points2D_norm[..., 1:2]
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -u * Xh], dim=-1)  # (..., P, 12)
    r2 = torch.cat([zero, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2P, 12)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    return torch.matmul(A.transpose(-1, -2), A)


@f32_matmuls
def solve_pnp_dlt(points3D: torch.Tensor, points2D_norm: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  point_chunk: int | None = None) -> torch.Tensor:
    """DLT absolute pose from >= 6 correspondences, batched: world points
    (..., P, 3), normalized image points (..., P, 2), optional weights
    (..., P) -> world-to-camera (..., 3, 4), R projected to SO(3) and t
    rescaled by the mean singular value. `point_chunk` accumulates AᵀA
    over point blocks, so one block's design matrix is the peak."""
    P = points3D.shape[-2]
    if point_chunk is not None and P > point_chunk:
        AtA = 0
        for s in range(0, P, point_chunk):
            sl = slice(s, s + point_chunk)
            AtA = AtA + _dlt_normal_matrix(
                points3D[..., sl, :], points2D_norm[..., sl, :],
                weights[..., sl] if weights is not None else None)
    else:
        AtA = _dlt_normal_matrix(points3D, points2D_norm, weights)
    p = smallest_eigenvector(AtA, num_sweeps=10)  # (..., 12)
    P_mat = p.reshape(*p.shape[:-1], 3, 4)

    # the nullspace sign is arbitrary: the majority of the (weighted)
    # points must land at positive depth
    Xh = torch.cat([points3D, torch.ones_like(points3D[..., :1])], dim=-1)
    z = (P_mat[..., None, 2, :] * Xh).sum(-1)
    zsign = torch.sign(z)
    if weights is not None:
        zsign = zsign * weights
    flip = torch.where(zsign.sum(-1) < 0, -1.0, 1.0)
    P_mat = P_mat * flip[..., None, None]

    U, S, V = svd3x3(P_mat[..., :3])
    scale = torch.clamp(S.mean(-1, keepdim=True), min=1e-12)
    R = (U[..., :, None, :] * V[..., None, :, :]).sum(-1)  # U Vᵀ
    t = P_mat[..., 3] / scale
    return torch.cat([R, t[..., None]], dim=-1)


def _reproj_residuals(extrinsic, points3D, points2D_norm):
    """Squared normalized reprojection errors: poses (..., 3, 4), points
    (..., P, 3) and (..., P, 2) -> (..., P); behind the camera
    BIG_RESIDUAL."""
    Xc = (torch.matmul(points3D, extrinsic[..., :3].transpose(-1, -2))
          + extrinsic[..., None, :, 3])
    z = Xc[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    proj = Xc[..., :2] / z_safe[..., None]
    res = ((proj - points2D_norm) ** 2).sum(-1)
    return torch.where(z <= 0, BIG_RESIDUAL, res)


@f32_matmuls
def absolute_pose_ransac(points3D: torch.Tensor, points2D: torch.Tensor,
                         intrinsics: torch.Tensor,
                         generator: torch.Generator | None = None,
                         valid_mask: torch.Tensor | None = None,
                         max_error: float = 8.0,
                         max_ransac_iters: int = 256,
                         lo_num: int = 32,
                         f_trials: int = 17,
                         refine: str = "dlt",
                         sample_idx: torch.Tensor | None = None) -> dict:
    """LORANSAC PnP with a focal sweep over batched frames: world points
    (B, P, 3), pixels (B, P, 2), intrinsics (B, 3, 3), optional validity
    (B, P). The (max_ransac_iters, 6) minimal sets are drawn from
    `generator` or given as `sample_idx`. `refine` is the local
    refinement over each candidate's inlier set: 'dlt' (the mask-weighted
    DLT re-solve); the JAX package's 'epnp' is not ported.

    Returns dict ``extrinsics (B, 3, 4)``, ``intrinsics (B, 3, 3)``,
    ``inlier_num (B,)``, ``inlier_mask (B, P)``."""
    if refine != "dlt":
        raise ValueError(f"PnP refine mode {refine!r} is not available in "
                         f"the port (only 'dlt')")
    B, P, _ = points3D.shape
    dev = points3D.device
    fl = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1]], dim=-1)
    pp = intrinsics[:, :2, 2]
    if valid_mask is None:
        valid_mask = torch.ones((B, P), dtype=torch.bool, device=dev)

    factors = (torch.as_tensor(generate_focal_factors(f_trials - 1),
                               device=dev)
               if f_trials > 1 else torch.ones(1, device=dev))
    F = factors.shape[0]
    BF = B * F

    p2n = (points2D - pp[:, None]) / fl[:, None]
    p2f = (p2n[:, None] / factors[None, :, None, None]).reshape(BF, P, 2)
    p3f = points3D[:, None].expand(B, F, P, 3).reshape(BF, P, 3)
    vf = valid_mask[:, None].expand(B, F, P).reshape(BF, P)
    max_thres = (max_error / torch.clamp(fl.mean(-1), min=1e-6)) ** 2
    thres_bf = (max_thres[:, None] / factors[None, :] ** 2).reshape(BF)

    if sample_idx is None:
        sample_idx, trial_valid = generate_samples(
            generator, P, max_ransac_iters, 6, device=dev)
    else:
        sample_idx = sample_idx.to(dev)
        trial_valid = trial_validity(sample_idx)
    pose_cand = solve_pnp_dlt(p3f[:, sample_idx],
                              p2f[:, sample_idx])  # (BF, R, 3, 4)

    # the counting pass over trial chunks: the (BF, R, P, 3) camera-space
    # points of every trial at once would not fit at the 17-focal sweep;
    # only each trial's inlier count is needed before the top-k
    nums = []
    for s in range(0, max_ransac_iters, 32):
        r = _reproj_residuals(pose_cand[:, s:s + 32], p3f[:, None],
                              p2f[:, None])
        r = torch.where(vf[:, None] & trial_valid[None, s:s + 32, None], r,
                        BIG_RESIDUAL)
        nums.append((r <= thres_bf[:, None, None]).sum(-1))
    num = torch.cat(nums, dim=1)  # (BF, R)

    sel = top_k_stable(num, lo_num)[1]  # jax.lax.top_k's order
    pose_sel = torch.take_along_dim(pose_cand, sel[..., None, None], dim=1)
    res_sel = _reproj_residuals(pose_sel, p3f[:, None], p2f[:, None])
    tv_sel = trial_valid[sel]  # (BF, lo)
    res_sel = torch.where(vf[:, None] & tv_sel[..., None], res_sel,
                          BIG_RESIDUAL)
    inl_sel = res_sel <= thres_bf[:, None, None]  # (BF, lo, P)

    pose_lo = solve_pnp_dlt(p3f[:, None].expand(BF, lo_num, P, 3),
                            p2f[:, None].expand(BF, lo_num, P, 2),
                            inl_sel.to(p3f.dtype), point_chunk=2048)
    res_lo = _reproj_residuals(pose_lo, p3f[:, None], p2f[:, None])
    res_lo = torch.where(vf[:, None], res_lo, BIG_RESIDUAL)
    inl_lo = res_lo <= thres_bf[:, None, None]
    num_lo = inl_lo.sum(-1)
    mean_lo = (torch.where(inl_lo, res_lo, 0.0).sum(-1)
               / torch.clamp(num_lo, min=1))

    # the focal trials folded into the candidate axis of each frame
    poses = pose_lo.reshape(B, F * lo_num, 3, 4)
    scale = torch.ones(F, 3, 3, device=dev)
    scale[:, 0, 0] = factors
    scale[:, 1, 1] = factors
    intr_all = (intrinsics[:, None] * scale[None])[:, :, None].expand(
        B, F, lo_num, 3, 3).reshape(B, F * lo_num, 3, 3)
    score = residual_indicator(num_lo.reshape(B, F * lo_num),
                               mean_lo.reshape(B, F * lo_num))
    best = torch.argmax(score, dim=1)
    ar = torch.arange(B, device=dev)
    best_inl = inl_lo.reshape(B, F * lo_num, P)[ar, best]
    return {"extrinsics": poses[ar, best], "intrinsics": intr_all[ar, best],
            "inlier_num": best_inl.sum(-1), "inlier_mask": best_inl}
