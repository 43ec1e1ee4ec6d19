"""Shared two-view utilities (PyTorch): sampling, normalization, Sampson
distance, the candidate score, two-view triangulation and cheirality.
Counterpart of vggsfm_tpu/twoview/utils.py (reference
vggsfm/two_view_geo/utils.py:39-253, :325-448).

RANSAC minimal sets are drawn from the caller's `torch.Generator`; a trial
whose set repeats an index is masked invalid, not redrawn (static shapes).
The products are written out elementwise or run under `f32_matmuls`.
"""

from __future__ import annotations

import math

import torch

from vggsfm_tpu_torch.ops.eigh import smallest_eigenvector
from vggsfm_tpu_torch.utils.precision import f32_matmuls

BIG_RESIDUAL = 1e6


def trial_validity(idx: torch.Tensor) -> torch.Tensor:
    """(trials, k) sample indices -> (trials,) True where no index
    repeats."""
    srt = torch.sort(idx, dim=-1).values
    return ~(srt[:, 1:] == srt[:, :-1]).any(-1)


def generate_samples(generator: torch.Generator, n_points: int,
                     num_trials: int, sample_size: int, device=None):
    """Random minimal sets: ((num_trials, sample_size) indices on `device`,
    (num_trials,) validity). Drawn on the generator's device, so a CPU
    generator gives the same sets to every device."""
    idx = torch.randint(0, n_points, (num_trials, sample_size),
                        generator=generator, device=generator.device)
    idx = idx.to(device or generator.device)
    return idx, trial_validity(idx)


def normalize_points_masked(points: torch.Tensor,
                            masks: torch.Tensor | None = None,
                            eps: float = 1e-8, colmap_style: bool = False):
    """Hartley normalization of (..., N, 2) points honoring a validity
    mask: (points_norm (..., N, 2), transform (..., 3, 3)) with
    ``points_norm = transform @ [points; 1]``; masked-out points do not
    move the mean or the scale."""
    if masks is None:
        masks = torch.ones_like(points[..., 0])
    m = masks.to(points.dtype)[..., None]
    num_valid = m.sum(-2, keepdim=True)
    mean = (points * m).sum(-2, keepdim=True) / (num_valid + eps)
    diffs = (points - mean) * m
    if colmap_style:
        rms = torch.sqrt((diffs ** 2).sum((-1, -2))
                         / (num_valid[..., 0, 0] + eps))
        scale = math.sqrt(2.0) / torch.clamp(rms, min=eps)
    else:
        mean_dist = (torch.linalg.vector_norm(diffs, dim=-1).sum(-1)
                     / (num_valid[..., 0, 0] + eps))
        scale = math.sqrt(2.0) / (mean_dist + eps)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    transform = torch.stack([
        scale, zero, -scale * mean[..., 0, 0],
        zero, scale, -scale * mean[..., 0, 1],
        zero, zero, one], dim=-1).reshape(*scale.shape, 3, 3)
    return (points - mean) * scale[..., None, None], transform


@f32_matmuls
def sampson_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                              Fm: torch.Tensor, squared: bool = True,
                              eps: float = 1e-8) -> torch.Tensor:
    """Sampson distance of correspondences (B, N, 2) x2 under candidate
    fundamental matrices (B, K, 3, 3) -> (B, K, N), squared by default.
    F x1 and Fᵀ x2 of all K candidates are one batched product each."""
    B, K = Fm.shape[:2]
    ones = torch.ones_like(pts1[..., :1])
    p1 = torch.cat([pts1, ones], dim=-1).transpose(-1, -2)  # (B, 3, N)
    p2 = torch.cat([pts2, ones], dim=-1).transpose(-1, -2)
    F_p1 = torch.bmm(Fm.reshape(B, K * 3, 3), p1).reshape(B, K, 3, -1)
    Ft_p2 = torch.bmm(Fm.transpose(-1, -2).reshape(B, K * 3, 3),
                      p2).reshape(B, K, 3, -1)
    num = (p2[:, None, 0] * F_p1[:, :, 0] + p2[:, None, 1] * F_p1[:, :, 1]
           + F_p1[:, :, 2])  # x2ᵀ F x1
    denom = (F_p1[:, :, 0] ** 2 + F_p1[:, :, 1] ** 2
             + Ft_p2[:, :, 0] ** 2 + Ft_p2[:, :, 1] ** 2)
    out = num ** 2 / (denom + eps)
    if squared:
        return out
    return torch.sqrt(torch.clamp(out, min=0.0) + eps)


def residual_indicator(inlier_num: torch.Tensor,
                       inlier_mean_residual: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Candidate score: the inlier count, tie-broken by the mean inlier
    residual (inlier_num + (t - mean)/t with t = max(mean) + 1e-6, so the
    fraction never reorders counts); invalid candidates score -1."""
    mean = torch.where(inlier_num > 0, inlier_mean_residual, BIG_RESIDUAL)
    thres = mean.amax(-1, keepdim=True) + 1e-6
    score = (inlier_num.to(torch.float32)
             + ((thres - mean) / thres).to(torch.float32))
    if valid is not None:
        score = torch.where(valid, score, -1.0)
    return score


@f32_matmuls
def triangulate_point_pair(cam1: torch.Tensor, cam2: torch.Tensor,
                           points1: torch.Tensor,
                           points2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT: cameras (B, 3, 4) x2, points (B, N, 2) x2 -> world
    points (B, N, 3), the smallest eigenvector of the 4x4 AᵀA."""
    def rows(cam, pts):  # -> (B, N, 2, 4)
        r0 = pts[..., 0:1] * cam[:, None, 2, :] - cam[:, None, 0, :]
        r1 = pts[..., 1:2] * cam[:, None, 2, :] - cam[:, None, 1, :]
        return torch.stack([r0, r1], dim=-2)

    A = torch.cat([rows(cam1, points1), rows(cam2, points2)], dim=-2)
    X = smallest_eigenvector(torch.matmul(A.transpose(-1, -2), A))
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12,
                                    torch.sign(w) + (w == 0).to(w.dtype), w)


def check_cheirality(R: torch.Tensor, t: torch.Tensor,
                     points1: torch.Tensor, points2: torch.Tensor):
    """Points with positive bounded depth in both views: R (B, 3, 3),
    t (B, 3), normalized points (B, N, 2) x2 -> (valid count (B,),
    points3D (B, N, 3))."""
    B = R.shape[0]
    eye34 = torch.eye(3, 4, dtype=R.dtype, device=R.device).expand(B, 3, 4)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_point_pair(eye34, P2, points1, points2)
    d1 = X[..., 2]
    d2 = (P2[:, None, 2, :3] * X).sum(-1) + P2[:, None, 2, 3]
    min_depth = torch.finfo(R.dtype).eps
    Rt_t = (R * t[..., :, None]).sum(-2)  # Rᵀ t
    max_depth = 1000.0 * torch.linalg.vector_norm(Rt_t, dim=-1,
                                                  keepdim=True)
    ok = ((d1 > min_depth) & (d1 < max_depth)
          & (d2 > min_depth) & (d2 < max_depth))
    return ok.sum(-1), X
