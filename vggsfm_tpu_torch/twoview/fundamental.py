"""Batched 7-point / 8-point fundamental-matrix estimation with LORANSAC
(PyTorch). Counterpart of vggsfm_tpu/twoview/fundamental.py (reference
vggsfm/two_view_geo/fundamental.py:43-183, :254-333, :341-469).

The nullspaces come from the batched Jacobi eigensolver on the 9x9 normal
matrix AᵀA (`ops/eigh.py`); the 7-point det constraint is expanded by the
multilinearity of det over columns. Candidates are scored in chunks and
refined in chunks (Python loops over the JAX package's chunks), keeping
per-candidate scalars only: no (pairs, 3 x iters, N) residual tensor is
formed. Selection is by a stable descending sort (`jax.lax.top_k`'s
order among equal inlier counts) and a first-maximum argmax, so both
devices pick the same candidates from the same scores.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.geometry.cameras import _mm
from vggsfm_tpu_torch.ops.eigh import eigh_small, smallest_eigenvector
from vggsfm_tpu_torch.ops.polynomial import solve_cubic
from vggsfm_tpu_torch.ops.svd3 import project_rank2
from vggsfm_tpu_torch.twoview.utils import (
    BIG_RESIDUAL,
    generate_samples,
    normalize_points_masked,
    residual_indicator,
    sampson_epipolar_distance,
    trial_validity,
)
from vggsfm_tpu_torch.utils import trace
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def _corr_rows(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """Epipolar constraint rows [x'x, x'y, x', y'x, y'y, y', x, y, 1]."""
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _denormalize(F: torch.Tensor, t1: torch.Tensor,
                 t2: torch.Tensor) -> torch.Tensor:
    """T2ᵀ F T1, Frobenius-normalized (the scale is a gauge)."""
    F = _mm(_mm(t2.transpose(-1, -2), F), t1)
    return F / torch.clamp(torch.linalg.vector_norm(F, dim=(-2, -1),
                                                    keepdim=True), min=1e-12)


@f32_matmuls
def run_8point(points1: torch.Tensor, points2: torch.Tensor,
               masks: torch.Tensor | None = None) -> torch.Tensor:
    """Masked normalized 8-point DLT -> rank-2 F: (..., N, 2) x2 ->
    (..., 3, 3)."""
    if masks is None:
        masks = torch.ones_like(points1[..., 0])
    p1n, t1 = normalize_points_masked(points1, masks)
    p2n, t2 = normalize_points_masked(points2, masks)
    X = _corr_rows(p1n, p2n) * masks[..., None]
    XtX = torch.matmul(X.transpose(-1, -2), X)
    f = smallest_eigenvector(XtX, num_sweeps=8)
    F = project_rank2(f.reshape(*f.shape[:-1], 3, 3))
    return _denormalize(F, t1, t2)


def _det_cols(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """det of the 3x3 matrix with columns a, b, c (each (..., 3))."""
    return (a * torch.linalg.cross(b, c)).sum(-1)


@f32_matmuls
def run_7point(points1: torch.Tensor, points2: torch.Tensor):
    """7-point solver: (B, 7, 2) x2 -> (F (B, 3, 3, 3), valid (B, 3)); up
    to three fundamental matrices per minimal set (the real roots of the
    cubic det constraint), invalid root slots masked."""
    p1n, t1 = normalize_points_masked(points1)
    p2n, t2 = normalize_points_masked(points2)
    A = _corr_rows(p1n, p2n)  # (B, 7, 9)
    _, V = eigh_small(torch.matmul(A.transpose(-1, -2), A), num_sweeps=8,
                      sort=True)
    f2 = V[..., :, 0].reshape(-1, 3, 3)  # smallest
    f1 = V[..., :, 1].reshape(-1, 3, 3)  # second smallest

    # det(lambda f1 + f2) = 0: a cubic in lambda, column by column
    a1, b1, c1 = f1[..., :, 0], f1[..., :, 1], f1[..., :, 2]
    a2, b2, c2 = f2[..., :, 0], f2[..., :, 1], f2[..., :, 2]
    c3 = _det_cols(a1, b1, c1)
    c2_ = (_det_cols(a2, b1, c1) + _det_cols(a1, b2, c1)
           + _det_cols(a1, b1, c2))
    c1_ = (_det_cols(a2, b2, c1) + _det_cols(a2, b1, c2)
           + _det_cols(a1, b2, c2))
    c0 = _det_cols(a2, b2, c2)
    roots, valid = solve_cubic(torch.stack([c3, c2_, c1_, c0], dim=-1))
    F = (roots[..., :, None, None] * f1[..., None, :, :]
         + f2[..., None, :, :])  # (B, 3, 3, 3)
    return _denormalize(F, t1[..., None, :, :], t2[..., None, :, :]), valid


def _residuals(points1, points2, F_chunk, point_valid, squared):
    """(B, chunk, N) Sampson residuals, BIG_RESIDUAL at unusable points."""
    res = sampson_epipolar_distance(points1, points2, F_chunk,
                                    squared=squared)
    return torch.where(point_valid[:, None, :], res, BIG_RESIDUAL)


def _stream_scores(points1, points2, Fs, cand_valid, point_valid, thres,
                   chunk, squared):
    """Per-candidate (inlier_num, mean inlier residual) of (B, C)
    candidates, `chunk` candidates at a time; invalid candidates count no
    inliers."""
    nums, means = [], []
    for s in range(0, Fs.shape[1], chunk):
        res = _residuals(points1, points2, Fs[:, s: s + chunk], point_valid,
                         squared)
        inl = res <= thres
        num = inl.sum(-1)
        mean = torch.where(inl, res, 0.0).sum(-1) / torch.clamp(num, min=1)
        v = cand_valid[:, s: s + chunk]
        nums.append(torch.where(v, num, 0))
        means.append(torch.where(v, mean, 0.0))
    return torch.cat(nums, dim=1), torch.cat(means, dim=1)


def _stream_local_refine(points1, points2, Fs_sel, point_valid, thres,
                         chunk, squared):
    """8-point refinement of (B, L) selected candidates, `chunk` at a
    time: each candidate's inlier mask, then the masked DLT."""
    out = []
    for s in range(0, Fs_sel.shape[1], chunk):
        inl = _residuals(points1, points2, Fs_sel[:, s: s + chunk],
                         point_valid, squared) <= thres  # (B, chunk, N)
        shape = (*inl.shape, 2)
        out.append(run_8point(points1[:, None].expand(shape),
                              points2[:, None].expand(shape),
                              inl.to(points1.dtype)))
    return torch.cat(out, dim=1)


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of (B, C) scores, the lower index first
    among equal scores (`jax.lax.top_k`'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :k]


def _take(Fs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Fs (B, C, 3, 3) at idx (B, K) -> (B, K, 3, 3)."""
    return torch.take_along_dim(Fs, idx[..., None, None], dim=1)


def estimate_fundamental(points1: torch.Tensor, points2: torch.Tensor,
                         generator: torch.Generator | None = None,
                         max_ransac_iters: int = 1024,
                         max_error: float = 0.5, lo_num: int = 128,
                         valid_mask: torch.Tensor | None = None,
                         squared: bool = True, second_refine: bool = True,
                         chunk: int = 128,
                         sample_idx: torch.Tensor | None = None):
    """LORANSAC fundamental-matrix estimation over batched pairs.

    points1, points2: (B, N, 2) correspondences per pair; valid_mask:
    optional (B, N) bool of usable correspondences. The minimal sets,
    shared across the batch, are drawn from `generator`, or given as
    `sample_idx` (max_ransac_iters, 7). Returns a dict with ``fmat``
    (B, 3, 3), ``inlier_num`` (B,), ``inlier_mask`` (B, N) and
    ``residuals`` (B, N). Its parts are the tracer's spans
    ``preliminary.sample`` (the minimal sets and the 7-point solve),
    ``preliminary.score`` (the candidates' scores; the best one's
    inliers) and ``preliminary.refine`` (both rounds of local
    optimisation).
    """
    B, N, _ = points1.shape
    dev = points1.device
    thres = max_error ** 2 if squared else max_error
    if valid_mask is None:
        valid_mask = torch.ones(B, N, dtype=torch.bool, device=dev)
    with trace.span("preliminary.sample"):
        if sample_idx is None:
            sample_idx, trial_valid = generate_samples(
                generator, N, max_ransac_iters, 7, device=dev)
        else:
            sample_idx = sample_idx.to(dev)
            trial_valid = trial_validity(sample_idx)
        iters = sample_idx.shape[0]
        flat = sample_idx.reshape(-1)
        left = points1[:, flat].reshape(-1, 7, 2)
        right = points2[:, flat].reshape(-1, 7, 2)

        F7, root_valid = run_7point(left, right)
        F7 = F7.reshape(B, iters * 3, 3, 3)
        cand_valid = (root_valid.reshape(B, iters, 3)
                      & trial_valid[None, :, None]).reshape(B, -1)
    with trace.span("preliminary.score"):
        num0, mean0 = _stream_scores(points1, points2, F7, cand_valid,
                                     valid_mask, thres, chunk, squared)

    with trace.span("preliminary.refine"):
        # local refinement, round 1
        sel1 = _top_k(torch.where(cand_valid, num0, -1), lo_num)
        F_lo1 = _stream_local_refine(points1, points2, _take(F7, sel1),
                                     valid_mask, thres, min(chunk, 32),
                                     squared)
        valid1 = torch.ones(F_lo1.shape[:2], dtype=torch.bool, device=dev)
        num1, mean1 = _stream_scores(points1, points2, F_lo1, valid1,
                                     valid_mask, thres, chunk, squared)
        all_F, all_num, all_mean, all_valid = ([F7, F_lo1], [num0, num1],
                                               [mean0, mean1],
                                               [cand_valid, valid1])

        # local refinement, round 2, on the best refined candidates
        if second_refine:
            sel2 = _top_k(num1, lo_num // 2)
            F_lo2 = _stream_local_refine(points1, points2,
                                         _take(F_lo1, sel2), valid_mask,
                                         thres, min(chunk, 32), squared)
            valid2 = torch.ones(F_lo2.shape[:2], dtype=torch.bool,
                                device=dev)
            num2, mean2 = _stream_scores(points1, points2, F_lo2, valid2,
                                         valid_mask, thres, chunk, squared)
            all_F.append(F_lo2)
            all_num.append(num2)
            all_mean.append(mean2)
            all_valid.append(valid2)

    with trace.span("preliminary.score"):
        F_all = torch.cat(all_F, dim=1)
        score = residual_indicator(torch.cat(all_num, dim=1),
                                   torch.cat(all_mean, dim=1),
                                   torch.cat(all_valid, dim=1))
        best = torch.argmax(score, dim=1)  # the first maximum
        best_F = _take(F_all, best[:, None])[:, 0]

        res_best = _residuals(points1, points2, best_F[:, None],
                              valid_mask, squared)[:, 0]
        inlier_mask = res_best <= thres
    return {"fmat": best_F, "inlier_num": inlier_mask.sum(-1),
            "inlier_mask": inlier_mask, "residuals": res_best}
