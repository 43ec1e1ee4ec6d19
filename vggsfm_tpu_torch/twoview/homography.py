"""Homography estimation (4-point DLT, LORANSAC) and the Malis-Vargas
decomposition (PyTorch). Counterpart of vggsfm_tpu/twoview/homography.py
(reference vggsfm/two_view_geo/homography.py:53-418 and the one-way
transfer error of two_view_geo/utils.py:533-581). No pipeline stage calls
them (the reference's default path has `predict_homo=False`).

The DLT's nullspace is the smallest eigenvector of the 9x9 normal matrix
(`ops/eigh.py`); the decomposition is branch-free, its three index cases
selected by weights. The minimal sets come from the caller's
`torch.Generator` or are given as `sample_idx`. Nothing here reads a
tensor on the host.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.extractors.dog import top_k_stable
from vggsfm_tpu_torch.ops.eigh import smallest_eigenvector
from vggsfm_tpu_torch.ops.svd3 import svd3x3
from vggsfm_tpu_torch.twoview.utils import (
    BIG_RESIDUAL,
    generate_samples,
    normalize_points_masked,
    residual_indicator,
    trial_validity,
)
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the singularity check (a host sync on the
    GPU)."""
    return torch.linalg.inv_ex(A)[0]


@f32_matmuls
def run_homography_dlt(points1: torch.Tensor, points2: torch.Tensor,
                       masks: torch.Tensor | None = None) -> torch.Tensor:
    """Masked, normalized 4-point DLT: (..., N, 2) x2, optional weights
    (..., N) -> (..., 3, 3), Frobenius-normalized."""
    if masks is None:
        masks = torch.ones_like(points1[..., 0])
    p1n, t1 = normalize_points_masked(points1, masks)
    p2n, t2 = normalize_points_masked(points2, masks)
    x1, y1 = p1n[..., 0:1], p1n[..., 1:2]
    x2, y2 = p2n[..., 0:1], p2n[..., 1:2]
    one, zero = torch.ones_like(x1), torch.zeros_like(x1)
    ax = torch.cat([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2],
                   dim=-1)
    ay = torch.cat([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2],
                   dim=-1)
    A = torch.cat([ax, ay], dim=-2) * torch.cat([masks, masks],
                                                dim=-1)[..., None]
    AtA = torch.matmul(A.transpose(-1, -2), A)
    h = smallest_eigenvector(AtA, num_sweeps=8)
    H = h.reshape(*h.shape[:-1], 3, 3)
    H = torch.matmul(torch.matmul(_inv(t2), H), t1)
    return H / torch.clamp(torch.linalg.matrix_norm(H, keepdim=True),
                           min=1e-12)


@f32_matmuls
def oneway_transfer_error(pts1: torch.Tensor, pts2: torch.Tensor,
                          H: torch.Tensor, squared: bool = True,
                          eps: float = 1e-8) -> torch.Tensor:
    """||H x1 - x2||² per point for candidates H (B, K, 3, 3), points
    (B, N, 2) x2 -> (B, K, N); where H x1 lands at non-positive depth
    BIG_RESIDUAL."""
    B, K = H.shape[:2]
    ones = torch.ones_like(pts1[..., :1])
    p1 = torch.cat([pts1, ones], dim=-1).transpose(-1, -2)  # (B, 3, N)
    Hp = torch.bmm(H.reshape(B, K * 3, 3), p1).reshape(B, K, 3, -1)
    z = Hp[:, :, 2]
    z_safe = torch.where(z.abs() < eps, eps, z)
    err = ((Hp[:, :, 0] / z_safe - pts2[:, None, :, 0]) ** 2
           + (Hp[:, :, 1] / z_safe - pts2[:, None, :, 1]) ** 2)
    err = torch.where(z <= 0, BIG_RESIDUAL, err)
    if squared:
        return err
    return torch.sqrt(err + eps)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) at candidate indices idx (B, k) -> (B, k, ...)."""
    return torch.take_along_dim(
        x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), dim=1)


@f32_matmuls
def estimate_homography(points1: torch.Tensor, points2: torch.Tensor,
                        generator: torch.Generator | None = None,
                        max_ransac_iters: int = 1024,
                        max_error: float = 4.0, lo_num: int = 50,
                        valid_mask: torch.Tensor | None = None,
                        sample_idx: torch.Tensor | None = None) -> dict:
    """LORANSAC homography over (B, N, 2) pairs: the 4-point sets, shared
    across the batch, drawn from `generator` or given as `sample_idx`
    (max_ransac_iters, 4); the `lo_num` best candidates re-solved over
    their inliers. Returns dict ``hmat`` (B, 3, 3), ``inlier_num`` (B,),
    ``inlier_mask`` (B, N)."""
    B, N, _ = points1.shape
    dev = points1.device
    thres = max_error ** 2
    if valid_mask is None:
        valid_mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    if sample_idx is None:
        sample_idx, trial_valid = generate_samples(
            generator, N, max_ransac_iters, 4, device=dev)
    else:
        sample_idx = sample_idx.to(dev)
        trial_valid = trial_validity(sample_idx)

    H_cand = run_homography_dlt(points1[:, sample_idx],
                                points2[:, sample_idx])  # (B, R, 3, 3)
    res = oneway_transfer_error(points1, points2, H_cand)
    res = torch.where(valid_mask[:, None] & trial_valid[None, :, None], res,
                      BIG_RESIDUAL)
    num = (res <= thres).sum(-1)

    sel = top_k_stable(num, lo_num)[1]  # jax.lax.top_k's order
    inl_sel = _take(res <= thres, sel)
    R = sel.shape[1]
    H_lo = run_homography_dlt(points1[:, None].expand(B, R, N, 2),
                              points2[:, None].expand(B, R, N, 2),
                              inl_sel.to(points1.dtype))

    H_all = torch.cat([H_cand, H_lo], dim=1)
    res_all = oneway_transfer_error(points1, points2, H_all)
    res_all = torch.where(valid_mask[:, None], res_all, BIG_RESIDUAL)
    inl_all = res_all <= thres
    num_all = inl_all.sum(-1)
    mean_all = (torch.where(inl_all, res_all, 0.0).sum(-1)
                / torch.clamp(num_all, min=1))
    best = torch.argmax(residual_indicator(num_all, mean_all), dim=1)
    ar = torch.arange(B, device=dev)
    return {"hmat": H_all[ar, best], "inlier_num": num_all[ar, best],
            "inlier_mask": inl_all[ar, best]}


def _opposite_minor(S: torch.Tensor, row: int, col: int) -> torch.Tensor:
    col1, col2 = (1 if col == 0 else 0), (1 if col == 2 else 2)
    row1, row2 = (1 if row == 0 else 0), (1 if row == 2 else 2)
    return (S[..., row1, col2] * S[..., row2, col1]
            - S[..., row1, col1] * S[..., row2, col2])


def _unit(x: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(nrm > 0, x / torch.clamp(nrm, min=1e-12), x)


@f32_matmuls
def decompose_homography_matrix(H: torch.Tensor, K1: torch.Tensor,
                                K2: torch.Tensor):
    """Malis-Vargas analytic decomposition into 4 candidate (R, t, n):
    pixel-space homographies H (B, 3, 3), intrinsics K1, K2 (B, 3, 3) ->
    (R (B, 4, 3, 3), t (B, 4, 3) unit, n (B, 4, 3) plane normals)."""
    Hn = torch.matmul(torch.matmul(_inv(K2), H), K1)
    _, sv, _ = svd3x3(Hn)
    Hn = Hn / sv[:, 1].abs()[:, None, None]
    Hn = torch.where(torch.linalg.det(Hn)[:, None, None] < 0, -Hn, Hn)

    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    S = torch.matmul(Hn.transpose(-1, -2), Hn) - eye

    M00 = torch.clamp(_opposite_minor(S, 0, 0), min=0.0)
    M11 = torch.clamp(_opposite_minor(S, 1, 1), min=0.0)
    M22 = torch.clamp(_opposite_minor(S, 2, 2), min=0.0)
    rtM00, rtM11, rtM22 = torch.sqrt(M00), torch.sqrt(M11), torch.sqrt(M22)
    e12 = torch.sign(_opposite_minor(S, 1, 2))
    e02 = torch.sign(_opposite_minor(S, 0, 2))
    e01 = torch.sign(_opposite_minor(S, 0, 1))

    diag = torch.diagonal(S, dim1=-2, dim2=-1)  # (B, 3)
    idx = torch.argmax(diag.abs(), dim=1)

    # the candidate normals of each index case, then the case's weights
    np1_c = torch.stack([
        torch.stack([S[:, 0, 0], S[:, 0, 1] + rtM22,
                     S[:, 0, 2] + e12 * rtM11], dim=-1),
        torch.stack([S[:, 0, 1] + rtM22, S[:, 1, 1],
                     S[:, 1, 2] - e02 * rtM00], dim=-1),
        torch.stack([S[:, 0, 2] + e01 * rtM11, S[:, 1, 2] + rtM00,
                     S[:, 2, 2]], dim=-1)], dim=1)  # (B, 3 cases, 3)
    np2_c = torch.stack([
        torch.stack([S[:, 0, 0], S[:, 0, 1] - rtM22,
                     S[:, 0, 2] - e12 * rtM11], dim=-1),
        torch.stack([S[:, 0, 1] - rtM22, S[:, 1, 1],
                     S[:, 1, 2] + e02 * rtM00], dim=-1),
        torch.stack([S[:, 0, 2] - e01 * rtM11, S[:, 1, 2] - rtM00,
                     S[:, 2, 2]], dim=-1)], dim=1)
    # a comparison, not `one_hot`: that checks its indices on the host
    sel = (idx[:, None] == torch.arange(3, device=H.device)).to(
        H.dtype)[..., None]
    np1 = sel[:, 0] * np1_c[:, 0] + sel[:, 1] * np1_c[:, 1] \
        + sel[:, 2] * np1_c[:, 2]
    np2 = sel[:, 0] * np2_c[:, 0] + sel[:, 1] * np2_c[:, 1] \
        + sel[:, 2] * np2_c[:, 2]

    traceS = S[:, 0, 0] + S[:, 1, 1] + S[:, 2, 2]
    v = 2.0 * torch.sqrt(torch.clamp(1.0 + traceS - M00 - M11 - M22,
                                     min=1e-12))
    ESii = torch.sign(torch.take_along_dim(diag, idx[:, None], dim=1)[:, 0])
    r = torch.sqrt(torch.clamp(2 + traceS + v, min=1e-12))
    n_t = torch.sqrt(torch.clamp(2 + traceS - v, min=1e-12))

    np1u, np2u = _unit(np1), _unit(np2)
    half_nt = 0.5 * n_t
    esii_t_r = ESii * r
    t1_star = half_nt[:, None] * (esii_t_r[:, None] * np2u
                                  - n_t[:, None] * np1u)
    t2_star = half_nt[:, None] * (esii_t_r[:, None] * np1u
                                  - n_t[:, None] * np2u)

    def rot(tstar, n):
        outer = tstar[:, :, None] * n[:, None, :]
        return torch.matmul(Hn, eye - (2.0 / v)[:, None, None] * outer)

    R1, R2 = rot(t1_star, np1u), rot(t2_star, np2u)
    t1 = _unit(torch.matmul(R1, t1_star[..., None])[..., 0])
    t2 = _unit(torch.matmul(R2, t2_star[..., None])[..., 0])

    Rs = torch.stack([R1, R1, R2, R2], dim=1)
    ts = torch.stack([t1, -t1, t2, -t2], dim=1)
    ns = torch.stack([-np1u, np1u, -np2u, np2u], dim=1)
    return Rs, ts, ns
