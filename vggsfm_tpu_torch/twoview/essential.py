"""Essential matrix from F, its decomposition into (R, t), and the
cheirality choice (PyTorch). Counterpart of
vggsfm_tpu/twoview/essential.py (reference
vggsfm/two_view_geo/fundamental.py:186-246, essential.py:36-108,
utils.py:325-363). The SVD of E is the eigh-based 3x3 factorization of
`ops/svd3.py`, whose U and V are proper rotations.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.geometry.cameras import _mm
from vggsfm_tpu_torch.ops.svd3 import svd3x3
from vggsfm_tpu_torch.twoview.utils import check_cheirality


def essential_from_fundamental(fmat: torch.Tensor, kmat1: torch.Tensor,
                               kmat2: torch.Tensor) -> torch.Tensor:
    """E = K2ᵀ F K1 (Hartley & Zisserman eq. 9.12), Frobenius-normalized."""
    E = _mm(_mm(kmat2.transpose(-1, -2), fmat), kmat1)
    return E / torch.clamp(torch.linalg.vector_norm(E, dim=(-2, -1),
                                                    keepdim=True), min=1e-12)


def decompose_essential_matrix(E_mat: torch.Tensor):
    """(..., 3, 3) essential -> the 4 candidate poses (R (..., 4, 3, 3),
    t (..., 4, 3)): R in {U W Vᵀ, U Wᵀ Vᵀ}, t = ±u3, with
    W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]."""
    U, _, V = svd3x3(E_mat)
    u1, u2, u3 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    UW = torch.stack([u2, -u1, u3], dim=-1)  # U W
    UWt = torch.stack([-u2, u1, u3], dim=-1)  # U Wᵀ
    Vt = V.transpose(-1, -2)
    R1, R2 = _mm(UW, Vt), _mm(UWt, Vt)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([u3, -u3, u3, -u3], dim=-2)
    return Rs, ts


def remove_cheirality(R: torch.Tensor, t: torch.Tensor,
                      points1: torch.Tensor, points2: torch.Tensor,
                      focal_length: torch.Tensor | None = None,
                      principal_point: torch.Tensor | None = None):
    """The (R, t) candidate with the most points in front of both cameras.

    R (B, 4, 3, 3), t (B, 4, 3) candidates; points1, points2 (B, N, 2):
    pixels when focal / principal point ((B, 4), [f1x, f1y, f2x, f2y] /
    [c1x, c1y, c2x, c2y]) are given, else normalized. Returns (R (B, 3, 3),
    t (B, 3)), the first candidate among equal counts.
    """
    if focal_length is not None:
        points1 = ((points1 - principal_point[:, None, :2])
                   / focal_length[:, None, :2])
        points2 = ((points2 - principal_point[:, None, 2:])
                   / focal_length[:, None, 2:])
    B, C = R.shape[:2]
    N = points1.shape[1]
    p1 = points1[:, None].expand(B, C, N, 2).reshape(B * C, N, 2)
    p2 = points2[:, None].expand(B, C, N, 2).reshape(B * C, N, 2)
    counts, _ = check_cheirality(R.reshape(B * C, 3, 3),
                                 t.reshape(B * C, 3), p1, p2)
    best = torch.argmax(counts.reshape(B, C), dim=1)
    R_best = torch.take_along_dim(R, best[:, None, None, None], dim=1)[:, 0]
    t_best = torch.take_along_dim(t, best[:, None, None], dim=1)[:, 0]
    return R_best, t_best
