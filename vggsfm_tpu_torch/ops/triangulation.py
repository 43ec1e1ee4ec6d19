"""Multi-view DLT triangulation (PyTorch): the part of
vggsfm_tpu/ops/triangulation.py that the camera-init choice needs
(`multiview_dlt`, `cheirality_invalid`, `triangulation_angles`,
`triangulate_by_pair`; reference vggsfm/utils/triangulation.py:45-135,
triangulation_helpers.py:27-115, :475-587). The LORANSAC track
triangulation belongs to the SfM solve.

The per-track DLT is the smallest eigenvector of a 4x4 normal matrix,
from the batched Jacobi eigensolver (`ops/eigh.py`). The products are
elementwise f32 sums.
"""

from __future__ import annotations

import math

import torch

from vggsfm_tpu_torch.geometry.cameras import camera_centers
from vggsfm_tpu_torch.ops.eigh import smallest_eigenvector

_RAD2DEG = 180.0 / math.pi


def multiview_dlt(cams_from_world: torch.Tensor, points: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """DLT triangulation of one world point from M views, batched:
    extrinsics (..., M, 3, 4), normalized image points (..., M, 2),
    optional view weights (..., M) -> world points (..., 3). Minimizes
    Σ_m w_m² ||(I - r rᵀ) P_m X̃||² with r the unit ray [u, v, 1]/||.||:
    A = Σ_m w_m² [P_mᵀP_m - (P_mᵀ r_m)(P_mᵀ r_m)ᵀ]."""
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    ray = homo / torch.linalg.vector_norm(homo, dim=-1, keepdim=True)
    C = cams_from_world
    b = (C * ray[..., :, None]).sum(-2)  # (..., M, 4) = P_mᵀ r_m
    CC = C[..., :, :, None] * C[..., :, None, :]  # (..., M, 3, 4, 4)
    if mask is not None:
        w = mask * mask
        CtC = (CC.sum(-3) * w[..., None, None]).sum(-3)
        bb = ((b * w[..., None])[..., :, None] * b[..., None, :]).sum(-3)
    else:
        CtC = CC.sum((-4, -3))
        bb = (b[..., :, None] * b[..., None, :]).sum(-3)
    v = smallest_eigenvector(CtC - bb)
    w = v[..., 3:4]
    w = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12), w)
    return v[..., :3] / w


def cheirality_invalid(cams_from_world: torch.Tensor,
                       points3d: torch.Tensor) -> torch.Tensor:
    """True where a point falls behind ANY of its cameras: extrinsics
    (..., M, 3, 4), points (..., 3) -> bool (...)."""
    z = ((cams_from_world[..., :, 2, :3] * points3d[..., None, :]).sum(-1)
         + cams_from_world[..., :, 2, 3])
    return (z <= 0).any(-1)


def triangulation_angles(cams_from_world: torch.Tensor,
                         points3d: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    """Pairwise triangulation angles (degrees) between all M view rays,
    by the law of cosines, folded to min(θ, 180 - θ): extrinsics
    (..., M, 3, 4), points (..., 3) -> (..., M, M)."""
    centers = camera_centers(cams_from_world)  # (..., M, 3)
    baseline2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2
                 ).sum(-1)
    ray2 = ((points3d[..., None, :] - centers) ** 2).sum(-1)
    denom = 2.0 * torch.sqrt(ray2[..., :, None] * ray2[..., None, :])
    numer = ray2[..., :, None] + ray2[..., None, :] - baseline2
    bad = denom <= eps
    cos = torch.where(bad, 1.0, numer) / torch.where(bad, 1.0, denom)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0)).abs()
    return torch.minimum(ang, math.pi - ang) * _RAD2DEG


def triangulate_by_pair(extrinsics: torch.Tensor,
                        tracks_normalized: torch.Tensor):
    """Triangulate the query frame 0 against every other frame:
    extrinsics (S, 3, 4), normalized tracks (S, N, 2) -> (points3d
    (S-1, N, 3), cheirality mask (S-1, N), True where in front of both,
    triangulation angles (S-1, N) in degrees)."""
    S, N, _ = tracks_normalized.shape
    pair_extr = torch.stack([extrinsics[0:1].expand(S - 1, 3, 4),
                             extrinsics[1:]], dim=1)  # (S-1, 2, 3, 4)
    pts = torch.stack([tracks_normalized[0:1].expand(S - 1, N, 2),
                       tracks_normalized[1:]], dim=2)  # (S-1, N, 2, 2)
    cams = pair_extr[:, None]  # (S-1, 1, 2, 3, 4), broadcast over tracks
    points3d = multiview_dlt(cams, pts)
    invalid = cheirality_invalid(cams, points3d)
    angles = triangulation_angles(cams, points3d)[..., 0, 1]
    return points3d, ~invalid, angles
