"""Gauge normalization of a reconstruction (PyTorch). Counterpart of
`normalize_similarity`, `apply_similarity` and `normalize_reconstruction`
in vggsfm_tpu/sfm/normalize.py: pycolmap's
`reconstruction.normalize(5.0, 0.1, 0.9, True)`, which the reference
calls after each global BA (vggsfm/utils/triangulation.py:1212-1218).
Computed in float64, as the numpy original, and returned in the inputs'
dtypes; the original works in place, these return new tensors.
"""

from __future__ import annotations

import torch


def normalize_similarity(extrinsics: torch.Tensor,
                         registered: torch.Tensor | None = None,
                         extent: float = 5.0, p0: float = 0.1,
                         p1: float = 0.9):
    """COLMAP's Normalize() similarity from the camera centres of the
    registered frames: per axis, sort the centres and trim them to the
    [p0, p1] percentile range; the centroid is the trimmed mean, the old
    extent the norm of the trimmed bounding box's diagonal, and the
    transform x -> (extent / old_extent) (x - centroid). Returns (scale,
    0-d f64 tensor; centroid (3,) f64). Selecting the registered frames
    reads their count on the host."""
    extr = extrinsics.to(torch.float64)
    if registered is not None:
        extr = extr[registered.to(torch.bool)]
    if extr.shape[0] == 0:
        return (torch.ones((), dtype=torch.float64, device=extr.device),
                torch.zeros(3, dtype=torch.float64, device=extr.device))
    centers = -torch.einsum("sij,si->sj", extr[:, :, :3], extr[:, :, 3])
    coords = torch.sort(centers, dim=0).values
    n = coords.shape[0]
    trimmed = coords[int(p0 * (n - 1)):int(p1 * (n - 1)) + 1]
    old_extent = torch.linalg.vector_norm(trimmed[-1] - trimmed[0])
    scale = torch.where(old_extent > 1e-12, extent / old_extent,
                        torch.ones_like(old_extent))
    return scale, trimmed.mean(0)


def apply_similarity(extrinsics: torch.Tensor, points3d: torch.Tensor,
                     scale, centroid):
    """x -> scale (x - centroid): camera centres move as points, so with
    t = -R c the translation becomes scale (t + R centroid). Returns
    (extrinsics, points3d)."""
    R = extrinsics[:, :, :3].to(torch.float64)
    t = scale * (extrinsics[:, :, 3].to(torch.float64)
                 + torch.einsum("sij,j->si", R, centroid))
    extr = torch.cat([extrinsics[:, :, :3],
                      t[..., None].to(extrinsics.dtype)], dim=-1)
    pts = (scale * (points3d.to(torch.float64) - centroid)).to(
        points3d.dtype)
    return extr, pts


def normalize_reconstruction(extrinsics, points3d, registered=None,
                             extent: float = 5.0, p0: float = 0.1,
                             p1: float = 0.9):
    """The COLMAP-style gauge normalization: (extrinsics, points3d, scale,
    centroid)."""
    scale, centroid = normalize_similarity(extrinsics, registered, extent,
                                           p0, p1)
    extr, pts = apply_similarity(extrinsics, points3d, scale, centroid)
    return extr, pts, scale, centroid
