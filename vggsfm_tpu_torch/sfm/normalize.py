"""Gauge normalization of a reconstruction (PyTorch) and the observation
culling of the video map. Counterpart of vggsfm_tpu/sfm/normalize.py:
`normalize_similarity`, `apply_similarity` and `normalize_reconstruction`
are pycolmap's `reconstruction.normalize(5.0, 0.1, 0.9, True)`, which the
reference calls after each global BA (vggsfm/utils/triangulation.py:
1212-1218), computed in float64, as the numpy original, and returned in
the inputs' dtypes (the original works in place, these return new
tensors). `filter_map_observations` is COLMAP's `filter_all_points3D` on
the video runner's host registry, numpy in place as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from vggsfm_tpu_torch.geometry.distortion import apply_distortion


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


def _max_pairwise_angle_deg(dirs: np.ndarray) -> float:
    """Max pairwise angle of a small set of unit vectors (diameter pass:
    furthest-from-mean, then furthest-from-that; exact for the convex
    direction bundles triangulated tracks produce)."""
    if len(dirs) < 2:
        return 0.0
    mean = dirs.mean(axis=0)
    mean /= max(np.linalg.norm(mean), 1e-12)
    a = dirs[np.argmin(dirs @ mean)]
    b = dirs[np.argmin(dirs @ a)]
    return float(np.degrees(np.arccos(np.clip(a @ b, -1.0, 1.0))))


def _segment_argmin(values: np.ndarray, seg: np.ndarray,
                    n_seg: int) -> np.ndarray:
    """Per segment of a segment-sorted array, the index of its first
    smallest value (np.argmin's tie rule); -1 for empty segments."""
    mins = np.full((n_seg,), np.inf)
    np.minimum.at(mins, seg, values)
    hit = np.nonzero(values == mins[seg])[0]
    first = np.full((n_seg,), -1, np.int64)
    # the first hit of each segment: hits are in ascending index order
    uniq, pos = np.unique(seg[hit], return_index=True)
    first[uniq] = hit[pos]
    return first


def _max_pairwise_angles_deg(sd: np.ndarray, sp: np.ndarray,
                             groups: np.ndarray) -> np.ndarray:
    """`_max_pairwise_angle_deg` of many point groups at once: unit
    directions `sd` sorted by their point id `sp`, `groups` the point ids
    with at least two directions. The same diameter pass per group:
    the group's mean (a sequential row sum over the group, as numpy's
    axis-0 mean of a small array), the first direction furthest from it,
    the first direction furthest from that."""
    sel = np.isin(sp, groups)
    d = sd[sel]
    seg = np.searchsorted(groups, sp[sel])
    n = len(groups)
    starts = np.searchsorted(seg, np.arange(n))
    counts = np.bincount(seg, minlength=n)
    mean = np.add.reduceat(d, starts, axis=0) / counts[:, None]
    norm = np.sqrt(np.einsum("gi,gi->g", mean, mean))
    mean = mean / np.maximum(norm, 1e-12)[:, None]
    a = d[_segment_argmin(np.einsum("oi,oi->o", d, mean[seg]), seg, n)]
    b = d[_segment_argmin(np.einsum("oi,oi->o", d, a[seg]), seg, n)]
    cos = np.clip(np.einsum("gi,gi->g", a, b), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def filter_map_observations(reg, extrinsics, intrinsics, extra=None,
                            max_reproj_error: float = 2.0,
                            min_tri_angle: float = 1.5) -> dict:
    """COLMAP `filter_all_points3D` on a MapRegistry, in place:

    1. drop observations with reprojection error > `max_reproj_error` px
       or non-positive depth;
    2. drop points whose maximum pairwise triangulation angle falls below
       `min_tri_angle` degrees, or that retain < 2 observations;
    3. compact the point store and re-index surviving observations.

    extrinsics (T, 3, 4), intrinsics (T, 3, 3), extra (T, 1) or None as
    numpy arrays. The radial term is applied in float32, as the JAX
    package applies it (jnp arrays). The per-point angle test runs over
    all points at once (`_max_pairwise_angles_deg`) where the JAX package
    loops over them; the decisions are the same.

    Returns {"dropped_obs": int, "dropped_points": int}.
    """
    P = reg.num_points
    n_obs = len(reg.obs_frame)
    if P == 0 or n_obs == 0:
        return {"dropped_obs": 0, "dropped_points": 0}

    extr = np.asarray(extrinsics, np.float64)
    intr = np.asarray(intrinsics, np.float64)
    R = extr[reg.obs_frame, :, :3]
    t = extr[reg.obs_frame, :, 3]
    X = reg.xyz[reg.obs_point].astype(np.float64)
    Xc = np.einsum("oij,oj->oi", R, X) + t
    depth = Xc[:, 2]
    xn = Xc[:, :2] / np.maximum(depth[:, None], 1e-12)
    if extra is not None:
        f32 = torch.float32
        du, dv = apply_distortion(
            torch.as_tensor(np.asarray(extra)[reg.obs_frame], dtype=f32),
            torch.as_tensor(xn[:, 0:1], dtype=f32),
            torch.as_tensor(xn[:, 1:2], dtype=f32))
        xn = np.concatenate([du.numpy(), dv.numpy()], axis=1)
    f = intr[reg.obs_frame, 0, 0]
    pp = intr[reg.obs_frame, :2, 2]
    px = xn * f[:, None] + pp
    err = np.linalg.norm(px - reg.obs_xy, axis=1)
    obs_ok = (err <= max_reproj_error) & (depth > 0)

    # per-point max pairwise triangulation angle over surviving rays
    centers = -np.einsum("sij,si->sj", extr[:, :, :3], extr[:, :, 3])
    dirs = reg.xyz[reg.obs_point] - centers[reg.obs_frame]
    dirs = dirs / np.maximum(
        np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
    order = np.argsort(reg.obs_point[obs_ok], kind="stable")
    sp = reg.obs_point[obs_ok][order]
    sd = dirs[obs_ok][order]
    point_ok = np.zeros((P,), bool)
    starts = np.searchsorted(sp, np.arange(P))
    ends = np.searchsorted(sp, np.arange(P) + 1)
    groups = np.nonzero(ends - starts >= 2)[0]
    if len(groups):
        ang = _max_pairwise_angles_deg(sd, sp, groups)
        point_ok[groups[ang >= min_tri_angle]] = True

    keep_obs = obs_ok & point_ok[reg.obs_point]
    dropped_obs = int(n_obs - keep_obs.sum())
    dropped_points = int(P - point_ok.sum())

    remap = np.cumsum(point_ok) - 1  # old id -> new id
    reg.xyz = reg.xyz[point_ok]
    reg.obs_frame = reg.obs_frame[keep_obs]
    reg.obs_point = remap[reg.obs_point[keep_obs]].astype(np.int32)
    reg.obs_xy = reg.obs_xy[keep_obs]
    return {"dropped_obs": dropped_obs, "dropped_points": dropped_points}
