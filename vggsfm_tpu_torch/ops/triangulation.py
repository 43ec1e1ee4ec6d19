"""Multi-view DLT triangulation and LORANSAC track triangulation
(PyTorch). Counterpart of vggsfm_tpu/ops/triangulation.py (reference
vggsfm/utils/triangulation.py:45-135, :650-1017,
triangulation_helpers.py:27-307, :431-725).

The per-track DLT is the smallest eigenvector of a 4x4 normal matrix,
from the batched Jacobi eigensolver (`ops/eigh.py`). LORANSAC runs fixed
budgets: the C(S,2) pair trials (shuffled and truncated to
`max_ransac_iters`), two local-refinement rounds over the candidates with
most inliers, and one argmax over (inlier count, mean residual). The track
axis is cut into chunks by a Python loop; the chunk bounds memory and
changes no result. The products are elementwise f32 sums or run under
`f32_matmuls`.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np
import torch

from vggsfm_tpu_torch.extractors.dog import top_k_stable
from vggsfm_tpu_torch.geometry.cameras import camera_centers, project_points
from vggsfm_tpu_torch.ops.eigh import smallest_eigenvector
from vggsfm_tpu_torch.utils.precision import f32_matmuls

_RAD2DEG = 180.0 / math.pi
_DEG2RAD = math.pi / 180.0


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


@f32_matmuls
def normalized_angular_error(points3d: torch.Tensor,
                             tracks_normalized: torch.Tensor,
                             extrinsics: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between each observed ray and the ray to each
    candidate point: candidates (N, K, 3), normalized observations
    (N, S, 2), extrinsics (S, 3, 4) -> (N, K, S)."""
    ray1 = torch.cat([tracks_normalized,
                      torch.ones_like(tracks_normalized[..., :1])], dim=-1)
    ray1 = ray1 / torch.linalg.vector_norm(ray1, dim=-1, keepdim=True)
    ray2 = (torch.einsum("sij,nkj->nksi", extrinsics[:, :, :3], points3d)
            + extrinsics[None, None, :, :, 3])
    ray2 = ray2 / torch.clamp(
        torch.linalg.vector_norm(ray2, dim=-1, keepdim=True), min=1e-12)
    cos = (ray1[:, None] * ray2).sum(-1)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def generate_ransac_pairs(S: int, max_ransac_iters: int,
                          seed: int = 0) -> np.ndarray:
    """The trial schedule: the C(S,2) frame pairs, shuffled by
    `np.random.RandomState(seed)` and truncated when there are more than
    `max_ransac_iters` -> (R, 2) int32."""
    comb = np.asarray(list(combinations(range(S), 2)), dtype=np.int32)
    if len(comb) > max_ransac_iters:
        rs = np.random.RandomState(seed)
        comb = comb[rs.permutation(len(comb))[:max_ransac_iters]]
    return comb


def _residual_indicator(errors: torch.Tensor, max_error: float,
                        nanvalue: float, group=None):
    """Score candidates by inlier count, ties broken by the lower mean
    inlier residual: errors (N, K, S) -> (indicator (N, K), inlier count
    (N, K), inlier mask (N, K, S)). The residual scale is the largest over
    all tracks: with `group` (a mesh `Axis`) over every rank's block."""
    inlier_mask = errors <= max_error
    inlier_num = inlier_mask.sum(-1)
    mean_resid = (torch.where(inlier_mask, errors, 0.0).sum(-1)
                  / torch.clamp(inlier_num, min=1))
    mean_resid = torch.where(inlier_num == 0, nanvalue, mean_resid)
    mean_resid = torch.nan_to_num(mean_resid, nan=nanvalue, posinf=nanvalue,
                                  neginf=nanvalue)
    top = mean_resid.max()
    if group is not None:
        top = group.all_reduce(top.clone(), "max")
    thres = top + 1e-6
    indicator = (thres - mean_resid) / thres + inlier_num.to(errors.dtype)
    return indicator, inlier_num, inlier_mask


def _local_refine(tracks_nt, extrinsics, inlier_mask, lo_num: int,
                  min_tri_angle: float, invalid_vis_conf):
    """One LORANSAC local-refinement round: the `lo_num` candidates with
    most inliers (N, K, S), each re-triangulated from its inlier set ->
    (points (N, lo, 3), angular errors (N, lo, S) with the invalidity
    penalties added)."""
    # the lower index first among equal counts, as jax.lax.top_k
    top_idx = top_k_stable(inlier_mask.sum(-1), lo_num)[1]  # (N, lo)
    lo_mask = torch.take_along_dim(inlier_mask, top_idx[..., None], dim=1)
    pts = tracks_nt[:, None] * lo_mask[..., None]  # (N, lo, S, 2)
    # the cameras stay unbroadcast (1, 1, S, 3, 4) against the (N, lo)
    # batch: nothing of size N x lo x S x 3 x 4 is materialized
    cams = extrinsics[None, None]
    lo_points = multiview_dlt(cams, pts, mask=lo_mask.to(pts.dtype))
    angles = triangulation_angles(cams, lo_points)  # (N, lo, S, S)
    tri_ok = (angles >= min_tri_angle).flatten(-2).any(-1)
    lo_invalid = ~tri_ok | cheirality_invalid(cams, lo_points)

    lo_err = normalized_angular_error(lo_points, tracks_nt, extrinsics)
    lo_err = torch.nan_to_num(lo_err, nan=100 * math.pi,
                              posinf=100 * math.pi, neginf=100 * math.pi)
    lo_err = lo_err + torch.where(lo_invalid[..., None], math.pi, 0.0)
    lo_err = lo_err + torch.where(invalid_vis_conf[:, None, :], math.pi, 0.0)
    return lo_points, lo_err


def triangulate_tracks_chunk(extrinsics: torch.Tensor,
                             tracks_nt: torch.Tensor,
                             ransac_pairs: torch.Tensor,
                             track_vis: torch.Tensor | None = None,
                             track_score: torch.Tensor | None = None,
                             lo_num: int = 50,
                             max_angular_error: float = 2.0,
                             min_tri_angle: float = 1.5, group=None):
    """LORANSAC triangulation of one chunk of tracks: extrinsics
    (S, 3, 4), normalized tracks (N, S, 2), trial pairs (R, 2),
    visibility and score (N, S), where an observation with vis <= 0.05 or
    score <= 0.5 is penalized out -> (points (N, 3), inlier count (N,),
    inlier mask (N, S)). With `group` (a mesh `Axis`) the tracks are this
    rank's block of the chunk."""
    N, S, _ = tracks_nt.shape
    R = ransac_pairs.shape[0]
    lo_num = min(lo_num, R)
    lo_num_sec = min(10, lo_num)
    max_rad_error = max_angular_error * _DEG2RAD

    # stage 1: the pair trials
    pair_extr = extrinsics[ransac_pairs][None]  # (1, R, 2, 3, 4)
    pair_pts = tracks_nt[:, ransac_pairs, :]  # (N, R, 2, 2)
    tri_points = multiview_dlt(pair_extr, pair_pts)  # (N, R, 3)
    pair_angles = triangulation_angles(pair_extr, tri_points)[..., 0, 1]
    invalid = (~(pair_angles >= min_tri_angle)
               | cheirality_invalid(pair_extr, tri_points))

    err = normalized_angular_error(tri_points, tracks_nt, extrinsics)
    err = err + torch.where(invalid[..., None], math.pi, 0.0)
    if track_vis is not None and track_score is not None:
        invalid_vis_conf = (track_vis <= 0.05) | (track_score <= 0.5)
    elif track_vis is not None:
        invalid_vis_conf = track_vis <= 0.05
    else:
        invalid_vis_conf = torch.zeros((N, S), dtype=torch.bool,
                                       device=tracks_nt.device)
    err = err + torch.where(invalid_vis_conf[:, None, :], math.pi, 0.0)

    # stage 2: two local-refinement rounds
    lo_points, lo_err = _local_refine(tracks_nt, extrinsics,
                                      err <= max_rad_error, lo_num,
                                      min_tri_angle, invalid_vis_conf)
    lo_points2, lo_err2 = _local_refine(tracks_nt, extrinsics,
                                        lo_err <= max_rad_error, lo_num_sec,
                                        min_tri_angle, invalid_vis_conf)

    # stage 3: the best candidate (the first among equal indicators)
    all_points = torch.cat([tri_points, lo_points, lo_points2], dim=1)
    all_err = torch.cat([err, lo_err, lo_err2], dim=1)
    indicator, inlier_num, inlier_mask = _residual_indicator(
        all_err, max_rad_error, nanvalue=2 * math.pi, group=group)
    best = torch.argmax(indicator, dim=1)[:, None]  # (N, 1)
    return (torch.take_along_dim(all_points, best[..., None], dim=1)[:, 0],
            torch.take_along_dim(inlier_num, best, dim=1)[:, 0],
            torch.take_along_dim(inlier_mask, best[..., None], dim=1)[:, 0])


def triangulate_tracks(extrinsics: torch.Tensor,
                       tracks_normalized: torch.Tensor,
                       track_vis: torch.Tensor | None = None,
                       track_score: torch.Tensor | None = None,
                       max_ransac_iters: int = 256,
                       lo_num: int = 50,
                       max_angular_error: float = 2.0,
                       min_tri_angle: float = 1.5,
                       max_tri_points_num: int = 262_144,
                       seed: int = 0):
    """Triangulate every track: extrinsics (S, 3, 4), normalized tracks
    (S, N, 2) frame-major, visibility and score (S, N) -> (points (N, 3),
    inlier count (N,), inlier mask (N, S)).

    The tracks go through `triangulate_tracks_chunk` in chunks of
    `max_tri_points_num // S` tracks. The JAX package's 32,768
    track-frames were sized for a TPU; 262,144 (32,768 tracks at 8
    frames, one chunk at the matched workload) keeps the peak of a chunk
    at a few GB of an H100's 80 (PERF.md) and launches each op once."""
    S, N, _ = tracks_normalized.shape
    tracks_nt = tracks_normalized.transpose(0, 1)
    vis_nt = track_vis.transpose(0, 1) if track_vis is not None else None
    score_nt = (track_score.transpose(0, 1) if track_score is not None
                else None)
    pairs = torch.as_tensor(generate_ransac_pairs(S, max_ransac_iters, seed),
                            dtype=torch.long, device=tracks_nt.device)
    chunk = max(1, max_tri_points_num // max(S, 1))
    outs = []
    for start in range(0, N, chunk):
        sl = slice(start, start + chunk)
        outs.append(triangulate_tracks_chunk(
            extrinsics, tracks_nt[sl], pairs,
            vis_nt[sl] if vis_nt is not None else None,
            score_nt[sl] if score_nt is not None else None,
            lo_num=lo_num, max_angular_error=max_angular_error,
            min_tri_angle=min_tri_angle))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def filter_points3d(points3D: torch.Tensor, points2D: torch.Tensor,
                    extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                    extra_params: torch.Tensor | None = None,
                    max_reproj_error: float = 4.0,
                    min_tri_angle: float = 1.5,
                    check_triangle: bool = True,
                    hard_max: float = 300.0,
                    obs_mask: torch.Tensor | None = None):
    """Which triangulated points to keep: points (P, 3), pixel
    observations (B, P, 2), cameras (B, 3, 4), (B, 3, 3) -> (valid (P,),
    inlier detail (B, P)). A point is kept when at least 2 frames (within
    `obs_mask`) reproject it within `max_reproj_error` px in front of the
    camera, its coordinates stay within `hard_max`, and, with
    `check_triangle`, some pair of its inlier frames sees it at an angle
    of at least `min_tri_angle` degrees."""
    B, P, _ = points2D.shape
    proj, points_cam = project_points(points3D, extrinsics, intrinsics,
                                      extra_params=extra_params,
                                      return_points_cam=True)
    reproj2 = ((proj - points2D) ** 2).sum(-1)
    reproj2 = torch.where(points_cam[:, 2, :] <= 0, 1e6, reproj2)
    inlier = reproj2 <= max_reproj_error ** 2  # (B, P)
    if obs_mask is not None:
        inlier = inlier & obs_mask
    valid_track = inlier.sum(0) >= 2
    if hard_max > 0:
        valid_track = valid_track & (points3D.abs() <= hard_max).all(-1)
    if not check_triangle:
        return valid_track, inlier & valid_track[None, :]

    centers = camera_centers(extrinsics)  # (B, 3)
    baseline2 = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    ray2 = ((points3D[None, :, :] - centers[:, None, :]) ** 2).sum(-1)
    r1, r2 = ray2[:, None, :], ray2[None, :, :]  # (B, 1, P), (1, B, P)
    denom = 2.0 * torch.sqrt(r1 * r2)
    numer = r1 + r2 - baseline2[..., None]
    bad = denom <= 1e-12
    cos = torch.where(bad, 1.0, numer) / torch.where(bad, 1.0, denom)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0)).abs()
    ang = torch.minimum(ang, math.pi - ang) * _RAD2DEG
    pair_inlier = inlier[:, None, :] & inlier[None, :, :]
    tri_ok = ((ang >= min_tri_angle) & pair_inlier).flatten(0, 1).any(0)
    valid_track = valid_track & tri_ok
    return valid_track, inlier & tri_ok[None, :] & valid_track[None, :]
