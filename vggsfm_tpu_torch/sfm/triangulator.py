"""The SfM solve (PyTorch): initial pair -> init BA -> pose refinement ->
triangulation and BA -> iterative global BA. Counterpart of
vggsfm_tpu/sfm/triangulator.py (reference vggsfm/models/triangulator.py:
44-476, vggsfm/utils/triangulation.py:138-257 `init_BA`, :1020-1209
`global_BA`, `iterative_global_BA`).

Every tensor keeps its full shape (N tracks) through the solve; validity
is a mask, never a gather. The initial pair's index stays on the device.
The host reads the device in the LM loops (`ba/lm.py`) and in the forced
pose refinements' focal-sweep branch (`sfm/refine.py`), nowhere else.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from vggsfm_tpu_torch.ba import BAConfig, bundle_adjust
from vggsfm_tpu_torch.geometry.cameras import cam_from_img, project_points
from vggsfm_tpu_torch.ops.triangulation import (
    filter_points3d,
    triangulate_by_pair,
    triangulate_tracks,
)
from vggsfm_tpu_torch.sfm.refine import (
    camera_validity_mask,
    pnp_draws,
    refine_poses,
)


@dataclasses.dataclass(frozen=True)
class SfmConfig:
    """The JAX package's SfmConfig, and `seed`: the PnP draws of the
    forced pose refinements come from CPU generators seeded with
    seed + 99 (the first) and seed + 100 + i (robust refinement i), the
    JAX package's PRNG keys."""

    init_max_reproj_error: float = 4.0
    max_reproj_error: float = 4.0
    init_tri_angle_thres: float = 16.0
    min_valid_track_length: int = 3
    robust_refine: int = 2
    ba_iters: int = 2
    shared_camera: bool = False
    camera_type: str = "SIMPLE_PINHOLE"
    refine_focal: bool = True
    ba_max_iterations: int = 25
    max_ransac_iters: int = 256
    vis_thresh: float = 0.05
    seed: int = 0


def find_best_initial_pair(inlier_geo_vis, cheirality_mask, tri_angles,
                           init_tri_angle_thres):
    """The (query, frame) pair whose two-view cloud has most inliers. The
    reference halves the angle threshold up to 5 times until >= 100
    inliers cover >= 25% of the tracks (triangulator.py:442-476); here all
    thresholds are scored at once and the first acceptable one chosen on
    the device. Returns (inlier_total (S-1, N) at that threshold,
    init_idx, a 0-d device tensor)."""
    N = inlier_geo_vis.shape[-1]
    thresholds = torch.tensor(
        [max(init_tri_angle_thres / 2 ** k, 2.0) for k in range(5)],
        device=tri_angles.device)
    base = inlier_geo_vis & cheirality_mask  # (S-1, N)
    inlier_total = base[None] & (tri_angles[None]
                                 >= thresholds[:, None, None])
    best_count = inlier_total.sum(-1).amax(-1)  # (T,)
    acceptable = ((best_count >= 100) & (best_count / N >= 0.25)).to(
        torch.int32)
    t_idx = torch.where(acceptable.any(), torch.argmax(acceptable),
                        len(thresholds) - 1)
    chosen = inlier_total.index_select(0, t_idx.reshape(1))[0]
    return chosen, torch.argmax(chosen.sum(-1))


def _ba_cfg(cfg: SfmConfig) -> BAConfig:
    return BAConfig(max_iterations=cfg.ba_max_iterations,
                    refine_focal=cfg.refine_focal,
                    refine_extra=cfg.camera_type != "SIMPLE_PINHOLE",
                    shared_intrinsics=cfg.shared_camera)


def _restore_invalid(new, old, valid):
    extr = torch.where(valid[:, None, None], new[0], old[0])
    intr = torch.where(valid[:, None, None], new[1], old[1])
    extra = None
    if new[2] is not None:
        extra = torch.where(valid[:, None], new[2], old[2])
    return extr, intr, extra


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values of a 1-D tensor as `jnp.nanmedian`
    takes it: the mean of the two middle values for an even count
    (`torch.nanmedian` returns the lower one); NaN when there is none."""
    srt = torch.sort(x).values  # NaN last
    n = (~torch.isnan(x)).sum().to(x.dtype)
    q = 0.5 * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low

    def at(i):
        i = torch.clamp(torch.minimum(i, n - 1), min=0).long()
        return srt.index_select(0, i.reshape(1))[0]

    return at(low) * (1 - hw) + at(high) * hw


def init_ba(extrinsics, intrinsics, extra_params, tracks, points_3d_pair,
            inlier_total, init_idx, image_size, cfg: SfmConfig):
    """BA over the query frame and its best partner only: every other
    frame's observations are masked out and its camera frozen
    (triangulation.py:138-257). Returns (extrinsics, intrinsics, extra,
    points (N, 3), track_init_mask (N,))."""
    S, N = tracks.shape[:2]
    dev = tracks.device
    pair = init_idx.reshape(1) + 1
    init_points = points_3d_pair.index_select(0, init_idx.reshape(1))[0]
    pair_inlier = inlier_total.index_select(0, init_idx.reshape(1))[0]

    # the pre-BA mismatch gate: without an epipolar inlier mask the pair's
    # inliers can hold gross mismatches, whose DLT points reproject tens of
    # px off; gate at 3x the median pair error (at least 8 px)
    frames = torch.cat([torch.zeros_like(pair), pair])
    proj, pcam = project_points(init_points, extrinsics[frames],
                                intrinsics[frames], return_points_cam=True)
    err_pair = torch.linalg.vector_norm(proj - tracks[frames], dim=-1)
    err_pair = torch.where(pcam[:, 2] > 0, err_pair, torch.inf)
    err_max = err_pair.amax(0)
    med = torch.nan_to_num(_nanmedian(
        torch.where(pair_inlier, err_max, torch.nan)), nan=8.0)
    pair_inlier = pair_inlier & (err_max <= torch.clamp(3.0 * med, min=8.0))

    ar = torch.arange(S, device=dev)
    in_pair = (ar == 0) | (ar == pair)
    obs_mask = in_pair[:, None] & pair_inlier[None]

    # Huber: gross mismatches left in pair_inlier would drag a trivial-loss
    # init BA off, and the strict reprojection filter below would then
    # empty the cloud
    ba_cfg = dataclasses.replace(_ba_cfg(cfg), robust_loss="huber",
                                 loss_scale=3.0)
    extr_o, intr_o, extra_o, pts_o, _ = bundle_adjust(
        extrinsics, intrinsics, init_points, tracks, obs_mask,
        extra_params=extra_params, pose_free=ar == pair, intr_free=in_pair,
        point_free=pair_inlier, cfg=ba_cfg)

    reproj_ok, _ = filter_points3d(
        pts_o, tracks, extr_o, intr_o, extra_o,
        max_reproj_error=cfg.init_max_reproj_error, check_triangle=False,
        obs_mask=obs_mask)
    return extr_o, intr_o, extra_o, pts_o, pair_inlier & reproj_ok


def triangulate_and_ba(extrinsics, intrinsics, extra_params, tracks, vis,
                       score, image_size, cfg: SfmConfig, seed: int = 0):
    """LORANSAC triangulation of every track, one global BA, filtering
    (triangulator.py:364-440). Returns (points3d, extrinsics, intrinsics,
    extra, valid_tracks, inlier_mask (S, N))."""
    S = vis.shape[0]
    tracks_norm = cam_from_img(tracks, intrinsics, extra_params)
    pts, inlier_num, inlier_mask_nt = triangulate_tracks(
        extrinsics, tracks_norm, track_vis=vis, track_score=score,
        max_ransac_iters=cfg.max_ransac_iters, seed=seed)
    valid_tracks = inlier_num >= cfg.min_valid_track_length

    obs_mask = inlier_mask_nt.T & valid_tracks[None]
    extr_o, intr_o, extra_o, pts_o, _ = bundle_adjust(
        extrinsics, intrinsics, pts, tracks, obs_mask,
        extra_params=extra_params,
        pose_free=torch.arange(S, device=vis.device) != 0,
        point_free=valid_tracks, cfg=_ba_cfg(cfg))

    valid_frames = camera_validity_mask(intr_o, extr_o, image_size, extra_o)
    extr_o, intr_o, extra_o = _restore_invalid(
        (extr_o, intr_o, extra_o), (extrinsics, intrinsics, extra_params),
        valid_frames)

    reproj_ok, detail = filter_points3d(
        pts_o, tracks, extr_o, intr_o, extra_o,
        max_reproj_error=cfg.max_reproj_error, check_triangle=False,
        obs_mask=vis > cfg.vis_thresh)
    return (pts_o, extr_o, intr_o, extra_o, valid_tracks & reproj_ok,
            detail)


def iterative_global_ba(extrinsics, intrinsics, extra_params, tracks, vis,
                        score, points3d, valid_tracks, image_size,
                        max_reproj_error, cfg: SfmConfig, seed: int = 0):
    """One round of re-triangulation, filtering, BA and re-filtering
    (triangulation.py:1076-1209), with a minimum track length of 2."""
    S = vis.shape[0]
    tracks_norm = cam_from_img(tracks, intrinsics, extra_params)
    pts, _, _ = triangulate_tracks(
        extrinsics, tracks_norm, track_vis=vis, track_score=score,
        max_ransac_iters=128, seed=seed)
    # the BA-optimized positions of the tracks already valid stay
    pts = torch.where(valid_tracks[:, None], points3d, pts)

    _, inlier_detail = filter_points3d(
        pts, tracks, extrinsics, intrinsics, extra_params,
        max_reproj_error=max_reproj_error, check_triangle=False,
        obs_mask=vis > cfg.vis_thresh)
    valid_tracks = inlier_detail.sum(0) >= 2

    obs_mask = inlier_detail & valid_tracks[None]
    extr_o, intr_o, extra_o, pts_o, _ = bundle_adjust(
        extrinsics, intrinsics, pts, tracks, obs_mask,
        extra_params=extra_params,
        pose_free=torch.arange(S, device=vis.device) != 0,
        point_free=valid_tracks, cfg=_ba_cfg(cfg))

    valid_frames = camera_validity_mask(intr_o, extr_o, image_size, extra_o)
    extr_o, intr_o, extra_o = _restore_invalid(
        (extr_o, intr_o, extra_o), (extrinsics, intrinsics, extra_params),
        valid_frames)

    _, detail = filter_points3d(
        pts_o, tracks, extr_o, intr_o, extra_o,
        max_reproj_error=max_reproj_error, check_triangle=False,
        obs_mask=vis > cfg.vis_thresh)
    return (pts_o, extr_o, intr_o, extra_o,
            valid_tracks & (detail.sum(0) >= 2), detail)


def run_sfm(extrinsics, intrinsics, tracks, vis, image_size,
            fmat_inlier_mask=None, score=None, extra_params=None,
            cfg: SfmConfig = SfmConfig(), draws: dict | None = None,
            stage=None):
    """The SfM solve from initial cameras and tracks
    (triangulator.py:44-350, `Triangulator.forward`).

    extrinsics (S, 3, 4) and intrinsics (S, 3, 3), the initial cameras;
    tracks (S, N, 2) pixels, frame 0 the query frame; vis (S, N) in
    [0, 1]; image_size (width, height); fmat_inlier_mask optional
    (S-1, N) epipolar inliers; score optional (S, N) confidence.
    `draws` maps the JAX package's PnP seed (99, 100 + i) to injected
    `pnp_draws` (the tests hand in the JAX draws); by default they come
    from CPU generators seeded with cfg.seed plus that seed. `stage(name)`,
    if given, is a context manager around each part (`init_ba`,
    `refine_poses_<i>`, `triangulate_and_ba_<i>`,
    `iterative_global_ba_<i>`), for timing.

    Returns dict with the refined ``extrinsics``, ``intrinsics``,
    ``extra_params``, ``points3d`` (N, 3), ``valid_tracks`` (N,),
    ``valid_2d_mask`` (S, N), ``valid_frame_mask`` (S,), ``init_idx``."""
    S, N, _ = tracks.shape
    stage = stage or (lambda name: contextlib.nullcontext())
    if cfg.camera_type == "SIMPLE_RADIAL" and extra_params is None:
        extra_params = torch.zeros((S, 1), dtype=tracks.dtype,
                                   device=tracks.device)
    visible = vis > cfg.vis_thresh

    def refine(extr, intr, extra, pts, obs, key):
        d = None
        if key is not None:
            d = (draws[key] if draws is not None and key in draws
                 else pnp_draws(torch.Generator().manual_seed(cfg.seed + key),
                                N))
        return refine_poses(extr, intr, pts, tracks, obs, image_size,
                            extra_params=extra, force_estimate=d is not None,
                            draws=d, shared_intrinsics=cfg.shared_camera,
                            refine_intrinsics=cfg.refine_focal)

    with stage("init_ba"):
        tracks_norm = cam_from_img(tracks, intrinsics, extra_params)
        points_pair, cheirality_pair, tri_angle_pair = triangulate_by_pair(
            extrinsics, tracks_norm)
        inlier_geo_vis = visible[1:]
        if fmat_inlier_mask is not None:
            inlier_geo_vis = fmat_inlier_mask & inlier_geo_vis
        inlier_total, init_idx = find_best_initial_pair(
            inlier_geo_vis, cheirality_pair, tri_angle_pair,
            cfg.init_tri_angle_thres)
        extr, intr, extra, pts_init, track_init_mask = init_ba(
            extrinsics, intrinsics, extra_params, tracks, points_pair,
            inlier_total, init_idx, image_size, cfg)

    # every pose against the init cloud, forced: frames whose
    # initialization is off get PnP-registered against the cloud. Every
    # visible observation of an init-cloud point registers (the query
    # pair's epipolar gate would starve frames far from the query)
    with stage("refine_poses_0"):
        obs = torch.cat([track_init_mask[None],
                         visible[1:] & track_init_mask[None]])
        extr, intr, extra, _ = refine(extr, intr, extra, pts_init, obs, 99)
    with stage("triangulate_and_ba_0"):
        pts, extr, intr, extra, valid_tracks, inlier_detail = \
            triangulate_and_ba(extr, intr, extra, tracks, vis, score,
                               image_size, cfg, seed=1)

    for i in range(cfg.robust_refine):
        with stage(f"refine_poses_{i + 1}"):
            obs = visible & valid_tracks[None] & inlier_detail
            key = 100 + i if i == cfg.robust_refine - 1 else None
            extr, intr, extra, _ = refine(extr, intr, extra, pts, obs, key)
        with stage(f"triangulate_and_ba_{i + 1}"):
            pts, extr, intr, extra, valid_tracks, inlier_detail = \
                triangulate_and_ba(extr, intr, extra, tracks, vis, score,
                                   image_size, cfg, seed=2 + i)

    max_reproj = cfg.max_reproj_error
    for i in range(cfg.ba_iters):
        with stage(f"iterative_global_ba_{i}"):
            pts, extr, intr, extra, valid_tracks, inlier_detail = \
                iterative_global_ba(extr, intr, extra, tracks, vis, score,
                                    pts, valid_tracks, image_size,
                                    max_reproj, cfg, seed=10 + i)
        max_reproj = max(max_reproj // 2, 1)

    return {
        "extrinsics": extr,
        "intrinsics": intr,
        "extra_params": extra,
        "points3d": pts,
        "valid_tracks": valid_tracks,
        "valid_2d_mask": inlier_detail & valid_tracks[None],
        "valid_frame_mask": camera_validity_mask(intr, extr, image_size,
                                                 extra),
        "init_idx": init_idx,
    }
