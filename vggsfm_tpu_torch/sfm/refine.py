"""Pose refinement against a fixed point cloud (PyTorch). Counterpart of
vggsfm_tpu/sfm/refine.py (reference vggsfm/utils/triangulation.py:
260-647, `refine_pose` / `init_refine_pose`, a per-frame loop over
`pycolmap.pose_refinement`).

With the points frozen the normal equations decouple per camera, so one
`bundle_adjust` call with `pose_only` is the per-frame refinement of
every frame at once. Frames whose refined parameters leave the validity
window are restored (the reference re-estimates them by absolute pose
RANSAC, triangulation.py:384-433, which `force_estimate` does here).
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.ba import BAConfig, bundle_adjust
from vggsfm_tpu_torch.geometry.cameras import project_points
from vggsfm_tpu_torch.twoview.pnp import absolute_pose_ransac
from vggsfm_tpu_torch.twoview.utils import generate_samples
from vggsfm_tpu_torch.utils.precision import f32_matmuls

# the PnP problem's size cap: pose estimation saturates long before 8k
# correspondences, and the RANSAC residuals scale as S x f_trials x
# iterations x N
PNP_CAP = 8192
PNP_ITERS = 256


def pnp_draws(generator: torch.Generator, n_points: int):
    """The random draws of one forced refinement, from a CPU generator:
    (the subset of the points PnP sees, the first PNP_CAP of a
    permutation, or None when there are at most PNP_CAP points; the
    (PNP_ITERS, 6) minimal sets over that subset)."""
    sub = None
    if n_points > PNP_CAP:
        sub = torch.randperm(n_points, generator=generator)[:PNP_CAP]
    idx, _ = generate_samples(generator, min(n_points, PNP_CAP), PNP_ITERS,
                              6)
    return sub, idx


def _frame_reproj_error(extrinsics, intrinsics, points3d, tracks, obs_mask,
                        clip_px: float = 12.0):
    """Per frame, the mean reprojection error (px) over obs_mask, each
    clipped at `clip_px` (behind the camera counts as `clip_px`), so
    outliers cannot dominate the ranking of pose candidates."""
    proj, pcam = project_points(points3d, extrinsics, intrinsics,
                                return_points_cam=True)
    err = torch.linalg.vector_norm(proj - tracks, dim=-1)  # (S, N)
    err = torch.where(pcam[:, 2] > 0, err, clip_px)
    err = torch.clamp(err, max=clip_px)
    w = obs_mask.to(err.dtype)
    return (err * w).sum(-1) / torch.clamp(w.sum(-1), min=1)


def camera_validity_mask(intrinsics, extrinsics, image_size,
                         extra_params=None):
    """Focal in [0.1, 30] x max(W, H), |t| <= 30, |extra| <= 1
    (triangulation.py:1222-1242, `get_valid_frame_mask`)."""
    scale = float(max(image_size))
    f = intrinsics[:, 0, 0]
    ok = (f >= 0.1 * scale) & (f <= 30.0 * scale)
    ok = ok & (extrinsics[:, :, 3].abs() <= 30.0).all(-1)
    if extra_params is not None:
        ok = ok & (extra_params.abs() <= 1.0).all(-1)
    return ok


@f32_matmuls
def refine_poses(extrinsics, intrinsics, points3d, tracks, obs_mask,
                 image_size, extra_params=None, refine_intrinsics=True,
                 max_iterations: int = 20, force_estimate: bool = False,
                 draws=None, shared_intrinsics: bool = False):
    """Refine every camera against the frozen points: extrinsics
    (S, 3, 4), intrinsics (S, 3, 3), points3d (N, 3), tracks (S, N, 2),
    obs_mask (S, N), the observations that constrain the poses.

    With `force_estimate` and `draws` (`pnp_draws`' subset and minimal
    sets, the JAX package's `pnp_key`), absolute-pose RANSAC competes
    with the refined poses: at the current focal for every frame, and
    with the 17-focal sweep for the frames still invalid (a host branch:
    the sweep runs only when some frame is invalid, one device-to-host
    sync).

    Returns (extrinsics, intrinsics, extra_params, valid_frame_mask);
    frames that leave the validity window get their inputs back and
    False."""
    S, N = obs_mask.shape
    # Huber is load-bearing: obs_mask is only visibility-gated, and a
    # trivial-loss LM lets a few large-error outliers drag a good pose off
    cfg = BAConfig(max_iterations=max_iterations,
                   refine_focal=refine_intrinsics,
                   refine_extra=refine_intrinsics and extra_params is not None,
                   shared_intrinsics=shared_intrinsics,
                   robust_loss="huber", loss_scale=3.0, pose_only=True)
    dev = tracks.device
    extr_o, intr_o, extra_o, _, _ = bundle_adjust(
        extrinsics, intrinsics, points3d, tracks, obs_mask,
        extra_params=extra_params,
        pose_free=torch.ones(S, dtype=torch.bool, device=dev),
        intr_free=torch.ones(S, dtype=torch.bool, device=dev),
        point_free=torch.zeros(N, dtype=torch.bool, device=dev), cfg=cfg)

    valid = camera_validity_mask(intr_o, extr_o, image_size, extra_o)
    # a 7-DoF camera against fewer than ~6 points is underdetermined: keep
    # the input camera for starved frames (and never PnP them)
    n_obs = obs_mask.sum(1)
    valid = valid & (n_obs >= 6)

    if force_estimate and draws is not None:
        # 1. pose-only competition at the frame's current focal: the PnP
        #    pose wins where the LM pose is broken (error above `rescue`)
        #    and PnP fits the cloud better, or where the LM camera left
        #    the validity window; 2. the focal sweep only for frames still
        #    invalid (letting it compete on valid frames drifts the focal
        #    on near-planar geometry)
        sub, sample_idx = draws
        if sub is not None:
            sub = sub.to(dev)
            points3d_p, tracks_p, obs_mask_p = (points3d[sub],
                                                tracks[:, sub],
                                                obs_mask[:, sub])
        else:
            points3d_p, tracks_p, obs_mask_p = points3d, tracks, obs_mask
        pts_b = points3d_p[None].expand(S, *points3d_p.shape)
        err_lm = _frame_reproj_error(extr_o, intr_o, points3d, tracks,
                                     obs_mask)
        w = obs_mask.to(torch.float32)

        def cheirality_frac(extr):
            z = extr[:, 2, :3] @ points3d.T + extr[:, 2, 3][:, None]
            return ((z > 0) * w).sum(1) / torch.clamp(w.sum(1), min=1.0)

        def pnp(f_trials):
            res = absolute_pose_ransac(pts_b, tracks_p, intrinsics,
                                       valid_mask=obs_mask_p,
                                       f_trials=f_trials,
                                       max_ransac_iters=PNP_ITERS,
                                       sample_idx=sample_idx)
            ok = camera_validity_mask(res["intrinsics"], res["extrinsics"],
                                      image_size)
            # a near-planar cloud admits a flipped pose: never adopt one
            # that puts a chunk of the cloud behind the camera
            ok = ok & (cheirality_frac(res["extrinsics"]) > 0.8)
            return res, ok & (n_obs >= 8)

        res, pnp_valid = pnp(1)
        rescue = 8.0
        err_pnp = _frame_reproj_error(res["extrinsics"], res["intrinsics"],
                                      points3d, tracks, obs_mask)
        use = pnp_valid & (~valid | ((err_pnp < err_lm) & (err_lm > rescue)))
        extr_o = torch.where(use[:, None, None], res["extrinsics"], extr_o)
        intr_o = torch.where(use[:, None, None], res["intrinsics"], intr_o)
        valid = valid | use

        if not shared_intrinsics and bool((~valid).any()):
            res, ok = pnp(17)
            use = ok & ~valid
            extr_o = torch.where(use[:, None, None], res["extrinsics"],
                                 extr_o)
            intr_o = torch.where(use[:, None, None], res["intrinsics"],
                                 intr_o)
            valid = valid | use

    extr_o = torch.where(valid[:, None, None], extr_o, extrinsics)
    intr_o = torch.where(valid[:, None, None], intr_o, intrinsics)
    if extra_params is not None:
        extra_o = torch.where(valid[:, None], extra_o, extra_params)
    else:
        extra_o = None
    return extr_o, intr_o, extra_o, valid
