"""GT camera normalization and crop/scale intrinsics adjustment (PyTorch).
Counterpart of vggsfm_tpu/datasets/camera_transform.py (reference
vggsfm/datasets/camera_transform.py:33-258: `adjust_camera_to_bbox_crop_`,
`adjust_camera_to_image_scale_`, `normalize_cameras`).

Pixel-space OpenCV `K` / `[R|t]` math on batched tensors, with no NDC
round trip. Inputs may be numpy arrays or tensors; the result is a tensor
of the input's dtype (f64 stays f64) on the input's device (numpy: the
CPU). The optical-axis meet is the least-squares solution of the skew-line
normal equations. The products are written out elementwise, so no TF32
path is taken.
"""

from __future__ import annotations

import torch


def _tensor(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """`x` as a tensor; with `like`, in its dtype and on its device."""
    t = x if torch.is_tensor(x) else torch.as_tensor(x)
    if like is not None:
        t = t.to(like.device, like.dtype)
    return t


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an elementwise sum."""
    return (A * x[..., None, :]).sum(-1)


def adjust_intrinsics_to_crop(intrinsics, bbox_xywh) -> torch.Tensor:
    """Shift principal points for a crop whose top-left is (x, y):
    intrinsics (..., 3, 3) in pixels, bbox_xywh (..., 4) [x, y, w, h]
    (w and h unused: a crop never rescales). The pixel-space effect of the
    reference's NDC round trip is exactly ``pp -= bbox[:2]``."""
    K = _tensor(intrinsics).clone()
    bbox = _tensor(bbox_xywh, K)
    K[..., :2, 2] = K[..., :2, 2] - bbox[..., :2]
    return K


def adjust_intrinsics_to_scale(intrinsics, original_wh,
                               new_wh) -> torch.Tensor:
    """Rescale K for a resize from `original_wh` to `new_wh`, by the
    smaller of the two ratios (an aspect-preserving resize)."""
    K = _tensor(intrinsics)
    scale = torch.amin(_tensor(new_wh, K) / _tensor(original_wh, K),
                       dim=-1)[..., None, None]
    K = K * scale
    K[..., 2, 2] = 1.0
    return K


def adjust_intrinsics_from_crop_params(intrinsics, crop_params,
                                       img_size: int) -> torch.Tensor:
    """Original-pixel K -> model-input-pixel K through the loader's
    8-vector ``crop_params = [W, H, crop_width, s, bbox_after(4)]``
    (`datasets.demo_loader.crop_parameters`: a square crop to max(W, H),
    then a resize to `img_size`)."""
    K = _tensor(intrinsics)
    params = _tensor(crop_params, K)
    crop_dim = torch.maximum(params[..., 0], params[..., 1])
    bbox = params[..., 4:8] * (crop_dim[..., None] / img_size)
    K = adjust_intrinsics_to_crop(K, bbox)
    wh = torch.stack([crop_dim, crop_dim], dim=-1)
    return adjust_intrinsics_to_scale(K, wh, torch.full_like(wh, img_size))


def optical_axis_intersection(extrinsics):
    """Least-squares meet of the cameras' optical axes: extrinsics
    (S, 3, 4) OpenCV world->cam -> (point (3,), dist (S,) from each camera
    center). Solves ``sum_s (I - d_s d_sᵀ)(x - c_s) = 0`` with c_s the
    camera center and d_s its viewing direction (the third row of R)."""
    extr = _tensor(extrinsics)
    R, t = extr[:, :, :3], extr[:, :, 3]
    centers = -(R * t[:, :, None]).sum(1)  # -Rᵀ t
    dirs = R[:, 2, :]
    eye = torch.eye(3, dtype=extr.dtype, device=extr.device)
    P = eye[None] - dirs[:, :, None] * dirs[:, None, :]
    A = P.sum(0)
    b = _matvec(P, centers).sum(0)
    # A is rank-deficient only when every axis is parallel: the minimum-
    # norm solution through the pseudo-inverse, as lstsq gives it
    point = _matvec(torch.linalg.pinv(A), b)
    dist = torch.linalg.vector_norm(point[None] - centers, dim=-1)
    return point, dist


def first_camera_transform(extrinsics, points=None):
    """Re-express cameras (S, 3, 4), and optional points (N, 3), relative
    to camera 0: (extrinsics, points)."""
    extr = _tensor(extrinsics)
    R0, t0 = extr[0, :, :3], extr[0, :, 3]
    R, t = extr[:, :, :3], extr[:, :, 3]
    R_new = (R[:, :, None, :] * R0[None, None, :, :]).sum(-1)  # R_s R_0ᵀ
    t_new = t - _matvec(R_new, t0)
    out = torch.cat([R_new, t_new[..., None]], dim=-1)
    if points is not None:
        points = _matvec(R0, _tensor(points, extr)) + t0[None]
    return out, points


def normalize_cameras(extrinsics, points=None, compute_optical=True,
                      first_camera=True, normalize_trans=True,
                      scale: float = 1.0, max_norm: bool = False):
    """Normalize a GT camera set as the reference trains and evaluates:

    1. (compute_optical) move the world origin to the optical-axis
       intersection and divide by the first camera's distance to it;
    2. (first_camera) re-express everything relative to camera 0;
    3. (normalize_trans) divide translations (and points) by the mean
       (with `max_norm` the max) translation norm, times `scale`.

    extrinsics (S, 3, 4) OpenCV world->cam, points optional (N, 3) ->
    (extrinsics, points)."""
    extr = _tensor(extrinsics)
    if points is not None:
        points = _tensor(points, extr)
    R, t = extr[:, :, :3], extr[:, :, 3]

    if compute_optical:
        p_int, dist = optical_axis_intersection(extr)
        s = torch.where(dist[0] > 1e-8, dist[0], 1.0)
        # the world shift x -> x - p_int: t' = t + R p_int, then the scale
        t = (t + _matvec(R, p_int)) / s
        extr = torch.cat([R, t[..., None]], dim=-1)
        if points is not None:
            points = (points - p_int[None]) / s

    if first_camera:
        extr, points = first_camera_transform(extr, points)
        t = extr[:, :, 3]

    if normalize_trans:
        norms = torch.linalg.vector_norm(t, dim=-1)
        denom = norms.max() if max_norm else norms.mean()
        denom = torch.where(denom > 1e-8, denom, 1.0) / scale
        t = t / denom
        extr = torch.cat([extr[:, :, :3], t[..., None]], dim=-1)
        if points is not None:
            points = points / denom

    return extr, points
