"""Camera model and the camera predictor's pose codec (PyTorch).
Counterpart of vggsfm_tpu/geometry/cameras.py (reference
vggsfm/utils/triangulation_helpers.py:311-428, vggsfm/models/utils.py:
38-201, vggsfm/utils/metric.py:233-302).

A camera is an OpenCV world->camera extrinsic (..., 3, 4) ``[R | t]`` and an
intrinsic (..., 3, 3) ``[[fx, 0, cx], [0, fy, cy], [0, 0, 1]]``. The JAX
package pins these products to full f32 (``precision='highest'``); here the
3x3 products are written out elementwise (`_mm`), so they are f32 on any
device whatever the TF32 settings; the products over points run under
`f32_matmuls` (TF32 off). ``extra_params`` (..., K) is radial distortion,
K in {1, 2, 4} (SIMPLE_RADIAL / RADIAL / OPENCV).
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.geometry.distortion import (
    apply_distortion,
    undistort_points,
)
from vggsfm_tpu_torch.geometry.rotations import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k) @ (..., k, m) as an elementwise f32 sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def build_intrinsics(focal_length: torch.Tensor,
                     principal_point: torch.Tensor) -> torch.Tensor:
    """(..., 2) focal + (..., 2) principal point -> (..., 3, 3) K."""
    fx, fy = focal_length.unbind(-1)
    cx, cy = principal_point.unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([fx, zero, cx, zero, fy, cy, zero, zero, one], dim=-1)
    return K.reshape(*focal_length.shape[:-1], 3, 3)


def se3_inverse(extrinsic: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 4) or (..., 4, 4) transforms, same
    trailing shape out."""
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -_mm(Rt, t)], dim=-1)
    if extrinsic.shape[-2] == 4:
        bottom = extrinsic.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
            *top.shape[:-2], 1, 4)
        return torch.cat([top, bottom], dim=-2)
    return top


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) transforms: x -> a(b(x))."""
    Ra, ta = a[..., :3, :3], a[..., :3, 3:4]
    Rb, tb = b[..., :3, :3], b[..., :3, 3:4]
    return torch.cat([_mm(Ra, Rb), _mm(Ra, tb) + ta], dim=-1)


def camera_centers(extrinsic: torch.Tensor) -> torch.Tensor:
    """Projection centres C = -Rᵀ t of (..., 3, 4) extrinsics -> (..., 3)."""
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3:]
    return -_mm(R.transpose(-1, -2), t)[..., 0]


def img_from_cam(intrinsics: torch.Tensor, points_cam: torch.Tensor,
                 extra_params: torch.Tensor | None = None,
                 default: float = 0.0) -> torch.Tensor:
    """Camera-space points (..., 3, N) -> pixel coords (..., N, 2);
    non-finite pixels become `default`."""
    z = points_cam[..., 2, :]
    u = points_cam[..., 0, :] / z
    v = points_cam[..., 1, :] / z
    if extra_params is not None:
        u, v = apply_distortion(extra_params, u, v)
    K = intrinsics[..., None]  # (..., 3, 3, 1) against (..., N)
    pix = torch.stack([K[..., 0, 0, :] * u + K[..., 0, 1, :] * v
                       + K[..., 0, 2, :],
                       K[..., 1, 0, :] * u + K[..., 1, 1, :] * v
                       + K[..., 1, 2, :]], dim=-1)
    return torch.nan_to_num(pix, nan=default, posinf=default,
                            neginf=default)


@f32_matmuls
def project_points(points3D: torch.Tensor, extrinsics: torch.Tensor,
                   intrinsics: torch.Tensor | None = None,
                   extra_params: torch.Tensor | None = None,
                   return_points_cam: bool = False,
                   only_points_cam: bool = False):
    """Project world points (P, 3) through B cameras (B, 3, 4) ->
    pixels (B, P, 2); the camera-space points (B, 3, P) with
    `return_points_cam`, or alone with `only_points_cam`."""
    points_cam = (torch.matmul(extrinsics[..., :3], points3D.T)
                  + extrinsics[..., 3:])
    if only_points_cam:
        return points_cam
    points2D = img_from_cam(intrinsics, points_cam, extra_params)
    if return_points_cam:
        return points2D, points_cam
    return points2D


def cam_from_img(tracks: torch.Tensor, intrinsics: torch.Tensor,
                 extra_params: torch.Tensor | None = None,
                 undistort_iters: int = 25) -> torch.Tensor:
    """Pixel coords (..., N, 2) -> normalized camera coords, undistorted
    when `extra_params` is given."""
    pp = torch.stack([intrinsics[..., 0, 2], intrinsics[..., 1, 2]],
                     dim=-1)[..., None, :]
    fl = torch.stack([intrinsics[..., 0, 0], intrinsics[..., 1, 1]],
                     dim=-1)[..., None, :]
    normalized = (tracks - pp) / fl
    if extra_params is not None:
        normalized = undistort_points(extra_params, normalized,
                                      num_iters=undistort_iters)
    return normalized


def _pt3d_to_opencv(R: torch.Tensor, T: torch.Tensor):
    """PyTorch3D row-vector camera (R, T) -> OpenCV [R | t]: flip x and y
    and transpose (models/utils.py:121-145)."""
    flip = R.new_tensor([-1.0, -1.0, 1.0])
    return (R * flip).transpose(-1, -2), T * flip


def _opencv_to_pt3d(R: torch.Tensor, T: torch.Tensor):
    """Inverse of `_pt3d_to_opencv`."""
    flip = R.new_tensor([-1.0, -1.0, 1.0])
    return R.transpose(-1, -2) * flip, T * flip


def pose_encoding_to_extri_intri(pose_encoding: torch.Tensor, image_size_hw,
                                 min_focal_length: float = 0.1,
                                 max_focal_length: float = 30.0,
                                 relative_to_first: bool = True):
    """Decode (..., S, 8) ``absT_quaR_OneFL`` encodings to OpenCV cameras:
    (extrinsics (..., S, 3, 4), intrinsics (..., S, 3, 3)). The focal is
    one normalized dof scaled by min(H, W) / 2 and clamped to [0.2, 5] x
    min(H, W); the principal point is the image centre; with
    `relative_to_first` every camera is relative to camera 0."""
    abs_T = pose_encoding[..., :3]
    quat = pose_encoding[..., 3:7]
    focal_norm = pose_encoding[..., 7:8].clamp(min_focal_length,
                                               max_focal_length)
    R_cv, T_cv = _pt3d_to_opencv(quaternion_to_matrix(quat), abs_T)
    extrinsics = torch.cat([R_cv, T_cv[..., None]], dim=-1)
    if relative_to_first:
        first_inv = se3_inverse(extrinsics[..., 0, :, :])
        extrinsics = se3_compose(extrinsics, first_inv[..., None, :, :])
    H, W = (float(v) for v in image_size_hw)
    scale = min(H, W)
    focal_px = (focal_norm * scale / 2.0).clamp(0.2 * scale, 5.0 * scale)
    lead = pose_encoding.shape[:-1]
    focal_px = focal_px.expand(*lead, 2)
    pp = pose_encoding.new_tensor([W / 2.0, H / 2.0]).expand(*lead, 2)
    return extrinsics, build_intrinsics(focal_px, pp)


def extri_intri_to_pose_encoding(extrinsics: torch.Tensor,
                                 intrinsics: torch.Tensor, image_size_hw,
                                 min_focal_length: float = 0.1,
                                 max_focal_length: float = 30.0):
    """Inverse of `pose_encoding_to_extri_intri` (up to the first-camera
    gauge): (..., 3, 4) + (..., 3, 3) -> (..., 8)."""
    R_pt, T_pt = _opencv_to_pt3d(extrinsics[..., :3, :3],
                                 extrinsics[..., :3, 3])
    quat = matrix_to_quaternion(R_pt)
    scale = float(min(image_size_hw))
    focal_px = (intrinsics[..., 0, 0] + intrinsics[..., 1, 1]) / 2.0
    focal_norm = (focal_px * 2.0 / scale).clamp(min_focal_length,
                                                max_focal_length)
    return torch.cat([T_pt, quat, focal_norm[..., None]], dim=-1)


# ------------------------------------------------------------------ VGGT

def quat_xyzw_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (x, y, z, w), not necessarily unit, -> (..., 3,
    3) rotations (VGGT's `quat_to_mat`)."""
    i, j, k, r = quat.unbind(-1)
    two_s = 2.0 / (quat * quat).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], dim=-1)
    return o.reshape(*quat.shape[:-1], 3, 3)


def fov_pose_to_extri_intri(pose_encoding: torch.Tensor, image_size_hw):
    """Decode (..., 9) ``absT_quaR_FoV`` encodings (T, quaternion xyzw,
    FoV h, FoV w; VGGT's camera head) to OpenCV cameras: extrinsics
    [R | T] (..., 3, 4) and intrinsics (..., 3, 3) with f_y = (H / 2) /
    tan(fov_h / 2), f_x = (W / 2) / tan(fov_w / 2) and the principal point
    at the image centre."""
    H, W = (float(v) for v in image_size_hw)
    R = quat_xyzw_to_matrix(pose_encoding[..., 3:7])
    extrinsics = torch.cat([R, pose_encoding[..., :3, None]], dim=-1)
    fy = (H / 2.0) / torch.tan(pose_encoding[..., 7] / 2.0)
    fx = (W / 2.0) / torch.tan(pose_encoding[..., 8] / 2.0)
    pp = pose_encoding.new_tensor([W / 2.0, H / 2.0]).expand(
        *pose_encoding.shape[:-1], 2)
    return extrinsics, build_intrinsics(torch.stack([fx, fy], -1), pp)


def unproject_depth(depth: torch.Tensor, extrinsics: torch.Tensor,
                    intrinsics: torch.Tensor) -> torch.Tensor:
    """World points (S, H, W, 3) of every pixel (u, v) of (S, H, W) depth
    maps: R^T (depth K^-1 [u, v, 1]^T - T), elementwise in f32."""
    S, H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, device=depth.device),
                          torch.arange(W, device=depth.device),
                          indexing="ij")
    K = intrinsics[:, None, None]
    x = (u - K[..., 0, 2]) * depth / K[..., 0, 0]
    y = (v - K[..., 1, 2]) * depth / K[..., 1, 1]
    cam = torch.stack([x, y, depth], dim=-1) - extrinsics[:, None, None, :,
                                                          3]
    R = extrinsics[:, None, None, :, :3]
    return (R * cam[..., :, None]).sum(-2)
