"""Rotation representations (PyTorch). Counterpart of
vggsfm_tpu/geometry/rotations.py (reference
minipytorch3d/rotation_conversions.py:43-177).

PyTorch3D conventions: quaternions real part first (w, x, y, z), rotation
matrices act on column vectors (p' = R p). Everything is elementwise, so
the results are f32 on any device whatever the TF32 settings.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) [w, x, y, z] -> rotation matrices (..., 3, 3)."""
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(*quaternions.shape[:-1], 3, 3)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) [w, x, y, z]:
    the quaternion from each of the four diagonal branches, the branch with
    the largest denominator taken, then normalized."""
    m = matrix.reshape(*matrix.shape[:-2], 9)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01],
                    dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20],
                    dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21],
                    dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2],
                    dim=-1),
    ], dim=-2)  # (..., 4 branches, 4)
    cands = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = q_abs.argmax(-1)
    out = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=torch.finfo(matrix.dtype).tiny)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """A non-negative real part (q and -q are the same rotation)."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4), real part first."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (its conjugate)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def axis_angle_to_matrix(axis_angle: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Rodrigues: axis-angle vectors (..., 3) -> matrices (..., 3, 3), as
    ``I + A(θ) K + B(θ) K²`` with K from the raw vector and A = sinθ/θ,
    B = (1 - cosθ)/θ² Taylor-expanded near zero (smooth at ω = 0)."""
    x, y, z = axis_angle.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    K = K.reshape(*axis_angle.shape[:-1], 3, 3)
    theta2 = (axis_angle * axis_angle).sum(-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=eps * eps))
    small = theta2 < eps * eps
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.clamp(theta2, min=eps * eps))
    KK = (K[..., :, :, None] * K[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + A * K + B * KK


def so3_geodesic_angle(R1: torch.Tensor, R2: torch.Tensor,
                       eps: float = 1e-7) -> torch.Tensor:
    """Angle (radians) of the relative rotation R1ᵀR2, batched (..., 3, 3):
    only its trace is needed, sum_ij R1_ij R2_ij."""
    tr = (R1 * R2).sum((-2, -1))
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos)
