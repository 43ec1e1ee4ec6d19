"""Radial / OpenCV lens distortion (PyTorch). Counterpart of
vggsfm_tpu/geometry/distortion.py (reference vggsfm/utils/distortion.py:
11-159).

The three COLMAP camera models the pipeline emits:
  K=1: SIMPLE_RADIAL (k),  K=2: RADIAL (k1, k2),  K=4: OPENCV (k1, k2, p1, p2).

Undistortion is Newton's method with the analytic Jacobian and the 2x2
system solved in closed form, for a fixed number of iterations (the JAX
package's `fori_loop`; here a Python loop of the same count, with no
data-dependent stop). Everything is elementwise.
"""

from __future__ import annotations

import torch


def _distortion_terms(extra_params: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor):
    """(du, dv) displacement of points; params (..., K), u/v (..., N)."""
    K = extra_params.shape[-1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    if K == 1:
        radial = extra_params[..., 0:1] * r2
        return u * radial, v * radial
    if K == 2:
        k1, k2 = extra_params[..., 0:1], extra_params[..., 1:2]
        radial = k1 * r2 + k2 * r2 * r2
        return u * radial, v * radial
    if K == 4:
        k1, k2 = extra_params[..., 0:1], extra_params[..., 1:2]
        p1, p2 = extra_params[..., 2:3], extra_params[..., 3:4]
        uv = u * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
        dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
        return du, dv
    raise ValueError(f"Unsupported number of distortion parameters: {K}")


def apply_distortion(extra_params: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor):
    """Distort normalized coords. params (..., K); u, v (..., N)."""
    du, dv = _distortion_terms(extra_params, u, v)
    return u + du, v + dv


def _distortion_jacobian(extra_params: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor):
    """(J00, J01, J10, J11) of d(u + du, v + dv)/d(u, v)."""
    K = extra_params.shape[-1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    k1 = extra_params[..., 0:1]
    k2 = extra_params[..., 1:2] if K >= 2 else torch.zeros_like(k1)
    radial = k1 * r2 + k2 * r2 * r2
    dr = k1 + 2.0 * k2 * r2  # d(radial)/d(r2)
    J00 = 1.0 + radial + 2.0 * u2 * dr
    J01 = 2.0 * u * v * dr
    J10 = J01
    J11 = 1.0 + radial + 2.0 * v2 * dr
    if K == 4:
        p1, p2 = extra_params[..., 2:3], extra_params[..., 3:4]
        J00 = J00 + 2.0 * p1 * v + 6.0 * p2 * u
        J01 = J01 + 2.0 * p1 * u + 2.0 * p2 * v
        J10 = J10 + 2.0 * p2 * v + 2.0 * p1 * u
        J11 = J11 + 2.0 * p2 * u + 6.0 * p1 * v
    return J00, J01, J10, J11


def undistort_points(extra_params: torch.Tensor,
                     tracks_normalized: torch.Tensor,
                     num_iters: int = 25) -> torch.Tensor:
    """Invert `apply_distortion` by `num_iters` Newton steps: params
    (..., K), distorted normalized points (..., N, 2) -> (..., N, 2)."""
    target_u = tracks_normalized[..., 0]
    target_v = tracks_normalized[..., 1]
    u, v = target_u, target_v
    for _ in range(num_iters):
        fu, fv = apply_distortion(extra_params, u, v)
        rx = target_u - fu
        ry = target_v - fv
        J00, J01, J10, J11 = _distortion_jacobian(extra_params, u, v)
        det = J00 * J11 - J01 * J10
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        u, v = (u + (J11 * rx - J01 * ry) / det,
                v + (-J10 * rx + J00 * ry) / det)
    return torch.stack([u, v], dim=-1)


def single_undistortion(extra_params: torch.Tensor,
                        tracks_normalized: torch.Tensor) -> torch.Tensor:
    """One forward application of the distortion (the reference's cheap
    stand-in for the iterative path, distortion.py:11-24)."""
    u, v = apply_distortion(extra_params, tracks_normalized[..., 0],
                            tracks_normalized[..., 1])
    return torch.stack([u, v], dim=-1)
