"""SE3 + scale alignment between camera sets (OpenCV convention), PyTorch.
Counterpart of vggsfm_tpu/geometry/alignment.py (reference
vggsfm/utils/align.py:145-252, `align_camera_extrinsics`,
`apply_transformation`).

The video runner stitches a window's predicted cameras onto the
registered trajectory with it. The rotation is the Procrustes solution on
the mean rotation covariance; translation and scale come from matching the
camera-frame projections of the translations (a camera-space Umeyama).
Full f32 products (TF32 off), as the JAX package pins them.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.utils.precision import f32_matmuls


@f32_matmuls
def align_camera_extrinsics(cameras_src: torch.Tensor,
                            cameras_tgt: torch.Tensor,
                            estimate_scale: bool = True,
                            eps: float = 1e-9):
    """Find (R, T, s) with cam_tgt ≈ transform(cam_src): (B, 3, 4) OpenCV
    [R|t] extrinsics each -> align_R (3, 3), align_T (3,), align_s (0-d)
    such that `apply_transformation(cameras_src, align_R, align_T,
    align_s)` matches `cameras_tgt` when the two sets differ by a
    world-frame similarity."""
    R_src = cameras_src[:, :, :3]
    R_tgt = cameras_tgt[:, :, :3]

    RRcov = torch.einsum("bji,bjk->bik", R_tgt, R_src).mean(0)
    # torch.svd returns V (not Vh); align_R = V @ Uᵀ. A plain SVD, as
    # jnp.linalg.svd: no sign fix of the factors (V Uᵀ may be a
    # reflection where the JAX package's is one)
    U, _, Vh = torch.linalg.svd(RRcov)
    align_R = Vh.T @ U.T

    T_src = cameras_src[:, :, 3]
    T_tgt = cameras_tgt[:, :, 3]
    # translations in each source camera's world-aligned frame:
    # A_b = T_src_b ᵀ R_src_b,  B_b = T_tgt_b ᵀ R_src_b
    A = torch.einsum("bi,bij->bj", T_src, R_src)
    B = torch.einsum("bi,bij->bj", T_tgt, R_src)
    Amu = A.mean(0)
    Bmu = B.mean(0)

    if estimate_scale and cameras_src.shape[0] > 1:
        Ac = A - Amu
        Bc = B - Bmu
        align_s = (Ac * Bc).mean() / torch.clamp((Ac ** 2).mean(), min=eps)
    else:
        align_s = torch.ones((), dtype=cameras_src.dtype,
                             device=cameras_src.device)
    align_T = Bmu - align_s * Amu
    return align_R, align_T, align_s


@f32_matmuls
def apply_transformation(cameras_src: torch.Tensor, align_R: torch.Tensor,
                         align_T: torch.Tensor, align_s: torch.Tensor,
                         return_extri: bool = True):
    """Apply a world-frame similarity to (B, 3, 4) extrinsics:
    R' = R @ align_R, t' = R @ align_T + s * t."""
    R_src = cameras_src[:, :, :3]
    T_src = cameras_src[:, :, 3]
    aligned_R = R_src @ align_R
    aligned_T = torch.einsum("bij,j->bi", R_src, align_T) + T_src * align_s
    if return_extri:
        return torch.cat([aligned_R, aligned_T[..., None]], dim=-1)
    return aligned_R, aligned_T
