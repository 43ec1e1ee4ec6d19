"""Camera pose evaluation metrics (PyTorch). Counterpart of
vggsfm_tpu/geometry/metrics.py (reference vggsfm/utils/metric.py:107-218,
:305-332).

Relative rotation / translation angular errors over all camera pairs and
the AUC@τ aggregation of the IMC benchmark.
"""

from __future__ import annotations

import math

import torch

from vggsfm_tpu_torch.geometry.cameras import se3_compose, se3_inverse
from vggsfm_tpu_torch.geometry.rotations import so3_geodesic_angle


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between batched rotations, in degrees."""
    return so3_geodesic_angle(R1, R2) * (180.0 / math.pi)


def translation_angle_deg(t1: torch.Tensor, t2: torch.Tensor,
                          eps: float = 1e-15,
                          ambiguity: bool = True) -> torch.Tensor:
    """Angle between translation directions (degrees); with `ambiguity`,
    min(θ, 180° - θ) (a relative translation is defined up to sign)."""
    n1 = torch.linalg.vector_norm(t1, dim=-1)
    n2 = torch.linalg.vector_norm(t2, dim=-1)
    cos = (t1 * t2).sum(-1) / torch.clamp(n1 * n2, min=eps)
    deg = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)) * (
        180.0 / math.pi)
    if ambiguity:
        deg = torch.minimum(deg, 180.0 - deg)
    return deg


def _pair_indices(S: int, device=None):
    idx = torch.arange(S, device=device)
    i, j = torch.meshgrid(idx, idx, indexing="ij")
    return i, j, i < j


def relative_pose_errors(pred_extrinsics: torch.Tensor,
                         gt_extrinsics: torch.Tensor):
    """Pairwise relative rotation / translation errors (degrees) of two
    (S, 3, 4) camera sets: (rot_err (S*S,), trans_err (S*S,), mask (S*S,)
    of the unordered pairs i < j). rel_ij = extr_j ∘ extr_i⁻¹."""
    S = pred_extrinsics.shape[0]
    i, j, mask = _pair_indices(S, pred_extrinsics.device)
    i, j, mask = i.reshape(-1), j.reshape(-1), mask.reshape(-1)

    def rel(extr):
        return se3_compose(extr[j], se3_inverse(extr[i]))

    rel_pred = rel(pred_extrinsics)
    rel_gt = rel(gt_extrinsics)
    rot_err = rotation_angle_deg(rel_pred[..., :3, :3], rel_gt[..., :3, :3])
    trans_err = translation_angle_deg(rel_pred[..., :3, 3],
                                      rel_gt[..., :3, 3])
    return rot_err, trans_err, mask


def calculate_auc(r_error: torch.Tensor, t_error: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  max_threshold: int = 30) -> torch.Tensor:
    """AUC of the pose accuracy curve at integer thresholds
    1..max_threshold: the error of a pair is max(rot, trans); the curve is
    the normalized histogram's cumulative sum over [0, max_threshold)."""
    err = torch.maximum(r_error, t_error)
    if mask is not None:
        err = torch.where(mask, err, torch.inf)  # past the last bin
        n = mask.sum()
    else:
        n = torch.tensor(err.shape[0], device=err.device)
    bins = torch.arange(max_threshold + 1, dtype=err.dtype,
                        device=err.device)
    hist = ((err[None, :] >= bins[:-1, None])
            & (err[None, :] < bins[1:, None])).sum(-1).to(err.dtype)
    normalized = hist / torch.clamp(n, min=1)
    return torch.cumsum(normalized, 0).mean()


def pose_auc30(pred_extrinsics: torch.Tensor,
               gt_extrinsics: torch.Tensor) -> torch.Tensor:
    """AUC@30 between two camera sets (after any alignment)."""
    r_err, t_err, mask = relative_pose_errors(pred_extrinsics,
                                              gt_extrinsics)
    return calculate_auc(r_err, t_err, mask=mask, max_threshold=30)
