"""Pose accuracy against the planted cameras: a frozen copy of the port's
`geometry/metrics.relative_pose_errors` and `calculate_auc`, in float64 on
the host. Every pair (i < j) of frames scores max(rotation error,
translation-direction error) of its relative pose, in degrees; the AUC at
`max_threshold` is the mean of the cumulative share of pairs under 1, 2,
..., max_threshold degrees."""

from __future__ import annotations

import math

import torch


def _inverse(extr: torch.Tensor) -> torch.Tensor:
    R = extr[..., :3, :3].transpose(-1, -2)
    return torch.cat([R, -(R @ extr[..., :3, 3:])], dim=-1)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    R = a[..., :3, :3] @ b[..., :3, :3]
    t = a[..., :3, :3] @ b[..., :3, 3:] + a[..., :3, 3:]
    return torch.cat([R, t], dim=-1)


def relative_pose_errors(pred: torch.Tensor, gt: torch.Tensor):
    """(rotation, translation) errors in degrees of the S (S - 1) / 2
    frame pairs of two (S, 3, 4) camera sets."""
    S = pred.shape[0]
    i, j = torch.triu_indices(S, S, offset=1)

    def rel(extr):
        return _compose(extr[j], _inverse(extr[i]))

    rp, rg = rel(pred.double()), rel(gt.double())
    Rd = rp[:, :3, :3] @ rg[:, :3, :3].transpose(-1, -2)
    cos = ((Rd.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0)
    rot = torch.arccos(cos.clamp(-1.0, 1.0)) * (180.0 / math.pi)
    t1, t2 = rp[:, :3, 3], rg[:, :3, 3]
    c = (t1 * t2).sum(-1) / (t1.norm(dim=-1) * t2.norm(dim=-1)).clamp(
        min=1e-15)
    tr = torch.arccos(c.clamp(-1.0 + 1e-7, 1.0 - 1e-7)) * (180.0 / math.pi)
    return rot, torch.minimum(tr, 180.0 - tr)


def pose_auc(pred: torch.Tensor, gt: torch.Tensor,
             max_threshold: int = 5) -> float:
    rot, tr = relative_pose_errors(pred.detach().cpu(), gt.detach().cpu())
    err = torch.maximum(rot, tr)
    bins = torch.arange(max_threshold + 1, dtype=err.dtype)
    hist = ((err[None] >= bins[:-1, None]) & (err[None] < bins[1:, None]))
    share = hist.sum(-1).to(err.dtype) / max(err.numel(), 1)
    return float(torch.cumsum(share, 0).mean())
