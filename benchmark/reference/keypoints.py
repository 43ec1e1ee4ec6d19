"""Keypoints from an ALIKED score map, frozen: strict local maxima over a
(2r+1)^2 neighbourhood (wrapping at the edges) inside a 4-pixel border,
the K strongest kept, the lower flat index first among equal scores."""

from __future__ import annotations

import torch

from .aliked import ALIKED


def neighborhood_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the (2r+1)^2 neighbours of each pixel of (..., H, W), the
    pixel itself left out, wrapping at the edges."""
    neigh = torch.full_like(x, float("-inf"))
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(x, (dy, dx), (-2, -1)))
    return neigh


def top_k_stable(score: torch.Tensor, k: int):
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def border_mask(h: int, w: int, border: int, device=None) -> torch.Tensor:
    mask = torch.zeros(h, w, dtype=torch.bool, device=device)
    mask[border:-border, border:-border] = True
    return mask


def keypoints_from_heatmap(heat: torch.Tensor, max_keypoints: int,
                           nms_radius: int, border: int = 4):
    """(..., H, W) score maps -> (xy (..., K, 2), score (..., K),
    valid (..., K)), strongest first."""
    H, W = heat.shape[-2:]
    peak = heat > neighborhood_max(heat, nms_radius)
    peak &= border_mask(H, W, border, heat.device)
    score = torch.where(peak, heat, torch.zeros_like(heat))
    top_score, top_idx = top_k_stable(score.flatten(-2), max_keypoints)
    xy = torch.stack([top_idx % W, top_idx // W], dim=-1).float()
    return xy, top_score, top_score > 0.0


@torch.no_grad()
def aliked_keypoints(model: ALIKED, images: torch.Tensor,
                     max_keypoints: int, nms_radius: int = 2):
    """(B, H, W, 3) RGB in [0, 1] -> the ALIKED peaks, as
    `keypoints_from_heatmap`."""
    return keypoints_from_heatmap(model(images.float()), max_keypoints,
                                  nms_radius)
