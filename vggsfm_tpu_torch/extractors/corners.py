"""Harris corner detector, PyTorch: the cheap query-point fallback.
Counterpart of vggsfm_tpu/extractors/corners.py. Gradients and the NMS
shifts wrap at the image edge (`torch.roll`), as in the JAX package."""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.extractors.dog import (
    border_mask,
    gaussian_blur,
    top_k_stable,
)


def harris_response(image: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response det - k tr^2 of grayscale (..., H, W) images, the
    structure tensor blurred with sigma 1.5."""
    dx = 0.5 * (torch.roll(image, -1, -1) - torch.roll(image, 1, -1))
    dy = 0.5 * (torch.roll(image, -1, -2) - torch.roll(image, 1, -2))
    Ixx = gaussian_blur(dx * dx, 1.5)
    Iyy = gaussian_blur(dy * dy, 1.5)
    Ixy = gaussian_blur(dx * dy, 1.5)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


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


def peaks_to_keypoints(score_map: torch.Tensor, max_keypoints: int):
    """Top-K of a (..., H, W) map of peak scores (0 where there is none) ->
    (xy (..., K, 2), score (..., K), valid (..., K))."""
    W = score_map.shape[-1]
    top_score, top_idx = top_k_stable(score_map.flatten(-2), max_keypoints)
    xy = torch.stack([top_idx % W, top_idx // W], dim=-1).float()
    return xy, top_score, top_score > 0.0


def detect_harris_keypoints(image: torch.Tensor, max_keypoints: int = 4096,
                            k: float = 0.04, nms_radius: int = 4):
    """Harris response + local NMS on grayscale (..., H, W) in [0, 1].

    Returns (xy (..., K, 2), score (..., K), valid (..., K)), strongest
    first.
    """
    H, W = image.shape[-2:]
    resp = harris_response(image.float(), k)
    is_peak = (resp > neighborhood_max(resp, nms_radius)) & (resp > 0)
    is_peak &= border_mask(H, W, 4, image.device)
    return peaks_to_keypoints(
        torch.where(is_peak, resp, torch.zeros_like(resp)), max_keypoints)
