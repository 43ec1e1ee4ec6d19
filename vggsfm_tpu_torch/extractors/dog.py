"""Difference-of-Gaussians keypoint detector (SIFT-style), PyTorch.
Counterpart of vggsfm_tpu/extractors/dog.py: the scale-space extrema stage
of SIFT (Gaussian pyramid, DoG, 3x3x3 non-max suppression, contrast and
edge-response tests) as fixed-shape tensor ops with a top-K selection.

Every function takes a single (H, W) image or a batch (..., H, W). The
shifted comparisons wrap at the image edge (`torch.roll`), as `jnp.roll`
does in the JAX package; the 4-px border mask hides most of it.
"""

from __future__ import annotations

import torch


def _gaussian_kernel1d(sigma: float, radius: int, device=None):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur_matrix(n: int, sigma: float, device=None) -> torch.Tensor:
    """(n, n) matrix of a 1D Gaussian blur with edge padding: row i holds
    the kernel centred on i, the taps beyond either end added onto the
    first / last column."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, device)
    rows = torch.arange(n, device=device)[:, None].expand(n, 2 * radius + 1)
    cols = (rows + torch.arange(-radius, radius + 1, device=device)).clamp(
        0, n - 1)
    M = torch.zeros(n, n, dtype=torch.float32, device=device)
    M.index_put_((rows, cols), k.expand(n, -1), accumulate=True)
    return M


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images: radius
    int(3 sigma + 0.5), edge padding, rows then columns. Two float32 matrix
    products (cuDNN's TF32 convolutions would lose the DoG's small
    differences)."""
    H, W = img.shape[-2:]
    img = _blur_matrix(H, sigma, img.device) @ img
    return img @ _blur_matrix(W, sigma, img.device).T


def top_k_stable(score: torch.Tensor, k: int):
    """The k largest of (..., n) scores, strongest first, the lower index
    first among equal scores (`jax.lax.top_k`'s order; `torch.topk`
    promises none, and every rejected candidate ties at 0)."""
    if k > score.shape[-1]:
        raise ValueError(f"top-{k} of {score.shape[-1]} candidates")
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def border_mask(h: int, w: int, border: int, device=None) -> torch.Tensor:
    mask = torch.zeros(h, w, dtype=torch.bool, device=device)
    mask[border:-border, border:-border] = True
    return mask


def dog_stack(img: torch.Tensor, sigma0: float = 1.6,
              scales_per_octave: int = 3):
    """One octave of (..., h, w): its Gaussian levels (a list of S + 3) and
    their differences (..., S + 2, h, w)."""
    k = 2.0 ** (1.0 / scales_per_octave)
    gauss = [gaussian_blur(img, sigma0 * k ** s)
             for s in range(scales_per_octave + 3)]
    dogs = torch.stack([gauss[i + 1] - gauss[i]
                        for i in range(len(gauss) - 1)], dim=-3)
    return gauss, dogs


def dog_scores(dogs: torch.Tensor, contrast_thresh: float = 0.015,
               edge_ratio: float = 10.0) -> torch.Tensor:
    """|DoG| at the scale-space extrema of one octave's (..., S + 2, h, w)
    stack that pass the contrast and edge tests and the 4-px border guard,
    0 elsewhere: (..., S, h, w)."""
    h, w = dogs.shape[-2:]
    mid = dogs[..., 1:-1, :, :]
    # 3x3x3 neighborhood extremum test via shifted comparisons
    is_max = torch.ones_like(mid, dtype=torch.bool)
    is_min = torch.ones_like(mid, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                neigh = torch.roll(dogs, (ds, dy, dx),
                                   (-3, -2, -1))[..., 1:-1, :, :]
                is_max &= mid > neigh
                is_min &= mid < neigh
    extremum = (is_max | is_min) & (mid.abs() > contrast_thresh)

    # Harris-style edge rejection on the DoG surface
    dxx = torch.roll(mid, -1, -1) + torch.roll(mid, 1, -1) - 2 * mid
    dyy = torch.roll(mid, -1, -2) + torch.roll(mid, 1, -2) - 2 * mid
    dxy = 0.25 * (torch.roll(mid, (-1, -1), (-2, -1))
                  + torch.roll(mid, (1, 1), (-2, -1))
                  - torch.roll(mid, (-1, 1), (-2, -1))
                  - torch.roll(mid, (1, -1), (-2, -1)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    extremum &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    extremum &= border_mask(h, w, 4, dogs.device)
    return torch.where(extremum, mid.abs(), torch.zeros_like(mid))


def detect_dog_keypoints(image: torch.Tensor, max_keypoints: int = 4096,
                         num_octaves: int = 4, scales_per_octave: int = 3,
                         contrast_thresh: float = 0.015,
                         edge_ratio: float = 10.0):
    """Scale-space blob keypoints of grayscale (..., H, W) images in [0, 1].

    Returns (xy (..., K, 2) float pixel coords, score (..., K), valid
    (..., K) bool) with K = max_keypoints, strongest responses first.
    """
    lead = image.shape[:-2]
    all_xy, all_score = [], []
    img = image.float()
    scale_mult = 1.0
    for _ in range(num_octaves):
        h, w = img.shape[-2:]
        if min(h, w) < 16:
            break
        gauss, dogs = dog_stack(img, 1.6, scales_per_octave)
        score = dog_scores(dogs, contrast_thresh, edge_ratio)
        all_score.append(score.reshape(*lead, -1))
        yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                                torch.arange(w, device=img.device),
                                indexing="ij")
        xy = torch.stack([xx, yy], dim=-1).float() * scale_mult
        all_xy.append(xy.expand(scales_per_octave, h, w, 2).reshape(-1, 2))
        img = gauss[scales_per_octave][..., ::2, ::2]
        scale_mult *= 2.0

    xy = torch.cat(all_xy, dim=0)
    score = torch.cat(all_score, dim=-1)
    top_score, top_idx = top_k_stable(score, max_keypoints)
    return xy[top_idx], top_score, top_score > 0.0
