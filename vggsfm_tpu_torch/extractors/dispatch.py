"""Query-point extraction dispatcher. Counterpart of
vggsfm_tpu/extractors/dispatch.py (reference runners/runner.py:1336-1416):
run the configured extractor(s) on the query frame, invalidate masked and
out-of-bbox points, concatenate the methods ('sift+harris', ...), and
subsample to `max_query_num`. Shapes stay fixed (top-K with validity); the
random subsample is a permutation drawn from a `torch.Generator`, or given
by the caller.
"""

from __future__ import annotations

import os

import torch

from vggsfm_tpu_torch.extractors.corners import detect_harris_keypoints
from vggsfm_tpu_torch.extractors.dog import detect_dog_keypoints


def _to_gray(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W)."""
    return (0.299 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2])


def grid_keypoints(height: int, width: int, num: int, device=None):
    """Uniform grid fallback: at most `num` points, int(sqrt(num))^2 of
    them."""
    n_side = max(2, int(num ** 0.5))
    xs = torch.linspace(8, width - 8, n_side, device=device)
    ys = torch.linspace(8, height - 8, n_side, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)[:num]


def resolve_query_method(query_method: str) -> str:
    """Resolve the 'auto' default: 'aliked' with a trained ALIKED
    checkpoint (VGGSFM_TPU_ALIKED_CKPT), else 'sift+harris', the
    weights-free path."""
    if query_method != "auto":
        return query_method
    if os.environ.get("VGGSFM_TPU_ALIKED_CKPT"):
        return "aliked"
    return "sift+harris"


def candidate_points(images: torch.Tensor, query_method: str,
                     per_method: int):
    """Every method's candidates on (Q, H, W, 3) images in [0, 1],
    concatenated: (xy (Q, M, 2), valid (Q, M))."""
    from vggsfm_tpu_torch.extractors.cnn import (
        detect_aliked_keypoints,
        detect_superpoint_keypoints,
    )

    Q, H, W = images.shape[:3]
    gray = _to_gray(images)
    xys, valids = [], []
    for method in query_method.split("+"):
        if method == "sift":
            xy, _, valid = detect_dog_keypoints(gray, per_method)
        elif method == "harris":
            xy, _, valid = detect_harris_keypoints(gray, per_method)
        elif method == "aliked":
            xy, _, valid = detect_aliked_keypoints(images, per_method)
        elif method in ("sp", "superpoint"):
            xy, _, valid = detect_superpoint_keypoints(gray, per_method)
        elif method == "grid":
            xy = grid_keypoints(H, W, per_method, images.device)
            xy = xy.expand(Q, -1, -1)
            valid = torch.ones(xy.shape[:2], dtype=torch.bool,
                               device=images.device)
        else:
            raise ValueError(f"unknown query method {method}")
        xys.append(xy)
        valids.append(valid)
    return torch.cat(xys, dim=1), torch.cat(valids, dim=1)


def select_query_points(xy: torch.Tensor, valid: torch.Tensor,
                        perm: torch.Tensor, max_query_num: int):
    """The random subsample: the candidates in the order of `perm` (a
    permutation of their indices), the valid ones first (stable),
    truncated to `max_query_num`."""
    perm = perm.to(xy.device)
    rank = (~valid[perm]).long()
    sel = perm[torch.sort(rank, stable=True).indices][:max_query_num]
    return xy[sel], valid[sel]


def mask_query_points(xy, valid, hw, seg_invalid_mask=None, bound_bbox=None):
    """Invalidate points outside `bound_bbox` (x0, y0, x1, y1) or on a
    True pixel of the (H, W) `seg_invalid_mask`."""
    H, W = hw
    if bound_bbox is not None:
        x0, y0, x1, y1 = bound_bbox
        valid = valid & ((xy[:, 0] >= x0) & (xy[:, 0] < x1)
                         & (xy[:, 1] >= y0) & (xy[:, 1] < y1))
    if seg_invalid_mask is not None:
        ix = xy[:, 0].long().clamp(0, W - 1)
        iy = xy[:, 1].long().clamp(0, H - 1)
        valid = valid & ~seg_invalid_mask.to(xy.device)[iy, ix]
    return valid


def get_query_points(query_image: torch.Tensor,
                     generator: torch.Generator | None = None,
                     query_method: str = "sift", max_query_num: int = 4096,
                     seg_invalid_mask: torch.Tensor | None = None,
                     bound_bbox=None, perm: torch.Tensor | None = None):
    """Extract query keypoints from one (H, W, 3) image in [0, 1] (or a
    grayscale (H, W) one), on the image's device.

    The subsample's permutation is `perm` if given, else drawn from
    `generator` (a CPU generator). Returns (xy (max_query_num, 2), valid
    (max_query_num,)).
    """
    query_method = resolve_query_method(query_method)
    if query_image.dim() == 2:
        query_image = query_image[..., None].expand(-1, -1, 3)
    H, W = query_image.shape[:2]
    xy, valid = candidate_points(query_image[None], query_method,
                                 max_query_num)
    xy, valid = xy[0], valid[0]
    valid = mask_query_points(xy, valid, (H, W), seg_invalid_mask,
                              bound_bbox)
    if perm is None:
        perm = torch.randperm(xy.shape[0], generator=generator)
    return select_query_points(xy, valid, perm, max_query_num)


def get_query_points_batched(query_images: torch.Tensor,
                             generator: torch.Generator | None = None,
                             query_method: str = "sift",
                             max_query_num: int = 4096, perms=None):
    """`get_query_points` on (Q, H, W, 3) images without masks: one batched
    pass of each detector, then each frame's own permutation (drawn in
    frame order from `generator`, or `perms[q]`). Returns
    (xy (Q, max_query_num, 2), valid (Q, max_query_num))."""
    query_method = resolve_query_method(query_method)
    xy, valid = candidate_points(query_images, query_method, max_query_num)
    out = []
    for q in range(xy.shape[0]):
        perm = (perms[q] if perms is not None
                else torch.randperm(xy.shape[1], generator=generator))
        out.append(select_query_points(xy[q], valid[q], perm,
                                       max_query_num))
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))
