"""Dense-depth utilities: the disparity-to-SfM alignment and COLMAP depth
maps (PyTorch). Counterpart of vggsfm_tpu/utils/depth.py (reference
vggsfm/utils/utils.py:603-770, the monocular disparity aligned to the
sparse reconstruction by a robust linear fit, and :340-390, the COLMAP
`.bin` array format: an ASCII "width&height&channels&" header, then
channel-major float32 data).

The RANSAC draws come from a `torch.Generator` (the runner seeds it with
``cfg.seed + 7``); ``sample_idx`` injects others, as the tests inject the
JAX package's. Every frame's fit runs at once on the maps' device, with
TF32 off for the one product (the points into each camera).
"""

from __future__ import annotations

import numpy as np
import torch

from vggsfm_tpu_torch.models.sampling import bilinear_sample
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def align_disparity_to_depth(disparity: torch.Tensor,
                             sparse_depth: torch.Tensor,
                             valid: torch.Tensor, sample_idx: torch.Tensor):
    """Fit 1 / depth = a * disparity + b robustly: 2-point RANSAC over the
    trials of `sample_idx`, then least squares on the best trial's inliers
    (relative error of the inverse depth < 0.1). Batched over leading
    axes: disparity, sparse_depth, valid (..., N); sample_idx
    (..., T, 2) indices into N. Returns (a (...), b (...), inlier mask
    (..., N)). Ties of the inlier count go to the first trial."""
    inv_depth = 1.0 / sparse_depth.clamp(min=1e-6)
    i0, i1 = sample_idx[..., 0], sample_idx[..., 1]
    d0 = torch.gather(disparity, -1, i0)
    d1 = torch.gather(disparity, -1, i1)
    y0 = torch.gather(inv_depth, -1, i0)
    y1 = torch.gather(inv_depth, -1, i1)
    dd = d1 - d0
    denom = torch.where(dd.abs() < 1e-9, torch.full_like(dd, 1e-9), dd)
    a = (y1 - y0) / denom
    b = y0 - a * d0

    pred = a[..., None] * disparity[..., None, :] + b[..., None]
    err = (pred - inv_depth[..., None, :]).abs()
    scale = inv_depth[..., None, :].abs().clamp(min=1e-6)
    inl = (err / scale < 0.1) & valid[..., None, :]
    best = torch.argmax(inl.sum(-1), dim=-1)  # the first of equal counts
    mask = torch.gather(inl, -2, best[..., None, None].expand(
        *best.shape, 1, inl.shape[-1]))[..., 0, :]

    # least-squares refit on the best trial's inliers
    w = mask.float()
    sw = w.sum(-1).clamp(min=1.0)
    mx = (w * disparity).sum(-1) / sw
    my = (w * inv_depth).sum(-1) / sw
    dx = disparity - mx[..., None]
    cov = (w * dx * (inv_depth - my[..., None])).sum(-1)
    var = (w * dx ** 2).sum(-1).clamp(min=1e-12)
    a_fit = cov / var
    return a_fit, my - a_fit * mx, mask


def disparity_to_depth_map(disparity_map: torch.Tensor, a, b):
    """Apply the fitted transform: depth = 1 / max(a * disp + b, 1e-6)."""
    return 1.0 / (a * disparity_map + b).clamp(min=1e-6)


@f32_matmuls
def align_depth_maps_to_sfm(disparity, extrinsics, points3d, tracks,
                            obs_mask, generator=None, num_trials: int = 256,
                            sample_idx=None):
    """Per-frame disparity maps -> metric depth maps aligned to the SfM
    points: for every frame, the disparity sampled (bilinear, border) at
    the 2D observations of valid 3D points, fitted robustly against their
    depths in that camera (`align_disparity_to_depth`), and the fit
    applied to the whole map; all frames at once.

    disparity (S, H, W); extrinsics (S, 3, 4) world-to-camera; points3d
    (N, 3); tracks (S, N, 2) pixels; obs_mask (S, N) valid observations
    of valid tracks. The (S, num_trials, 2) trial indices are drawn from
    `generator` (on the CPU) unless `sample_idx` gives them. Returns
    (depth_maps (S, H, W), a (S,), b (S,), inlier_frac (S,))."""
    S, N = obs_mask.shape
    dev = disparity.device
    R, t = extrinsics[:, :, :3], extrinsics[:, :, 3]
    sfm_depth = torch.einsum("sij,nj->sni", R, points3d)[..., 2] \
        + t[:, None, 2]
    valid = obs_mask.bool() & (sfm_depth > 1e-4)
    disp_sparse = bilinear_sample(disparity[..., None], tracks,
                                  padding_mode="border")[..., 0]
    if sample_idx is None:
        sample_idx = torch.randint(0, N, (S, num_trials, 2),
                                   generator=generator)
    sample_idx = torch.as_tensor(sample_idx).to(dev, torch.long)
    a, b, mask = align_disparity_to_depth(disp_sparse, sfm_depth, valid,
                                          sample_idx)
    depth_maps = disparity_to_depth_map(disparity, a[:, None, None],
                                        b[:, None, None])
    frac = mask.sum(-1) / valid.sum(-1).clamp(min=1)
    return depth_maps, a, b, frac


def write_colmap_array(path: str, array: np.ndarray) -> None:
    """COLMAP depth / normal map format (reference utils/utils.py:359-390)."""
    array = np.asarray(array, np.float32)
    if array.ndim == 2:
        array = array[..., None]
    h, w, c = array.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        f.write(array.transpose(2, 0, 1).reshape(-1).astype(
            "<f4").tobytes())


def read_colmap_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        amps = 0
        while amps < 3:
            ch = f.read(1)
            header += ch
            if ch == b"&":
                amps += 1
        w, h, c = (int(x) for x in header.decode()[:-1].split("&"))
        data = np.frombuffer(f.read(), "<f4")
    out = data.reshape(c, h, w).transpose(1, 2, 0)
    return out[..., 0] if c == 1 else out
