"""Bilinear feature sampling and resizing (NHWC, pixel coordinates).
Counterpart of vggsfm_tpu/models/sampling.py.

Coordinates are pixels (x in [0, W-1]); the reference wraps
``F.grid_sample(align_corners=True)`` in the same convention.
"""

from __future__ import annotations

import torch


def bilinear_sample(fmap: torch.Tensor, coords: torch.Tensor,
                    padding_mode: str = "border") -> torch.Tensor:
    """Sample (B, H, W, C) features at (B, ..., 2) xy pixel coords.

    Returns (B, ..., C). 'border' clamps; 'zeros' zeroes out-of-bounds
    corners (grid_sample semantics, align_corners=True).
    """
    B, H, W, C = fmap.shape
    lead = coords.shape[1:-1]
    xy = coords.reshape(B, -1, 2)
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(fmap.dtype)
    wy = (y - y0)[..., None].to(fmap.dtype)
    flat = fmap.reshape(B, H * W, C)

    def gather(ix, iy):
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        idx = (iyc * W + ixc)[..., None].expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx)
        if padding_mode == "zeros":
            ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            vals = vals * ok[..., None].to(vals.dtype)
        return vals

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return out.reshape(B, *lead, C)


def sample_features4d(fmap: torch.Tensor, coords: torch.Tensor):
    """(B, H, W, C) sampled at (B, N, 2) -> (B, N, C), border-clamped."""
    return bilinear_sample(fmap, coords, padding_mode="border")


def _interp_matrix(src_size: int, dst_size: int, align_corners: bool,
                   dtype, device=None) -> torch.Tensor:
    """(dst, src) bilinear interpolation matrix (border-clamped)."""
    if align_corners and dst_size > 1 and src_size > 1:
        src = torch.linspace(0.0, src_size - 1.0, dst_size,
                             dtype=torch.float32, device=device)
    else:
        src = ((torch.arange(dst_size, dtype=torch.float32, device=device)
                + 0.5) * (src_size / dst_size) - 0.5)
    src = src.clamp(0.0, src_size - 1.0)
    i0 = torch.floor(src).long().clamp(0, src_size - 1)
    i1 = (i0 + 1).clamp(max=src_size - 1)
    f = src - i0.float()
    rows = torch.arange(dst_size, device=device)
    M = torch.zeros(dst_size, src_size, dtype=torch.float32, device=device)
    M.index_put_((rows, i0), 1.0 - f, accumulate=True)
    M.index_put_((rows, i1), f, accumulate=True)
    return M.to(dtype)


def interpolate_bilinear(x: torch.Tensor, out_hw,
                         align_corners: bool = True) -> torch.Tensor:
    """Resize (B, H, W, C) -> (B, h, w, C), bilinear."""
    return interpolate_bilinear_nchw(x.permute(0, 3, 1, 2), out_hw,
                                     align_corners).permute(0, 2, 3, 1)


def interpolate_bilinear_nchw(x: torch.Tensor, out_hw,
                              align_corners: bool = True) -> torch.Tensor:
    """Resize (B, C, H, W) -> (B, C, h, w), bilinear, as two separable
    interpolation-matrix products."""
    H, W = x.shape[-2:]
    h, w = out_hw
    if (h, w) == (H, W):
        return x
    My = _interp_matrix(H, h, align_corners, x.dtype, x.device)
    Mx = _interp_matrix(W, w, align_corners, x.dtype, x.device)
    out = torch.einsum("oh,bchw->bcow", My, x)
    return torch.einsum("pw,bcow->bcop", Mx, out)


def subpixel_parabola(val):
    """Sub-pixel offsets from a 1D parabola fit around an argmax.

    `val(dy, dx)` reads the score at the integer offset (dy, dx) from the
    peak. Returns (off_x, off_y, peak_value); offsets are clipped to
    +/-0.5 and a flat neighborhood (denominator ~0) gives offset 0.
    """
    c0 = val(0, 0)

    def parabola(cm, cp):
        denom = cm + cp - 2.0 * c0
        safe = torch.where(denom.abs() < 1e-12, torch.ones_like(denom),
                           denom)
        return (0.5 * (cm - cp) / safe).clamp(-0.5, 0.5)

    off_x = parabola(val(0, -1), val(0, 1))
    off_y = parabola(val(-1, 0), val(1, 0))
    return off_x, off_y, c0
