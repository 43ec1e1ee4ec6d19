"""Work of one kernel call from its shapes, and its least time on the chip:
frozen copies of chip_smoke.py's `block_work`, `mlp_work`, `attn_work`,
`corr_work` and `bound_ms`, against the published peaks of one H100 SXM
(NVIDIA's data sheet, dense, at its 700 W limit).

A kernel's roofline share is its bound over its device time: the larger of
its operations over the peak rate and its bytes over the memory rate.
Each input byte counts once and each output byte once, whatever the
kernel reads again.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the step's share of the chip: the dense bf16 rate
STEP_PEAK_FLOPS = 989e12


def block_work(R, L, C, M, tsize):
    """A whole pre-LN block on R rows in groups of L: q|k|v, scores,
    weighted sum, out-projection, fc1, fc2; x in and out, the weights."""
    flops = R * (8 * C * C + 4 * L * C + 4 * C * M)
    nbytes = tsize * (2 * R * C + 4 * C * C + 2 * C * M + 5 * C + M)
    return flops, nbytes


def mlp_work(R, C, M, tsize):
    return R * 4 * C * M, tsize * (2 * R * C + 2 * C * M + C + M)


def attn_work(R, L, C, tsize):
    return R * (8 * C * C + 4 * L * C), tsize * (2 * R * C + 4 * C * C
                                                  + 4 * C)


def window_index(centers: torch.Tensor, r: int, H: int, W: int):
    """Flat indices of the (2r+2)^2 integer window whose top-left cell is
    floor(center) - r, and the in-map mask."""
    base = torch.floor(centers)
    offs = torch.arange(-r, r + 2, device=centers.device)
    ix = base[..., 0].long()[..., None, None] + offs[None, :]
    iy = base[..., 1].long()[..., None, None] + offs[:, None]
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    shape = centers.shape[:-1] + (-1,)
    return flat.reshape(shape), ok.reshape(shape)


def corr_work(levels, coords, radius, C, tsize, osize):
    """Each map cell under a window read once (cells outside the map are
    not read; a cell under several windows counts once), the features and
    positions once, the taps written once; two operations per map value
    and window, eight per tap. `levels`: the (F, H_i, W_i, C) shapes."""
    F, N = coords.shape[:2]
    cells = inmap = 0
    for i, shape in enumerate(levels):
        H, W = shape[1:3]
        idx, ok = window_index(coords / 2.0 ** i, radius, H, W)
        frame = torch.arange(F, device=idx.device)[:, None, None] * (H * W)
        cells += int(torch.unique((idx + frame)[ok]).numel())
        inmap += int(ok.sum())
    taps = len(levels) * (2 * radius + 1) ** 2
    nbytes = cells * C * tsize + F * N * (C * tsize + 8 + taps * osize)
    flops = 2 * inmap * C + 8 * F * N * taps
    return flops, nbytes


def bound_s(kind: str, s: dict) -> float:
    """The least time (s) of one call on the chip."""
    if kind == "corr":
        osize = 2 if s["out_dtype"] == "torch.bfloat16" else 4
        flops, nbytes = corr_work(s["levels"], s["coords"], s["radius"],
                                  s["C"], s["tsize"], osize)
        # the correlation's products run on the CUDA cores in f32
        peak = PEAK_FLOPS["torch.float32"]
    else:
        if kind == "block":
            flops, nbytes = block_work(s["R"], s["L"], s["C"], s["M"],
                                       s["tsize"])
        elif kind == "mlp":
            flops, nbytes = mlp_work(s["R"], s["C"], s["M"], s["tsize"])
        else:
            flops, nbytes = attn_work(s["R"], s["L"], s["C"], s["tsize"])
        peak = PEAK_FLOPS[s["dtype"]]
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
