"""Correlation sampling of tracks against the levels of a feature pyramid.

Counterpart of vggsfm_tpu/ops/corr_pallas.py (`corr_sample_pallas`,
`corr_sample_pallas_smallc`), and of the JAX tracker's other correlation
routes (`corr_sample`, `corr_sample_flat`), which compute the same
function. Per track and level i: the dots of its feature with the
(2r+2)^2 integer-grid cells around floor(position / 2^i), cells outside
the map counting 0 wherever the window lies (the contract of the JAX
package's gather path; its TPU kernels clip the window's corner into a map
padded by r + 2 cells, so they return a shifted window for a track more
than two cells outside the map), then the bilinear combine into the
(2r+1)^2 taps and the 1/sqrt(C) scale. Products are exact in f32 and every
sum is f32; the result is rounded once, to the output dtype.

  * `corr_sample_kernel` launches the hand-written CUDA kernel
    (csrc/corr_sample.cu, built at first use by ops/_build.py) once for
    all levels of a call, for CUDA tensors, or raises if the kernel does
    not take the inputs; CPU tensors, and only those, take
    `corr_sample_plain`.
  * `corr_sample_plain` is the same function in plain PyTorch, with the
    same signature: a gather of the window's features, f32 sums.
  * Each launch counts in `launch_counts` under the TPU kernel whose
    contract it serves: `corr_sample_pallas_smallc` for C < 128,
    `corr_sample_pallas` for C >= 128.
  * `corr_flops` is the kernel's FLOP formula.

Levels are (F, H_i, W_i, C) views of any strides; the kernel reads the two
layouts the tracker keeps, NHWC (channel stride 1) and the flat
channel-first fine pyramid (column stride 1), in place, in float32 or
bfloat16 at any 1 <= C <= 2048, 1 <= radius <= 7, up to 8 levels of up to
2^20 cells a side. The features come in the maps' dtype. The kernel's
gates (csrc/corr_sample.cuh `check_shape`, `plan`) replace the TPU
kernels' (`C % 128 == 0`, the 8-track block, the ``y * 4096 + x`` packing
that capped the padded width at 4096, the (8, 128)-aligned covering block,
float32 maps at C >= 128).
"""

from __future__ import annotations

import ctypes

import torch

from vggsfm_tpu_torch.ops import _build, launch_counts

MAX_C = 2048
MAX_RADIUS = 7
MAX_LEVELS = 8
SMALL_C = 128  # below it the call counts as `corr_sample_pallas_smallc`

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def corr_flops(F: int, N: int, C: int, radius: int, L: int) -> int:
    """The FLOPs of one call: per track and level the (2r+2)^2 dots of C
    products (what FlopCounterMode counts of the plain version's batched
    product; the bilinear combine is elementwise).
    benchmark/tests/test_bench_work.py holds the benchmark's own copy
    (benchmark/harness/work.py) to it."""
    return 2 * F * N * L * (2 * radius + 2) ** 2 * C


def window_index(centers: torch.Tensor, r: int, H: int, W: int):
    """Flat indices (..., (2r+2)^2) of the integer window whose top-left
    cell is floor(center) - r, the in-map mask, and the sub-cell offset."""
    base = torch.floor(centers)
    offs = torch.arange(-r, r + 2, device=centers.device)
    ix = base[..., 0].long()[..., None, None] + offs[None, :]
    iy = base[..., 1].long()[..., None, None] + offs[:, None]
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    shape = centers.shape[:-1] + (-1,)
    return flat.reshape(shape), ok.reshape(shape), centers - base


def window_from_dots(ci: torch.Tensor, frac: torch.Tensor,
                     r: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 taps from (..., 2r+2, 2r+2) integer-grid values;
    frac (..., 2) the sub-cell offset."""
    W1 = 2 * r + 1
    fx = frac[..., 0, None, None]
    fy = frac[..., 1, None, None]
    corr = ((1 - fy) * (1 - fx) * ci[..., :W1, :W1]
            + (1 - fy) * fx * ci[..., :W1, 1:]
            + fy * (1 - fx) * ci[..., 1:, :W1]
            + fy * fx * ci[..., 1:, 1:])
    return corr.reshape(*corr.shape[:-2], W1 * W1)


def corr_sample_plain(levels: list, coords: torch.Tensor,
                      track_feats: torch.Tensor, radius: int,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Plain version of `corr_sample_kernel`, same signature. levels:
    list of (F, H_i, W_i, C) of any strides; coords (F, N, 2) xy at
    level-0 scale; track_feats (F, N, C) -> (F, N, L * (2r+1)^2) in
    `out_dtype`."""
    F, N, _ = coords.shape
    C = track_feats.shape[-1]
    w = 2 * radius + 2
    feats = track_feats.float()
    frame = torch.arange(F, device=coords.device)[:, None, None]
    out = []
    for i, lvl in enumerate(levels):
        H, W = lvl.shape[1:3]
        idx, ok, frac = window_index(coords.float() / (2.0 ** i), radius, H,
                                     W)
        nb = lvl[frame, idx // W, idx % W].float() * ok[..., None]
        ci = torch.einsum("fnkc,fnc->fnk", nb, feats)
        out.append(window_from_dots(ci.reshape(F, N, w, w), frac, radius))
    return (torch.cat(out, dim=-1) * (1.0 / float(C) ** 0.5)).to(out_dtype)


def corr_sample_kernel(levels: list, coords: torch.Tensor,
                       track_feats: torch.Tensor, radius: int,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Correlation of tracks against every level of a pyramid, one launch.

    levels: list of L (F, H_i, W_i, C) maps, all float32 or all bfloat16,
    every level with channel stride 1 (NHWC) or every level with column
    stride 1 (channel-first); coords (F, N, 2) float32 xy at level-0 scale
    (level i reads coords / 2^i), contiguous; track_feats (F, N, C) in the
    maps' dtype, channel stride 1. Returns (F, N, L * (2r+1)^2) in
    `out_dtype` (float32 or bfloat16), level i's taps at
    [i (2r+1)^2, (i+1) (2r+1)^2). CPU tensors take `corr_sample_plain`;
    CUDA tensors launch the kernel or raise.
    """
    dev = levels[0].device
    if dev.type == "cpu":
        return corr_sample_plain(levels, coords, track_feats, radius,
                                 out_dtype)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"corr_sample kernel takes 1 to {MAX_LEVELS} "
                         f"levels; got {len(levels)}")
    F, N = coords.shape[:2]
    C = track_feats.shape[-1]
    dt = levels[0].dtype
    if dt not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"corr_sample kernel takes float32 or bfloat16 "
                        f"maps and output; got {dt} and {out_dtype}")
    for name, t, dtype, shape in (
            [(f"level {i}", lvl, dt, (F, *lvl.shape[1:3], C))
             for i, lvl in enumerate(levels)]
            + [("coords", coords, torch.float32, (F, N, 2)),
               ("track_feats", track_feats, dt, (F, N, C))]):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{dtype} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if track_feats.stride(-1) != 1 and C > 1:
        raise ValueError("track_feats must have channel stride 1")
    if not (1 <= C <= MAX_C and 1 <= radius <= MAX_RADIUS):
        raise ValueError(f"corr_sample kernel takes 1 <= C <= {MAX_C} and "
                         f"1 <= radius <= {MAX_RADIUS}; got C={C}, "
                         f"radius={radius}")
    L = len(levels)
    out = torch.empty(F, N, L * (2 * radius + 1) ** 2, dtype=out_dtype,
                      device=dev)
    if F * N == 0:
        return out
    lib = _build.load_library()
    ptrs = (ctypes.c_longlong * L)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * L))(*[s for lvl in levels
                                    for s in lvl.shape[1:3]])
    strides = (ctypes.c_longlong * (4 * L))(*[s for lvl in levels
                                              for s in lvl.stride()])
    with torch.cuda.device(dev):
        rc = lib.vf_corr_sample(
            _DTYPES[dt], int(out_dtype == torch.bfloat16), L, ptrs, hw,
            strides, coords.data_ptr(), track_feats.data_ptr(),
            track_feats.stride(0), track_feats.stride(1), out.data_ptr(), F,
            N, C, radius, int(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"corr_sample kernel launch failed: code {rc}")
    launch_counts["corr_sample_pallas_smallc" if C < SMALL_C
                  else "corr_sample_pallas"] += 1
    return out
