"""Correlation sampling of a few tracks against one pyramid level.

Counterpart of vggsfm_tpu/ops/corr_pallas.py (`corr_sample_pallas`,
`corr_sample_pallas_smallc`). Per track: the dots of its feature with the
(2r+2)^2 integer-grid cells around floor(position), cells outside the map
counting 0 wherever the window lies (the contract of the JAX package's
gather path; its TPU kernels clip the window's corner into a map padded by
r + 2 cells, so they return a shifted window for a track more than two
cells outside the map), then the bilinear combine into the (2r+1)^2 taps and the
1/sqrt(C) scale. Every sum is f32 and the result is f32.

  * `corr_sample_kernel` launches the hand-written CUDA kernel
    (csrc/corr_sample.cu, built at first use by ops/_build.py) for CUDA
    tensors, or raises if the kernel does not take the inputs; CPU tensors,
    and only those, take `corr_sample_plain`.
  * `corr_sample_plain` is the same function in plain PyTorch: a gather of
    the window's features, exact products in f32.
  * Each launch counts in `launch_counts` under the TPU kernel whose
    contract it serves: `corr_sample_pallas_smallc` for C < 128 (maps and
    features in the map's dtype, float32 or bfloat16), `corr_sample_pallas`
    for C >= 128 (float32 maps and features).

The kernel's gates (csrc/corr_sample.cuh `check_shape`) replace the TPU
kernels' (`C % 128 == 0`, the 8-track block, the ``y * 4096 + x`` packing
that capped the padded width at 4096, the (8, 128)-aligned covering block):
any 1 <= C <= 2048, any N, 1 <= radius <= 7, maps up to 2^20 cells a side;
bfloat16 only for C < 128; contiguous tensors.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.ops import _build, launch_counts

MAX_C = 2048
MAX_RADIUS = 7
SMALL_C = 128  # below it the small-C contract: the map keeps its dtype

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def corr_sample_plain(fmap: torch.Tensor, coords: torch.Tensor,
                      track_feats: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of `corr_sample_kernel`, same signature: fmap
    (S, H, W, C), coords (S, N, 2) xy in cells, track_feats (S, N, C) ->
    (S, N, (2r+1)^2) float32."""
    S, H, W, C = fmap.shape
    N = coords.shape[1]
    w = 2 * radius + 2
    idx, ok, frac = window_index(coords.float(), radius, H, W)
    nb = torch.gather(fmap.reshape(S, H * W, C), 1,
                      idx.reshape(S, N * w * w, 1).expand(-1, -1, C))
    nb = nb.reshape(S, N, w * w, C).float() * ok[..., None].float()
    ci = torch.einsum("snkc,snc->snk", nb, track_feats.float())
    corr = window_from_dots(ci.reshape(S, N, w, w), frac, radius)
    return corr * (1.0 / float(C) ** 0.5)


def corr_sample_kernel(fmap: torch.Tensor, coords: torch.Tensor,
                       track_feats: torch.Tensor, radius: int) -> torch.Tensor:
    """Correlation of tracks against one pyramid level.

    fmap (S, H, W, C) and track_feats (S, N, C) of one dtype: float32 (any
    C) or bfloat16 (C < 128); coords (S, N, 2) float32 xy positions at this
    level's scale. Returns (S, N, (2r+1)^2) float32. CPU tensors take
    `corr_sample_plain`; CUDA tensors launch the kernel or raise.
    """
    if fmap.device.type == "cpu":
        return corr_sample_plain(fmap, coords, track_feats, radius)
    S, H, W, C = fmap.shape
    N = coords.shape[1]
    if fmap.dtype not in _DTYPES or (fmap.dtype == torch.bfloat16
                                     and C >= SMALL_C):
        raise TypeError(f"corr_sample kernel takes float32 maps, or "
                        f"bfloat16 maps with C < {SMALL_C}; got "
                        f"{fmap.dtype} with C={C}")
    want = {"fmap": (fmap.dtype, (S, H, W, C)),
            "coords": (torch.float32, (S, N, 2)),
            "track_feats": (fmap.dtype, (S, N, C))}
    for name, t in (("fmap", fmap), ("coords", coords),
                    ("track_feats", track_feats)):
        dtype, shape = want[name]
        if t.device != fmap.device or t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{dtype} on {fmap.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= C <= MAX_C and 1 <= radius <= MAX_RADIUS):
        raise ValueError(f"corr_sample kernel takes 1 <= C <= {MAX_C} and "
                         f"1 <= radius <= {MAX_RADIUS}; got C={C}, "
                         f"radius={radius}")
    out = torch.empty(S, N, (2 * radius + 1) ** 2, dtype=torch.float32,
                      device=fmap.device)
    if S * N == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(fmap.device):
        rc = lib.vf_corr_sample(
            _DTYPES[fmap.dtype], fmap.data_ptr(), coords.data_ptr(),
            track_feats.data_ptr(), out.data_ptr(), S, N, H, W, C, radius,
            int(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"corr_sample kernel launch failed: code {rc}")
    launch_counts["corr_sample_pallas_smallc" if C < SMALL_C
                  else "corr_sample_pallas"] += 1
    return out
