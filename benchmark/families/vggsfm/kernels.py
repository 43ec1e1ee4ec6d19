"""The kernels of the VGGSfM family as the benchmark reads them: where the
models reach each kernel function (the recorder wraps it there in a named
range while a scene is profiled), the shapes a call's work depends on, and
the work of one call from those shapes with its least time on the chip:
frozen copies of chip_smoke.py's `block_work`, `mlp_work`, `attn_work`,
`corr_work` and `bound_ms`, against the peaks of `harness/work.py`.

Each input byte counts once and each output byte once, whatever the
kernel reads again.
"""

from __future__ import annotations

from functools import partial

import torch

from benchmark.harness.work import HBM_BYTES_PER_S, PEAK_FLOPS


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


def _kernel_shapes(kind: str, args, kwargs) -> dict:
    """The shapes the work formulas need (and, for the correlation, a copy
    of the positions, whose windows decide the bytes read)."""
    x = args[0]
    if kind == "corr":
        levels, coords, feats, radius = args[:4]
        return dict(levels=[tuple(lv.shape) for lv in levels],
                    coords=coords.detach().clone(), radius=int(radius),
                    C=int(feats.shape[-1]), tsize=levels[0].element_size(),
                    out_dtype=str(args[4] if len(args) > 4
                                  else kwargs.get("out_dtype",
                                                  torch.float32)))
    R, C = x.shape
    d = dict(R=int(R), C=int(C), tsize=x.element_size(), dtype=str(x.dtype))
    if kind == "block":
        d.update(M=int(args[5].shape[0]), L=int(args[9]))
    elif kind == "mlp":
        d.update(M=int(args[1].shape[0]))
    else:
        d.update(L=int(args[5]))
    return d


# kind -> (module, attribute: the kernel function as the models reach it;
# the roofline group the kind's calls are summed in; the shapes of a call
# from its arguments; the least time of a call from those shapes)
KERNELS = {
    "block": ("vggsfm_tpu_torch.models.layers", "fused_transformer_block",
              "former", partial(_kernel_shapes, "block"),
              partial(bound_s, "block")),
    "mlp": ("vggsfm_tpu_torch.models.layers", "fused_ln_mlp", "former",
            partial(_kernel_shapes, "mlp"), partial(bound_s, "mlp")),
    "attn": ("vggsfm_tpu_torch.models.layers", "fused_ln_attn", "former",
             partial(_kernel_shapes, "attn"), partial(bound_s, "attn")),
    "corr": ("vggsfm_tpu_torch.models.tracker", "corr_sample_kernel",
             "corr", partial(_kernel_shapes, "corr"),
             partial(bound_s, "corr")),
}
