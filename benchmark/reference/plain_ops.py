"""The plain versions of the port's hand-written kernels, frozen: the
fused former ops (whole pre-LN block, LN -> MLP tail, LN -> attention half)
and the correlation sampling. The public names the models call
(`fused_transformer_block`, `fused_ln_mlp`, `fused_ln_attn`,
`corr_sample_kernel`) are the plain functions themselves, on every device.

Numerics: every matrix product accumulates in f32; the working dtype's
rounding points are kept, so in float32 the functions are plain f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# mirrors the kernels' limits (csrc/fused_former.cuh check_*_shape)
MAX_C = 384          # whole-block kernel (64-row register tile)
MAX_WIDE_C = 768     # ln_mlp (32-row tile above 384) and ln_attn
MAX_L = 64
MAX_HEAD_DIM = 64    # whole-block kernel
MAX_ATTN_HEAD_DIM = 128

# kernels one fused_ln_attn call launches: LayerNorm, q|k|v projection,
# attention core, out-projection
ATTN_KERNELS = 4
# kernels one fused_ln_mlp call launches on the wide path: LayerNorm, fc1 +
# GELU, fc2 + residual
WIDE_MLP_KERNELS = 3

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_kernel_takes(C: int, seq_len: int, num_heads: int) -> bool:
    """Whether the whole-block kernel takes rows of width C in groups of
    `seq_len`; beyond it AttnBlock runs its two halves (`ln_attn_takes`,
    `mlp_route_takes`)."""
    return (16 <= C <= MAX_C and C % 16 == 0 and 1 <= seq_len <= MAX_L
            and C % num_heads == 0 and C // num_heads <= MAX_HEAD_DIM)


def mlp_kernel_takes(C: int) -> bool:
    return 16 <= C <= MAX_WIDE_C and C % 16 == 0


def mlp_route_takes(dtype, C: int) -> bool:
    """Whether a pre-LN MLP tail of width C in `dtype` goes to the
    fused_ln_mlp kernels. bf16 rows wider than 384 (the camera's
    cross-attention tails) take the wide path: WIDE_MLP_KERNELS launches
    per call, a LayerNorm pass and two tensor-core GEMMs (with M a
    multiple of 16; else one CUDA-core kernel). f32 rows wider than 384
    stay plain: the kernel's f32 instantiation runs on the CUDA cores,
    measured ~3x slower than the plain cuBLAS version at C = 384
    (PERF.md), and the JAX package keeps those tails (the camera's
    768-wide f32 trunk and self-attention MLPs) on its plain path too."""
    return mlp_kernel_takes(C) and (dtype == torch.bfloat16 or C <= MAX_C)


def ln_attn_takes(C: int, seq_len: int, num_heads: int) -> bool:
    """Whether the fused_ln_attn kernel takes rows of width C in groups of
    `seq_len` with `num_heads` heads; longer groups run plain attention."""
    return (16 <= C <= MAX_WIDE_C and C % 16 == 0 and 1 <= seq_len <= MAX_L
            and C % num_heads == 0
            and C // num_heads <= MAX_ATTN_HEAD_DIM)


# --------------------------------------------------------------- plain

def _ln32(x32: torch.Tensor) -> torch.Tensor:
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + 1e-6)


def _rt(t: torch.Tensor, dt) -> torch.Tensor:
    """Round an f32 tensor through dtype `dt`, back to f32."""
    return t.to(dt).float()


def _mlp_tail32(base32, w1, b1, w2, b2, dt):
    """base + fc2(gelu(fc1(LN(base)))) in f32, rounding where the kernel
    does. Products of dt values are exact in f32, so f32 matmuls of the
    widened operands are f32-accumulated dt products."""
    xn = _rt(_ln32(base32), dt)
    h = xn @ w1.float().t() + b1.float()
    h = _rt(F.gelu(h), dt)
    return base32 + (h @ w2.float().t() + b2.float())


def fused_ln_mlp_ref(x, w1, b1, w2, b2):
    """Plain version of `fused_ln_mlp`: x (R, C); w1 (M, C), b1 (M,),
    w2 (C, M), b2 (C,)."""
    return _mlp_tail32(x.float(), w1, b1, w2, b2, x.dtype).to(x.dtype)


def _attn_half32(x, w_in, b_in, w_out, b_out, L, H):
    """LN(x) + out_proj(attention(LN(x))) in f32, attention within each
    group of L consecutive rows, rounding where the kernels do."""
    dt = x.dtype
    R, C = x.shape
    D = C // H
    xn32 = _ln32(x.float())
    qkv = _rt(_rt(xn32, dt) @ w_in.float().t() + b_in.float(), dt)
    q, k, v = qkv.view(R // L, L, 3, H, D).unbind(2)
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * (1.0 / D ** 0.5)
    p = _rt(torch.softmax(s, -1), dt)
    o = _rt(torch.einsum("bhlm,bmhd->blhd", p, v), dt).reshape(R, C)
    return xn32 + (o @ w_out.float().t() + b_out.float())


def fused_ln_attn_ref(x, w_in, b_in, w_out, b_out, seq_len: int,
                      num_heads: int):
    """Plain version of `fused_ln_attn`: x (R, C) with each group of
    `seq_len` consecutive rows one attention group."""
    return _attn_half32(x, w_in, b_in, w_out, b_out, seq_len,
                        num_heads).to(x.dtype)


def fused_transformer_block_ref(x, w_in, b_in, w_out, b_out, w1, b1, w2,
                                b2, seq_len: int, num_heads: int):
    """Plain version of `fused_transformer_block`: x (R, C) with each
    group of `seq_len` consecutive rows one attention group."""
    x1 = _attn_half32(x, w_in, b_in, w_out, b_out, seq_len, num_heads)
    return _mlp_tail32(x1, w1, b1, w2, b2, x.dtype).to(x.dtype)


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


fused_ln_mlp = fused_ln_mlp_ref
fused_transformer_block = fused_transformer_block_ref
fused_ln_attn = fused_ln_attn_ref
corr_sample_kernel = corr_sample_plain
