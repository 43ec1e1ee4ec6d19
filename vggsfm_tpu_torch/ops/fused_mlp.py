"""Fused former ops: a whole pre-LN transformer block, the
LN -> MLP -> residual tail, and the LN -> attention -> residual half.

Counterparts of vggsfm_tpu/ops/fused_mlp.py (`fused_transformer_block`,
`fused_ln_mlp`, `fused_ln_attn`). Weights are in torch ``nn.Linear`` /
``nn.MultiheadAttention`` layout, (out, in). Each op has

  * a hand-written CUDA kernel (csrc/fused_former.cu, built at first use
    by ops/_build.py), which the wrapper launches for CUDA tensors — or
    raises, if the kernel does not take the inputs;
  * a plain PyTorch version (``*_ref``) of the same function with the same
    rounding points, which the wrapper takes only for CPU tensors;
  * a launch counter (`launch_counts`, shared with ops/corr.py), bumped
    once per kernel launch: one per `fused_transformer_block` call,
    WIDE_MLP_KERNELS per `fused_ln_mlp` call in f32 and on the wide path
    (else one; the library's `vf_ln_mlp_kernels`), ATTN_KERNELS per
    `fused_ln_attn` call;
  * a FLOP formula (``*_flops``): what FlopCounterMode counts of the
    plain version, its matrix products.

The route: `block_route_takes` and `mlp_route_takes` (the block and the
MLP tail) and `ln_attn_takes` (the attention half) decide, from the
dtype and the shapes, which calls go to a kernel; models/layers.py asks
them and nothing else. The block kernel takes bf16 with C, the head width
and the hidden size multiples of 16 (the tensor cores' tiles);
`fused_ln_mlp` takes bf16 and, at C <= 384, f32, with C and the hidden
size multiples of 16. Blocks the block kernel does not take run their
halves, `fused_ln_attn` (f32 and bf16) and the MLP tail: an f32 block at
the tracker's width is then seven hand-written kernels. What no kernel
takes runs the plain version. The wrappers raise for what their kernels
do not take.

Kernels on the card: `fused_ln_mlp` in bf16 at 384 < C <= 768 (the
camera's cross-attention tails) runs the wide path, three kernels meeting
in bf16 scratch the wrapper allocates: the LayerNorm pass (xn, R x C),
then two tensor-core GEMMs with fused epilogues, h = gelu(xn w1^T + b1)
(R x M) and out = x + (h w2^T + b2). In bf16 at C <= 384 it is one kernel
over 64-row tiles; in f32 the same three steps as the wide path, with the
attention half's CUDA-core GEMM for the products and f32 scratch.
`fused_ln_attn` is four kernels: the LayerNorm pass (the
normalized rows and their f32 statistics), the q|k|v GEMM, the attention
core per (row tile, head), and the out-projection GEMM with the normalized
residual, spread over the card's SMs by the GEMM tile (csrc/fused_former.cuh).

Numerics (as the TPU kernels): LN without affine, eps 1e-6, statistics in
f32; every matrix product accumulates in f32; the normalized input, q/k/v,
the softmax probabilities, each head's output and the GELU output are
rounded to the working dtype; softmax and the block's x1 stay f32; the
attention residual base is the NORMALIZED input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# launch_counts, reset_launch_counts: also read through this module
from vggsfm_tpu_torch.ops import _build, launch_counts, reset_launch_counts  # noqa: F401

# mirrors the kernels' limits (csrc/fused_former.cuh check_*_shape)
MAX_C = 384          # whole-block kernel and ln_mlp's 64-row tile
MAX_WIDE_C = 768     # ln_mlp (the wide path above 384) and ln_attn
MAX_L = 64
MAX_HEAD_DIM = 64    # whole-block kernel
MAX_ATTN_HEAD_DIM = 128

# kernels one fused_ln_attn call launches: LayerNorm, q|k|v projection,
# attention core, out-projection
ATTN_KERNELS = 4
# kernels one fused_ln_mlp call launches in f32 and on the wide path:
# LayerNorm, fc1 + GELU, fc2 + residual
WIDE_MLP_KERNELS = 3

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_route_takes(dtype, C: int, seq_len: int, num_heads: int,
                      M: int) -> bool:
    """Whether a pre-LN block (width C, hidden size M, `num_heads` heads,
    attention within groups of `seq_len` rows) in `dtype` goes to the
    whole-block kernel; else AttnBlock runs its two halves."""
    D = C // num_heads
    return (dtype == torch.bfloat16 and 16 <= C <= MAX_C and C % 16 == 0
            and 1 <= seq_len <= MAX_L and C % num_heads == 0
            and D <= MAX_HEAD_DIM and D % 16 == 0 and M % 16 == 0)


def mlp_route_takes(dtype, C: int, M: int) -> bool:
    """Whether a pre-LN MLP tail of width C and hidden size M in `dtype`
    goes to the fused_ln_mlp kernels (in bf16 above C = 384 the wide
    path). f32 rows wider than 384 (the camera's 768-wide f32 trunk and
    self-attention tails) stay plain, as the JAX package keeps them."""
    widest = MAX_WIDE_C if dtype == torch.bfloat16 else MAX_C
    return (dtype in (torch.bfloat16, torch.float32) and 16 <= C <= widest
            and C % 16 == 0 and M % 16 == 0)


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


# ----------------------------------------------------------------- FLOPs
# Each kernel's FLOPs by one formula: what FlopCounterMode counts of the
# plain version, its matrix products (2 FLOPs a multiply-add).
# benchmark/tests/test_bench_work.py holds the benchmark's own copies
# (benchmark/harness/work.py) to them.

def ln_mlp_flops(R: int, C: int, M: int) -> int:
    """fc1 (R x C x M) and fc2 (R x M x C)."""
    return 4 * R * C * M


def ln_attn_flops(R: int, C: int, L: int) -> int:
    """q|k|v (R x C x 3C), scores and weighted sum (R x L x C each, in
    groups of L rows), out-projection (R x C x C)."""
    return 8 * R * C * C + 4 * R * L * C


def block_flops(R: int, C: int, M: int, L: int) -> int:
    """The attention half and the MLP tail."""
    return ln_attn_flops(R, C, L) + ln_mlp_flops(R, C, M)


# --------------------------------------------------------------- wrappers

def _check(x, params, shapes):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused former kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, t in params.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{x.dtype} on {x.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return int(torch.cuda.current_stream().cuda_stream)


def fused_ln_mlp(x, w1, b1, w2, b2):
    """x + fc2(gelu(fc1(LN(x)))), LN eps 1e-6 without affine.

    x (R, C) float32 or bfloat16; w1 (M, C), b1 (M,), w2 (C, M), b2 (C,)
    of the same dtype. CPU tensors take `fused_ln_mlp_ref`; CUDA tensors
    launch the kernels (WIDE_MLP_KERNELS in f32 and in bf16 above C = 384,
    else one) where `mlp_route_takes` them, else raise. Returns (R, C) in
    x's dtype.
    """
    R, C = x.shape
    M = w1.shape[0]
    if x.device.type == "cpu":
        return fused_ln_mlp_ref(x, w1, b1, w2, b2)
    _check(x, {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2},
           {"x": (R, C), "w1": (M, C), "b1": (M,), "w2": (C, M),
            "b2": (C,)})
    if not mlp_route_takes(x.dtype, C, M):
        raise ValueError(f"fused_ln_mlp kernels take bfloat16 with 16 <= C "
                         f"<= {MAX_WIDE_C} or float32 with C <= {MAX_C}, "
                         f"and C, M multiples of 16; got {x.dtype}, C={C}, "
                         f"M={M}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _build.load_library()
    # the three-kernel path's scratch (the normalized rows and the GELU
    # output)
    nbytes = lib.vf_ln_mlp_scratch_bytes(_DTYPES[x.dtype], R, C, M)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
        if nbytes else None
    with torch.cuda.device(x.device):
        rc = lib.vf_fused_ln_mlp(
            _DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), R, C, M,
            _stream())
    if rc != 0:
        raise RuntimeError(f"fused_ln_mlp kernel launch failed: code {rc}")
    launch_counts["fused_ln_mlp"] += lib.vf_ln_mlp_kernels(_DTYPES[x.dtype],
                                                          C)
    return out


def fused_transformer_block(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2,
                            seq_len: int, num_heads: int):
    """One whole pre-LN transformer block on x (R, C), attention within
    each group of `seq_len` consecutive rows.

    w_in (3C, C), b_in (3C,) packed q|k|v; w_out (C, C), b_out (C,);
    w1 (M, C), b1 (M,), w2 (C, M), b2 (C,). CPU tensors take
    `fused_transformer_block_ref`; CUDA tensors launch the kernel where
    `block_route_takes` them, else raise.
    """
    R, C = x.shape
    M = w1.shape[0]
    if x.device.type == "cpu":
        return fused_transformer_block_ref(x, w_in, b_in, w_out, b_out, w1,
                                           b1, w2, b2, seq_len, num_heads)
    _check(x, {"x": x, "w_in": w_in, "b_in": b_in, "w_out": w_out,
               "b_out": b_out, "w1": w1, "b1": b1, "w2": w2, "b2": b2},
           {"x": (R, C), "w_in": (3 * C, C), "b_in": (3 * C,),
            "w_out": (C, C), "b_out": (C,), "w1": (M, C), "b1": (M,),
            "w2": (C, M), "b2": (C,)})
    if not block_route_takes(x.dtype, C, seq_len, num_heads, M) \
            or R % seq_len:
        raise ValueError(
            f"fused_transformer_block kernel takes bfloat16 with 16 <= C <= "
            f"{MAX_C}, 1 <= L <= {MAX_L}, head dim <= {MAX_HEAD_DIM}, C, "
            f"the head dim and M multiples of 16, and R % L == 0; got "
            f"{x.dtype}, R={R}, C={C}, M={M}, L={seq_len}, H={num_heads}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.vf_fused_block(
            _DTYPES[x.dtype], x.data_ptr(), w_in.data_ptr(),
            b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), R, C, M, seq_len, num_heads, _stream())
    if rc != 0:
        raise RuntimeError(
            f"fused_transformer_block kernel launch failed: code {rc}")
    launch_counts["fused_transformer_block"] += 1
    return out


def fused_ln_attn(x, w_in, b_in, w_out, b_out, seq_len: int, num_heads: int):
    """LN(x) + out_proj(attention(LN(x))) on x (R, C), attention within
    each group of `seq_len` consecutive rows; LN eps 1e-6 without affine,
    the residual base the normalized input.

    w_in (3C, C), b_in (3C,) packed q|k|v; w_out (C, C), b_out (C,), of
    x's dtype. CPU tensors take `fused_ln_attn_ref`; CUDA tensors launch
    the op's ATTN_KERNELS kernels (LayerNorm, q|k|v projection, attention
    core, out-projection; csrc/fused_former.cuh) or raise. Returns (R, C)
    in x's dtype.
    """
    R, C = x.shape
    if x.device.type == "cpu":
        return fused_ln_attn_ref(x, w_in, b_in, w_out, b_out, seq_len,
                                 num_heads)
    _check(x, {"x": x, "w_in": w_in, "b_in": b_in, "w_out": w_out,
               "b_out": b_out},
           {"x": (R, C), "w_in": (3 * C, C), "b_in": (3 * C,),
            "w_out": (C, C), "b_out": (C,)})
    if not ln_attn_takes(C, seq_len, num_heads) or R % seq_len:
        raise ValueError(
            f"fused_ln_attn kernel takes 16 <= C <= {MAX_WIDE_C} "
            f"(C % 16 == 0), 1 <= L <= {MAX_L}, head dim <= "
            f"{MAX_ATTN_HEAD_DIM} and R % L == 0; got R={R}, C={C}, "
            f"L={seq_len}, H={num_heads}")
    out = torch.empty_like(x)
    if R == 0:
        return out
    lib = _build.load_library()
    # scratch: the normalized rows, q|k|v, the head outputs, the rows'
    # LayerNorm statistics
    scratch = torch.empty(lib.vf_attn_scratch_bytes(_DTYPES[x.dtype], R, C),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.vf_fused_ln_attn(
            _DTYPES[x.dtype], x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), R, C, seq_len, num_heads,
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            _stream())
    if rc != 0:
        raise RuntimeError(f"fused_ln_attn kernel launch failed: code {rc}")
    launch_counts["fused_ln_attn"] += ATTN_KERNELS
    return out
