"""Shared NN building blocks (PyTorch). Counterpart of
vggsfm_tpu/models/layers.py.

Conventions kept from the reference (vggsfm/models/modules.py):
  * AttnBlock/CrossAttnBlock use the *normalized* input as the residual
    base (the reference applies norm1 in place before the residual add);
  * attention norms have no affine parameters and eps 1e-6;
    CrossAttnBlock's norm_context has an affine and eps 1e-5;
  * the attention is torch-`nn.MultiheadAttention`-shaped (packed
    ``in_proj_weight``/``in_proj_bias`` + ``out_proj``), so the module's
    state_dict keys are the reference checkpoint's.

Parameters are stored in float32. Each module rounds its weights to its
``dtype`` at use and computes in the promotion of that dtype and its
input's, as jnp does for the JAX modules: bf16 tokens stay bf16 (the
tracker), while f32 tokens meet bf16-rounded weights in f32 (the camera
former's self-attention and trunk blocks). Every such cast goes through
`cast_weight`, which counts the bytes it writes while the tracer records
(``weights.cast_bytes``, utils/trace.py).

Which blocks and tails run on the fused former kernels is decided by the
predicates of ops/fused_mlp.py alone (`block_route_takes`,
`mlp_route_takes`, `ln_attn_takes`), from the compute dtype and the
shapes; everything else runs the same function plain.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.ops.fused_mlp import (
    block_route_takes,
    fused_ln_attn,
    fused_ln_mlp,
    fused_ln_mlp_ref,
    fused_transformer_block,
    ln_attn_takes,
    mlp_route_takes,
)
from vggsfm_tpu_torch.utils import trace


def _ln_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, f32 statistics, output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _softmax_over_group(scores, v, group):
    """softmax(scores) @ v over a key axis split across `group`'s ranks:
    scores (B, H, Lq, Lk_local) f32, v (B, Lk_local, H, D) -> (B, Lq, H, D)
    f32, the same on every rank."""
    m = group.all_reduce(scores.amax(-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    num = torch.einsum("bhqk,bkhd->bqhd", e, v.float())
    B, H, Lq, _ = e.shape
    # one collective for both sums: Σexp rides as a last column of Σexp·v
    both = torch.cat([num, e.sum(-1).permute(0, 2, 1)[..., None]], dim=-1)
    both = group.all_reduce(both.contiguous(), "sum")
    return both[..., :-1] / both[..., -1:]


def cast_weight(p: torch.Tensor, dtype) -> torch.Tensor:
    """A weight `p` cast to `dtype` at its use; while the tracer records,
    the bytes the cast writes (none where `p` is in `dtype` already) are
    added to the counter ``weights.cast_bytes``."""
    if trace.ON and p.dtype != dtype:
        trace.count("weights.cast_bytes", p.numel() * dtype.itemsize)
    return p.to(dtype)


class TorchMultiheadAttention(nn.Module):
    """Multi-head attention in torch.nn.MultiheadAttention's parameter
    layout; inputs (B, L, C), batch first. Softmax in f32."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def packed(self, cdt=None):
        """(w_in, b_in, w_out, b_out) rounded to the module dtype, in the
        compute dtype `cdt` (default: the module dtype)."""
        dt, cdt = self.dtype, cdt or self.dtype
        return tuple(cast_weight(cast_weight(p, dt), cdt) for p in (
            self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
            self.out_proj.bias))

    def forward(self, q, k, v, group=None):
        """Attention of q (B, Lq, C) over k, v (B, Lk, C). With `group` (a
        mesh `Axis`), k and v are this rank's block of a context split
        over the group's ranks: the softmax over the whole context is
        combined across them in f32 (all-reduce MAX of each query's top
        score, then one all-reduce SUM of Σexp and Σexp·v), so every rank
        gets the same output."""
        C, H = self.dim, self.num_heads
        D = C // H
        cdt = torch.promote_types(q.dtype, self.dtype)
        w, b, wo, bo = self.packed(cdt)
        q, k, v = q.to(cdt), k.to(cdt), v.to(cdt)
        if q is k and k is v:
            xq, xk, xv = F.linear(q, w, b).chunk(3, dim=-1)
        else:
            # only the projections each input needs
            xq = F.linear(q, w[:C], b[:C])
            xk = F.linear(k, w[C:2 * C], b[C:2 * C])
            xv = F.linear(v, w[2 * C:], b[2 * C:])
        B, Lq, _ = xq.shape
        xq = xq.reshape(B, Lq, H, D)
        xk = xk.reshape(B, xk.shape[1], H, D)
        xv = xv.reshape(B, xv.shape[1], H, D)
        attn = torch.einsum("bqhd,bkhd->bhqk", xq, xk).float()
        if group is not None:
            out = _softmax_over_group(attn / D ** 0.5, xv, group)
            return F.linear(out.to(cdt).reshape(B, Lq, C), wo, bo)
        attn = torch.softmax(attn / D ** 0.5, dim=-1).to(xv.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, xv).reshape(B, Lq, C)
        return F.linear(out, wo, bo)

    def ln_self_attention(self, x):
        """The pre-LN attention half LN(x) + attn(LN(x)) on x (B, L, C):
        the fused_ln_attn kernel for groups it takes (L <= 64), else
        plain."""
        B, L, C = x.shape
        x = x.to(torch.promote_types(x.dtype, self.dtype))
        if ln_attn_takes(C, L, self.num_heads):
            out = fused_ln_attn(x.reshape(B * L, C).contiguous(),
                                *self.packed(x.dtype), L, self.num_heads)
            return out.reshape(B, L, C)
        xn = _ln_noaffine(x)
        return xn + self(xn, xn, xn)


class Mlp(nn.Module):
    """Linear -> GELU (erf) -> Linear, timm-style."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def packed(self, cdt=None):
        """(w1, b1, w2, b2) rounded to the module dtype, in the compute
        dtype `cdt` (default: the module dtype)."""
        dt, cdt = self.dtype, cdt or self.dtype
        return tuple(cast_weight(cast_weight(p, dt), cdt) for p in (
            self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias))

    def forward(self, x, ln_residual: bool = False):
        """Plain MLP — or, with ``ln_residual``, the transformer tail
        ``x + fc2(gelu(fc1(LN(x))))``: the fused_ln_mlp kernel where
        `mlp_route_takes` the dtype and shape, else the same function
        plain."""
        x = x.to(torch.promote_types(x.dtype, self.dtype))
        w1, b1, w2, b2 = self.packed(x.dtype)
        if not ln_residual:
            return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)
        lead, C = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, C).contiguous()
        tail = fused_ln_mlp if mlp_route_takes(x.dtype, C, w1.shape[0]) \
            else fused_ln_mlp_ref
        return tail(x2, w1, b1, w2, b2).reshape(*lead, w2.shape[0])


class AttnBlock(nn.Module):
    """Pre-LN self-attention + MLP on (B, L, C)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn = TorchMultiheadAttention(hidden_size, num_heads, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, dtype)

    def forward(self, x):
        B, L, C = x.shape
        x = x.to(torch.promote_types(x.dtype, self.dtype))
        if block_route_takes(x.dtype, C, L, self.attn.num_heads,
                             self.mlp.fc1.out_features):
            # the whole block as one fused_transformer_block kernel
            out = fused_transformer_block(
                x.reshape(B * L, C).contiguous(), *self.attn.packed(x.dtype),
                *self.mlp.packed(x.dtype), L, self.attn.num_heads)
            return out.reshape(B, L, C)
        # what the block kernel does not take: the two halves, each
        # through its own kernel where that takes it
        return self.mlp(self.attn.ln_self_attention(x), ln_residual=True)


class CrossAttnBlock(nn.Module):
    """x attends to context; the MLP tail runs fused_ln_mlp."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm_context = nn.LayerNorm(hidden_size, eps=1e-5)
        self.cross_attn = TorchMultiheadAttention(hidden_size, num_heads,
                                                  dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       hidden_size, dtype)

    def forward(self, x, context, group=None):
        """x attends to `context`; with `group`, the context is this rank's
        block of one split over the group (TorchMultiheadAttention)."""
        # LN in f32 of x as it comes, rounded once to the module dtype (as
        # flax's LayerNorm(dtype=...)): the camera's f32 tokens turn bf16
        x = _ln_noaffine(x).to(self.dtype)
        context = F.layer_norm(context.float(), (context.shape[-1],),
                               self.norm_context.weight,
                               self.norm_context.bias,
                               1e-5).to(self.dtype)
        x = x + self.cross_attn(x, context, context, group=group)
        return self.mlp(x, ln_residual=True)


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  spatial_dims=(-3, -2)) -> torch.Tensor:
    """Parameterless InstanceNorm with f32 statistics; NHWC by default
    (``spatial_dims=(-2, -1)`` for NCHW)."""
    x32 = x.float()
    mean = x32.mean(spatial_dims, keepdim=True)
    var = (x32 - mean).square().mean(spatial_dims, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _in_nchw(x):
    return instance_norm(x, spatial_dims=(-2, -1))


class ResidualBlock(nn.Module):
    """Two 3x3 convs with residual + strided 1x1 downsample; NCHW inside
    the encoders (the reference's norm_fn='instance', parameterless)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1,
                                                   stride))
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(_in_nchw(conv(self.conv1, x, self.dtype)))
        y = F.relu(_in_nchw(conv(self.conv2, y, self.dtype)))
        if self.downsample is not None:
            x = _in_nchw(conv(self.downsample[0], x, self.dtype))
        return F.relu(x + y)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """`layer` applied in `dtype` (weights cast at use)."""
    return F.conv2d(x.to(dtype), cast_weight(layer.weight, dtype),
                    cast_weight(layer.bias, dtype), layer.stride,
                    layer.padding)


def group_norm_1(x, scale, bias, eps: float = 1e-5):
    """GroupNorm(num_groups=1) over the last (channel) axis, affine."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias
