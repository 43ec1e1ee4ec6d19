"""DINOv2 ViT backbone with register tokens (PyTorch). Counterpart of
vggsfm_tpu/models/dinov2.py, the frozen 'dinov2_vitb14_reg' backbone of the
reference's camera predictor (vggsfm/models/camera_predictor.py:223-236):
patch-14 ViT, class token + 4 register tokens, LayerScale per block, final
LayerNorm; `forward` returns the normalized patch tokens, and with
`return_layers` also the tapped blocks' (the DPT depth head's input).

Parameter names are the torch.hub model's (``patch_embed.proj``, ``blocks.N
.attn.qkv``, ``ls1.gamma``, ``mask_token``, ...), so the reference
checkpoint's ``camera_predictor.backbone.*`` entries load as they are.
``mask_token`` (masked-image pretraining) is kept and never used. With no
register tokens there is no ``register_tokens`` entry, as in the public
DepthAnythingV2 encoders (``pretrained.*``).

The dtype flow is the JAX module's: everything runs in ``dtype`` (bf16 on
the main path) with f32 LayerNorm statistics and softmax; the LayerScale
products are f32 and rounded to the token dtype before each residual add.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.models.sampling import interpolate_bilinear


def linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """`layer` applied in `dtype` (input and weights cast, as flax Dense)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    """Affine LayerNorm with f32 statistics, rounded once to `dtype`."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


class DinoAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, L, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = linear(x, self.qkv, self.dtype)
        q, k, v = qkv.reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-1, -2)).float()
        attn = torch.softmax(logits / D ** 0.5, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, L, C)
        return linear(out, self.proj, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class DinoMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class DinoBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = DinoMlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        dt = self.dtype
        a = self.attn(layer_norm(x, self.norm1, dt))
        x = x + (self.ls1.gamma * a).to(x.dtype)
        h = F.gelu(linear(layer_norm(x, self.norm2, dt), self.mlp.fc1, dt))
        h = linear(h, self.mlp.fc2, dt)
        return x + (self.ls2.gamma * h).to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class DinoVisionTransformer(nn.Module):
    """ViT-B/14 with registers by default; (B, H, W, 3) resnet-normalized
    images -> (B, (H/14)(W/14), C) normalized patch tokens."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 num_register_tokens: int = 4, pos_embed_size: int = 37,
                 dtype=torch.float32):
        super().__init__()
        self.patch_size, self.pos_embed_size = patch_size, pos_embed_size
        self.num_register_tokens, self.dtype = num_register_tokens, dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.register_tokens = (nn.Parameter(
            torch.zeros(1, num_register_tokens, embed_dim))
            if num_register_tokens else None)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_embed_size ** 2, embed_dim))
        self.blocks = nn.ModuleList(
            DinoBlock(embed_dim, num_heads, dtype=dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, images, return_layers: tuple = ()):
        """With `return_layers` (block indices) also returns those blocks'
        patch tokens with the final LayerNorm applied, DINOv2's
        `get_intermediate_layers(norm=True)`: (tokens, [taps])."""
        B, H, W, _ = images.shape
        ps, n, dt = self.patch_size, self.pos_embed_size, self.dtype
        gh, gw = H // ps, W // ps
        proj = self.patch_embed.proj
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), proj.weight.to(dt),
                     proj.bias.to(dt), stride=ps)
        C = x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C)

        # the pretraining grid's position embedding resized to (gh, gw)
        pos_cls = self.pos_embed[:, :1]
        pos_patch = self.pos_embed[:, 1:].reshape(1, n, n, C)
        if (gh, gw) != (n, n):
            pos_patch = interpolate_bilinear(pos_patch, (gh, gw),
                                             align_corners=False)
        x = x + pos_patch.reshape(1, gh * gw, C).to(dt)
        cls = (self.cls_token + pos_cls).to(dt).expand(B, 1, C)
        if self.register_tokens is not None:
            regs = self.register_tokens.to(dt).expand(
                B, self.num_register_tokens, C)
            x = torch.cat([cls, regs, x], dim=1)
        else:
            x = torch.cat([cls, x], dim=1)
        first = 1 + self.num_register_tokens
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in return_layers:
                taps.append(layer_norm(x, self.norm, dt)[:, first:])
        out = layer_norm(x, self.norm, dt)[:, first:]
        return (out, taps) if return_layers else out
