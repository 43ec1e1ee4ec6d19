"""Monocular depth: the DPT decoder over the DINOv2 backbone (PyTorch).
Counterpart of vggsfm_tpu/models/dpt.py, the DepthAnythingV2 architecture
of the reference's optional dense-depth path (vggsfm/runners/runner.py:
141-162): per tapped ViT block a 1x1 projection, a resize layer
(transposed conv x4 / x2, identity, stride-2 conv) and a bias-free 3x3
``layer_rn`` conv; then coarse-to-fine fusion through residual conv units;
then the two-stage output head. Relative disparity, >= 0.

Attribute names are the public DepthAnythingV2 state_dict's
(``pretrained.*``, ``depth_head.projects.{i}``,
``depth_head.resize_layers.{0,1,3}``, ``depth_head.scratch.layer{1-4}_rn``,
``scratch.refinenet{1-4}.{resConfUnit1,resConfUnit2,out_conv}``,
``scratch.output_conv1``, ``scratch.output_conv2.{0,2}``), so a
``depth_anything_v2_vit{b,l}.pth`` loads with ``load_state_dict(strict=
True)``. ``refinenet4.resConfUnit1`` exists in the checkpoint and is never
used (the coarsest fusion has no skip input), as ``mask_token`` is kept.

The dtype flow is the JAX module's: every conv and resize runs in
``dtype`` (bf16 on the main path), the output is relu of its f32 cast; the
resizes' f32 products never run in TF32.
Layout is NCHW inside, (B, H, W, 3) images in, (B, H, W) out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.models.camera import (
    _RESNET_MEAN,
    _RESNET_STD,
    seeded_init_,
)
from vggsfm_tpu_torch.models.dinov2 import DinoVisionTransformer
from vggsfm_tpu_torch.models.layers import cast_weight
from vggsfm_tpu_torch.models.sampling import interpolate_bilinear_nchw
from vggsfm_tpu_torch.utils.precision import f32_matmuls


def resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear (align_corners=True) resize of (B, C, H, W) in its dtype;
    f32 products stay f32 (no TF32)."""
    with f32_matmuls():
        return interpolate_bilinear_nchw(x, out_hw)


def conv(x: torch.Tensor, layer: nn.Module, dtype) -> torch.Tensor:
    """`layer` (Conv2d or ConvTranspose2d) applied in `dtype`, input and
    weights cast, as flax Conv / ConvTranspose with ``dtype``."""
    w = cast_weight(layer.weight, dtype)
    b = None if layer.bias is None else cast_weight(layer.bias, dtype)
    x = x.to(dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, stride=layer.stride)
    return F.conv2d(x, w, b, stride=layer.stride, padding=layer.padding)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = conv(F.relu(x), self.conv1, self.dtype)
        y = conv(F.relu(y), self.conv2, self.dtype)
        return x + y


class FeatureFusionBlock(nn.Module):
    """DPT refinenet (deconv=False, align_corners=True): the skip through
    resConfUnit1 added, resConfUnit2, bilinear resize (x2 unless `out_hw`
    is given), 1x1 out_conv."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        H, W = x.shape[-2:]
        x = resize(x, out_hw or (2 * H, 2 * W))
        return conv(x, self.out_conv, self.dtype)


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels, dtype):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features,
                                                              dtype))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(True),
            nn.Conv2d(32, 1, 1), nn.ReLU(True), nn.Identity())


class DPTHead(nn.Module):
    """Four tapped ViT layers -> disparity map at `out_hw`
    (DepthAnythingV2's DPTHead, use_clstoken=False)."""

    def __init__(self, in_channels: int, features: int = 128,
                 out_channels=(96, 192, 384, 768), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = out_channels
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, o, 1)
                                      for o in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(features, c, dtype)

    def forward(self, taps, grid_hw, out_hw):
        gh, gw = grid_hw
        dt, sc = self.dtype, self.scratch
        feats = []
        for i, t in enumerate(taps):
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
            x = conv(x, self.projects[i], dt)
            if i != 2:
                x = conv(x, self.resize_layers[i], dt)
            feats.append(conv(x, getattr(sc, f"layer{i + 1}_rn"), dt))
        # fuse coarse -> fine, each step on the next level's grid
        x = sc.refinenet4(feats[3], out_hw=feats[2].shape[-2:])
        x = sc.refinenet3(x, feats[2], out_hw=feats[1].shape[-2:])
        x = sc.refinenet2(x, feats[1], out_hw=feats[0].shape[-2:])
        x = sc.refinenet1(x, feats[0])
        x = conv(x, sc.output_conv1, dt)
        x = resize(x, out_hw)
        x = F.relu(conv(x, sc.output_conv2[0], dt))
        x = conv(x, sc.output_conv2[2], dt)
        return F.relu(x.float())[:, 0]  # disparity >= 0


class DepthAnything(nn.Module):
    """DINOv2 + DPT: (B, H, W, 3) in [0, 1] -> relative disparity
    (B, H, W), f32. The defaults are the JAX module's ViT-B taps;
    `DepthAnything.vitl()` is the public DepthAnythingV2-Large
    configuration (24 blocks, 1024 wide, 16 heads, no registers)."""

    def __init__(self, tap_layers=(2, 5, 8, 11), features: int = 128,
                 out_channels=(96, 192, 384, 768), embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 num_register_tokens: int = 4, dtype=torch.float32):
        super().__init__()
        self.tap_layers, self.dtype = tuple(tap_layers), dtype
        self.pretrained = DinoVisionTransformer(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            num_register_tokens=num_register_tokens, dtype=dtype)
        self.depth_head = DPTHead(embed_dim, features, out_channels, dtype)

    @classmethod
    def vitl(cls, dtype=torch.float32, num_register_tokens: int = 0):
        return cls(tap_layers=(4, 11, 17, 23), features=256,
                   out_channels=(256, 512, 1024, 1024), embed_dim=1024,
                   depth=24, num_heads=16,
                   num_register_tokens=num_register_tokens, dtype=dtype)

    def forward(self, images):
        B, H, W, _ = images.shape
        ph, pw = (-H) % 14, (-W) % 14
        x = images.float().permute(0, 3, 1, 2)
        if ph or pw:  # edge padding to patch multiples
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        x = x.permute(0, 2, 3, 1)
        x = (x - x.new_tensor(_RESNET_MEAN)) / x.new_tensor(_RESNET_STD)
        _, taps = self.pretrained(x, return_layers=self.tap_layers)
        disp = self.depth_head(taps, ((H + ph) // 14, (W + pw) // 14),
                               (H + ph, W + pw))
        return disp[:, :H, :W]


def init_depth_anything_(model: DepthAnything, generator: torch.Generator):
    """The seeded init of the JAX package's `DepthAnything` (flax
    defaults; `seeded_init_`)."""
    return seeded_init_(model, generator)
