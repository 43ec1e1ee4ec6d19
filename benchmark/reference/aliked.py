"""ALIKED keypoint detector: score branch + SDDH descriptors (PyTorch).
Counterpart of vggsfm_tpu/extractors/aliked.py (ALIKED-n16, arXiv
2304.03608): a 4-stage conv/residual pyramid at resolutions 1, /2, /8, /32
whose stage outputs are projected to dim/4 channels, upsampled to the input
resolution, concatenated and reduced to a one-channel score map; the SDDH
head samples that fused feature map at deformable offsets around each
keypoint. Public layout channels-last, as in the JAX package.

The state_dict keys are the official checkpoint's (``block1.conv1.weight``,
``block2.bn1.running_var``, ``score_head.0.weight``,
``offset_conv.0.weight`` under ``desc_head.``). BatchNorm runs in inference
form, folded to a per-channel scale and bias.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv
from .sampling import (
    bilinear_sample,
    interpolate_bilinear_nchw,
)


class InferenceBatchNorm(nn.Module):
    """Frozen BatchNorm on (B, C, H, W): y = x * scale + bias with the
    running statistics folded in, computed in float32 (the parameters'
    dtype) whatever the input's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features) - eps)

    def folded(self):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        scale, bias = self.folded()
        return x * scale[:, None, None] + bias[:, None, None]


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.bn1 = InferenceBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = InferenceBatchNorm(features)

    def forward(self, x):
        x = F.selu(self.bn1(conv(self.conv1, x, self.dtype)))
        return F.selu(self.bn2(conv(self.conv2, x, self.dtype)))


class ResBlock(nn.Module):
    """The official ALIKED gives every ResBlock a 1x1-conv downsample,
    also where the channel counts match."""

    def __init__(self, cin: int, features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.bn1 = InferenceBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = InferenceBatchNorm(features)
        self.downsample = nn.Conv2d(cin, features, 1)

    def forward(self, x):
        y = F.selu(self.bn1(conv(self.conv1, x, self.dtype)))
        y = self.bn2(conv(self.conv2, y, self.dtype))
        return F.selu(conv(self.downsample, x, self.dtype) + y)


class SDDH(nn.Module):
    """Sparse Deformable Descriptor Head. Per keypoint: a k x k feature
    patch predicts `n_pos` 2D sample offsets (a k x k VALID conv, SELU, a
    1x1 conv); features sampled bilinearly at keypoint + offset are
    projected (sf_conv), concatenated position-major and reduced by convM
    to a `dim`-d L2-normalized descriptor."""

    def __init__(self, dim: int = 128, kernel_size: int = 3, n_pos: int = 8,
                 in_dim: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = dim if in_dim is None else in_dim
        self.dim, self.kernel_size, self.n_pos = dim, kernel_size, n_pos
        self.dtype = dtype
        self.offset_conv = nn.Sequential(
            nn.Conv2d(C, 2 * n_pos, kernel_size), nn.SELU(),
            nn.Conv2d(2 * n_pos, 2 * n_pos, 1))
        self.sf_conv = nn.Conv2d(C, C, 1, bias=False)
        self.convM = nn.Conv2d(C * n_pos, dim, 1, bias=False)

    def forward(self, fmap, keypoints):
        """fmap (B, H, W, C), keypoints (B, N, 2) xy pixel coords ->
        descriptors (B, N, dim) float32, offsets (B, N, n_pos, 2)."""
        B, H, W, C = fmap.shape
        N = keypoints.shape[1]
        k, P, dt = self.kernel_size, self.n_pos, self.dtype

        # 1. k x k patches centred on the rounded keypoint (half to even,
        # as jnp.round), clamped at the border
        ctr = torch.round(keypoints).long()
        offs = torch.arange(-(k // 2), k // 2 + 1, device=fmap.device)
        px = (ctr[..., 0, None, None] + offs[None, :]).clamp(0, W - 1)
        py = (ctr[..., 1, None, None] + offs[:, None]).clamp(0, H - 1)
        idx = (py * W + px).reshape(B, N * k * k, 1).expand(-1, -1, C)
        patches = torch.gather(fmap.reshape(B, H * W, C), 1, idx)
        patches = patches.reshape(B * N, k, k, C).permute(0, 3, 1, 2)

        # 2. offsets, clamped to the official max_offset = max(H, W) / 4
        off = F.selu(conv(self.offset_conv[0], patches, dt))
        off = conv(self.offset_conv[2], off, dt)
        max_off = max(H, W) / 4.0
        offsets = off.reshape(B, N, P, 2).clamp(-max_off, max_off)

        # 3. deformable sampling at keypoint + offset
        sampled = bilinear_sample(fmap, keypoints[:, :, None, :] + offsets)

        # 4. project, concatenate over positions, reduce, normalize
        h = F.selu(F.linear(sampled.to(dt),
                            self.sf_conv.weight[:, :, 0, 0].to(dt)))
        desc = F.linear(h.reshape(B, N, P * C),
                        self.convM.weight[:, :, 0, 0].to(dt)).float()
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return desc, offsets


class ALIKED(nn.Module):
    """ALIKED-n16 encoder + score head: (B, H, W, 3) -> (B, H, W) scores.
    Weights stay float32; `dtype` is the compute dtype of the convolutions
    (the folded BatchNorms and the SELUs after them run in float32, as
    jnp's promotion gives in the JAX module)."""

    def __init__(self, c1: int = 16, c2: int = 32, c3: int = 64,
                 c4: int = 128, dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block1 = ConvBlock(3, c1, dtype)
        self.block2 = ResBlock(c1, c2, dtype)
        self.block3 = ResBlock(c2, c3, dtype)
        self.block4 = ResBlock(c3, c4, dtype)
        d = dim // 4
        self.conv1 = nn.Conv2d(c1, d, 1)
        self.conv2 = nn.Conv2d(c2, d, 1)
        self.conv3 = nn.Conv2d(c3, d, 1)
        self.conv4 = nn.Conv2d(c4, d, 1)
        self.score_head = nn.Sequential(
            nn.Conv2d(dim, 8, 1), nn.SELU(),
            nn.Conv2d(8, 4, 3, padding=1), nn.SELU(),
            nn.Conv2d(4, 4, 3, padding=1), nn.SELU(),
            nn.Conv2d(4, 1, 3, padding=1))

    def forward(self, image, return_feats: bool = False):
        """(B, H, W, 3) in [0, 1] -> score map (B, H, W) in [0, 1], float32;
        with `return_feats` also the (B, H, W, dim) fused feature map the
        SDDH head samples."""
        dt = self.dtype
        H, W = image.shape[1:3]
        x1 = self.block1(image.permute(0, 3, 1, 2))
        x2 = self.block2(F.avg_pool2d(x1, 2, 2))
        x3 = self.block3(F.avg_pool2d(x2, 4, 4))
        x4 = self.block4(F.avg_pool2d(x3, 4, 4))

        f1, f2, f3, f4 = (F.selu(conv(c, x, dt)) for c, x in (
            (self.conv1, x1), (self.conv2, x2), (self.conv3, x3),
            (self.conv4, x4)))
        feats = torch.cat(
            [f1] + [interpolate_bilinear_nchw(f, (H, W))
                    for f in (f2, f3, f4)], dim=1)

        s = feats
        for layer in self.score_head:
            s = conv(layer, s, dt) if isinstance(layer, nn.Conv2d) \
                else F.selu(s)
        score = torch.sigmoid(s.float())[:, 0]
        if return_feats:
            return score, feats.permute(0, 2, 3, 1)
        return score
