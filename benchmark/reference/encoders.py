"""CNN feature encoders for the tracker. Counterpart of
vggsfm_tpu/models/encoders.py (reference track_modules/blocks.py:25-183).

Public layout is NHWC as in the JAX package; the convolutions run NCHW
inside. The padding is symmetric and explicit (Flax ``padding=k``), so
stride-2 layers give the same output sizes as the JAX modules.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ResidualBlock, _in_nchw, conv
from .sampling import (
    _interp_matrix,
    interpolate_bilinear_nchw,
)


class BasicEncoder(nn.Module):
    """(B, H, W, 3) -> (B, H/stride, W/stride, output_dim)."""

    def __init__(self, output_dim: int = 128, stride: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        d = output_dim
        self.conv1 = nn.Conv2d(3, d // 2, 7, 2, padding=3)

        def layer(cin, cout, s):
            return nn.Sequential(ResidualBlock(cin, cout, s, dtype),
                                 ResidualBlock(cout, cout, 1, dtype))

        self.layer1 = layer(d // 2, d // 2, 1)
        self.layer2 = layer(d // 2, d // 4 * 3, 2)
        self.layer3 = layer(d // 4 * 3, d, 2)
        self.layer4 = layer(d, d, 2)
        self.conv2 = nn.Conv2d(d // 2 + d // 4 * 3 + 2 * d, d * 2, 3,
                               padding=1)
        self.conv3 = nn.Conv2d(d * 2, d, 1)

    def forward(self, x):
        _, H, W, _ = x.shape
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = F.relu(_in_nchw(conv(self.conv1, x, dt)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        e = self.layer4(c)
        hw = (H // self.stride, W // self.stride)
        fused = torch.cat([interpolate_bilinear_nchw(t, hw)
                           for t in (a, b, c, e)], dim=1)
        x = F.relu(_in_nchw(conv(self.conv2, fused, dt)))
        return conv(self.conv3, x, dt).permute(0, 2, 3, 1)


class ShallowEncoder(nn.Module):
    """(B, H, W, 3) -> (B, H/stride, W/stride, output_dim), stride 1.

    With ``flat_cfirst`` the output is flat channel-first
    (B, output_dim, H'*W'): the layout the fine correlation pyramid
    consumes (one kron'd interpolation matrix does the final upsample).
    """

    def __init__(self, output_dim: int = 32, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        d = output_dim
        self.conv1 = nn.Conv2d(3, d, 3, 2, padding=1)
        self.layer1 = ResidualBlock(d, d, 2, dtype)
        self.layer2 = ResidualBlock(d, d, 2, dtype)
        self.conv2 = nn.Conv2d(d, d, 1)

    def forward(self, x, flat_cfirst: bool = False):
        _, H, W, _ = x.shape
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = F.relu(_in_nchw(conv(self.conv1, x, dt)))
        hw = tuple(x.shape[-2:])
        tmp = self.layer1(x)
        x = x + interpolate_bilinear_nchw(tmp, hw)
        tmp = self.layer2(tmp)
        x = x + interpolate_bilinear_nchw(tmp, hw)
        x = conv(self.conv2, x, dt) + x
        out_hw = (H // self.stride, W // self.stride)
        if not flat_cfirst:
            return interpolate_bilinear_nchw(x, out_hw).permute(0, 2, 3, 1)
        B, C, h, w = x.shape
        My = _interp_matrix(h, out_hw[0], True, x.dtype, x.device)
        Mx = _interp_matrix(w, out_hw[1], True, x.dtype, x.device)
        M2 = torch.einsum("oh,pw->ophw", My, Mx).reshape(
            out_hw[0] * out_hw[1], h * w)
        return torch.einsum("bcs,os->bco", x.reshape(B, C, h * w), M2)
