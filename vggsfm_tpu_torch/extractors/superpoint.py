"""SuperPoint keypoint detector (PyTorch). Counterpart of
vggsfm_tpu/extractors/superpoint.py: the MagicLeap architecture (a shared
VGG-style encoder, a detector head giving a 65-way distribution per 8x8
cell, a descriptor head), public layout channels-last as in the JAX
package. The state_dict keys are the public ``superpoint_v1.pth`` names
(conv1a..conv4b, convPa/convPb, convDa/convDb).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.extractors.corners import (
    neighborhood_max,
    peaks_to_keypoints,
)
from vggsfm_tpu_torch.extractors.dog import border_mask
from vggsfm_tpu_torch.models.layers import conv


class SuperPoint(nn.Module):
    """Weights stay float32; `dtype` is the compute dtype of the
    convolutions. The softmax and the descriptor norm run in float32."""

    def __init__(self, descriptor_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = [1, 64, 64, 64, 64, 128, 128, 128, 128]
        self.names = ["conv1a", "conv1b", "conv2a", "conv2b",
                      "conv3a", "conv3b", "conv4a", "conv4b"]
        for name, cin, cout in zip(self.names, chans[:-1], chans[1:]):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)

    def forward(self, image):
        """(B, H, W, 1) grayscale in [0, 1] -> (scores (B, H, W),
        descriptors (B, H/8, W/8, D)), both float32."""
        dt = self.dtype
        x = image.permute(0, 3, 1, 2)
        for name in self.names:
            x = F.relu(conv(getattr(self, name), x, dt))
            if name in ("conv1b", "conv2b", "conv3b"):
                x = F.max_pool2d(x, 2, 2)

        # detector head: softmax in f32, drop the dustbin, un-shuffle the
        # 8x8 cells
        d = conv(self.convPb, F.relu(conv(self.convPa, x, dt)), dt)
        prob = torch.softmax(d.float().permute(0, 2, 3, 1), dim=-1)[..., :64]
        B, hc, wc, _ = prob.shape
        heat = prob.reshape(B, hc, wc, 8, 8).permute(0, 1, 3, 2, 4)
        heat = heat.reshape(B, hc * 8, wc * 8)

        desc = conv(self.convDb, F.relu(conv(self.convDa, x, dt)), dt)
        desc = desc.float().permute(0, 2, 3, 1)
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return heat, desc


def superpoint_keypoints_from_heatmap(heat: torch.Tensor,
                                      max_keypoints: int = 4096,
                                      nms_radius: int = 4, border: int = 4):
    """(..., H, W) detector heat maps -> (xy (..., K, 2), score (..., K),
    valid (..., K)): the strict local maxima inside the border, strongest
    first."""
    H, W = heat.shape[-2:]
    peak = heat > neighborhood_max(heat, nms_radius)
    peak &= border_mask(H, W, border, heat.device)
    return peaks_to_keypoints(
        torch.where(peak, heat, torch.zeros_like(heat)), max_keypoints)
