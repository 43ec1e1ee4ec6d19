"""Camera pose regressor: DINOv2 features + attention trunk (PyTorch).
Counterpart of vggsfm_tpu/models/camera.py (reference
vggsfm/models/camera_predictor.py:40-303). Outputs the ``absT_quaR_OneFL``
pose encoding (translation, quaternion, one focal in NDC); the decode to
OpenCV cameras is geometry/cameras.py:pose_encoding_to_extri_intri.

The dtype flow is the JAX module's, not "everything in ``dtype``": with
``dtype=bfloat16`` the backbone and the input transform run in bf16, the
sincos position embedding promotes the tokens to f32, the self-attention
and trunk blocks compute on f32 tokens with bf16-rounded weights, each
cross-attention block turns its tokens bf16 (its LayerNorm rounds), the
concatenation promotes them back to f32, and the pose deltas are summed in
f32. The fused kernels follow from that flow and the layers' gates: the
trunk's attention halves (f32, L = S) run fused_ln_attn and the
cross-attention tails (bf16, C = 768) fused_ln_mlp; the self-attention
blocks (L = P + 1 tokens) and the f32 MLP tails stay plain.

Its state_dict keys are the reference checkpoint's ``camera_predictor.*``
keys with the prefix stripped.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.models.dinov2 import DinoVisionTransformer, linear
from vggsfm_tpu_torch.models.embeddings import (
    get_2d_sincos_pos_embed,
    harmonic_embedding,
)
from vggsfm_tpu_torch.models.layers import AttnBlock, CrossAttnBlock, Mlp
from vggsfm_tpu_torch.models.sampling import interpolate_bilinear

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine in x's dtype, as jnp does it: mean and
    variance summed in f32 and rounded to x's dtype, then the arithmetic in
    x's dtype (camera_predictor.py:75-77)."""
    x32 = x.float()
    mean32 = x32.mean(-1, keepdim=True)
    var = (x32 - mean32).square().mean(-1, keepdim=True).to(x.dtype)
    return (x - mean32.to(x.dtype)) * torch.rsqrt(var + 1e-6)


class CameraPredictor(nn.Module):
    def __init__(self, hidden_size: int = 768, num_heads: int = 8,
                 mlp_ratio: float = 4.0, z_dim: int = 768,
                 down_size: int = 336, att_depth: int = 8,
                 trunk_depth: int = 4, target_dim: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size, self.target_dim = hidden_size, target_dim
        self.down_size, self.dtype = down_size, dtype
        self.backbone = DinoVisionTransformer(dtype=dtype)
        self.input_transform = Mlp(self.backbone.norm.normalized_shape[0],
                                   z_dim, hidden_size, dtype)
        self.pose_token = nn.Parameter(torch.zeros(1, 1, 1, hidden_size))
        self.self_att = nn.ModuleList(
            AttnBlock(hidden_size, num_heads, mlp_ratio, dtype)
            for _ in range(att_depth))
        self.cross_att = nn.ModuleList(
            CrossAttnBlock(hidden_size, num_heads, mlp_ratio, dtype)
            for _ in range(att_depth))
        self.trunk = nn.ModuleList(
            AttnBlock(hidden_size, num_heads, mlp_ratio, dtype)
            for _ in range(trunk_depth))
        self.pose_branch = Mlp(hidden_size, 2 * hidden_size,
                               hidden_size + target_dim, dtype)
        # the reference's Sequential(Linear, GELU); the GELU is applied below
        self.ffeat_updater = nn.Sequential(nn.Linear(hidden_size,
                                                     hidden_size))

    def _backbone_input(self, images):
        """(B, S, H, W, 3) in [0, 1] -> (B*S, down, down, 3) normalized."""
        B, S, H, W, _ = images.shape
        x = images.reshape(B * S, H, W, 3).float()
        if (H, W) != (self.down_size, self.down_size):
            x = interpolate_bilinear(x, (self.down_size, self.down_size))
        mean = x.new_tensor(_RESNET_MEAN)
        std = x.new_tensor(_RESNET_STD)
        return (x - mean) / std

    def get_2d_image_features(self, images):
        """(B, S, H, W, 3) in [0, 1] -> per-frame pose-token features
        (B, S, C): DINOv2 patch tokens, the input transform, sincos
        position embedding, the pose token, then att_depth rounds of
        self-attention over each frame's tokens and cross-attention of the
        other frames to frame 0 (camera_predictor.py:241-303)."""
        B, S = images.shape[:2]
        feat = self.backbone(self._backbone_input(images))  # (B*S, P, z)
        feat = _norm(self.input_transform(feat))
        P, C = feat.shape[1], self.hidden_size
        patch = int(P ** 0.5)
        pos = get_2d_sincos_pos_embed(C, (patch, patch), device=feat.device)
        feat = (feat + pos.reshape(1, P, C)).reshape(B, S, P, C)
        token = self.pose_token.to(feat.dtype).expand(B, S, 1, C)
        feat = torch.cat([token, feat], dim=2)
        P1 = P + 1
        for self_blk, cross_blk in zip(self.self_att, self.cross_att):
            feat = self_blk(feat.reshape(B * S, P1, C)).reshape(B, S, P1, C)
            others = cross_blk(feat[:, 1:].reshape(B, (S - 1) * P1, C),
                               feat[:, 0])
            feat = torch.cat([feat[:, :1], others.reshape(
                B, S - 1, P1, C).to(feat.dtype)], dim=1)
        return feat[:, :, 0]

    def frame_descriptors(self, images):
        """(B, S, H, W, 3) in [0, 1] -> (B, S, z) f32 mean DINOv2 patch
        tokens, the frame descriptor of the DINO-similarity query ranking."""
        B, S = images.shape[:2]
        feat = self.backbone(self._backbone_input(images))
        desc = feat.float().mean(1).to(feat.dtype)
        return desc.reshape(B, S, -1).float()

    def _trunk_iter(self, rgb_feat, pose_enc, feat_init):
        """One pose-refinement iteration (camera_predictor.py:160-178)."""
        n_harm = (self.hidden_size // self.target_dim) // 2
        rgb_feat = rgb_feat + harmonic_embedding(pose_enc, n_harm).to(
            rgb_feat.dtype)
        for blk in self.trunk:
            rgb_feat = blk(rgb_feat)
        delta = self.pose_branch(rgb_feat)
        delta_pose = delta[..., : self.target_dim]
        delta_feat = delta[..., self.target_dim:]
        upd = linear(_norm(delta_feat), self.ffeat_updater[0], self.dtype)
        rgb_feat = F.gelu(upd) + rgb_feat
        pose_enc = pose_enc + delta_pose.float()
        return (rgb_feat + feat_init) / 2, pose_enc

    def forward(self, images, iters: int = 4, rgb_feat_init=None):
        """Returns {"pred_pose_enc": (B, S, 8) f32, "rgb_feat_init":
        (B, S, C)}, the latter reusable across query orderings
        (camera_predictor.py:147-180)."""
        if rgb_feat_init is None:
            rgb_feat = self.get_2d_image_features(images)
        else:
            rgb_feat = rgb_feat_init
        B, S, _ = rgb_feat.shape
        feat_init = rgb_feat
        pose_enc = torch.zeros(B, S, self.target_dim, dtype=torch.float32,
                               device=rgb_feat.device)
        for _ in range(iters):
            rgb_feat, pose_enc = self._trunk_iter(rgb_feat, pose_enc,
                                                  feat_init)
        return {"pred_pose_enc": pose_enc, "rgb_feat_init": feat_init}


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator):
    """Random init from `generator`, mirroring the JAX package's flax
    defaults: Linear, Conv, transposed Conv and packed in-projection
    kernels LeCun-normal (truncated at 2 std, fan-in = input channels x
    taps), biases 0, LayerNorm scale 1 and bias 0, LayerScale gammas 1,
    pos_embed N(0, 0.02), pose_token N(0, 1e-6), class, register and mask
    tokens 0. Parameters are drawn in name order."""
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, nn.LayerNorm)}
    # a transposed conv's kernel is (in, out, kH, kW)
    deconvs = {id(m.weight) for m in model.modules()
               if isinstance(m, nn.ConvTranspose2d)}
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "pose_token":
            p.normal_(0.0, 1e-6, generator=generator)
        elif leaf in ("cls_token", "register_tokens", "mask_token") \
                or leaf.endswith("bias"):
            p.zero_()
        elif id(p) in norms or leaf == "gamma":
            p.fill_(1.0)
        else:
            fan_in = (p.shape[0] * p[0, 0].numel() if id(p) in deconvs
                      else p[0].numel())
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return model


def init_camera_(model: CameraPredictor, generator: torch.Generator):
    """The camera predictor's seeded init (`seeded_init_`)."""
    return seeded_init_(model, generator)
