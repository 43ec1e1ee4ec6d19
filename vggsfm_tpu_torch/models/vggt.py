"""VGGT-1B (PyTorch): the feed-forward reconstruction of "VGGT: Visual
Geometry Grounded Transformer" (Wang et al., CVPR 2025, arXiv:2503.11651;
github.com/facebookresearch/vggt, `vggt/models/{aggregator,vggt}.py`,
`vggt/heads/{camera_head,dpt_head}.py`), the successor of VGGSfM. It has
no counterpart in the JAX package.

  * `Aggregator`: each frame's (S, H, W, 3) image through DINOv2 ViT-L/14
    with 4 registers (models/dinov2.py, attention through the long-sequence
    kernel), its normalized patch tokens behind one camera and 4 register
    tokens (frame 0 takes slot 0 of ``camera_token`` / ``register_token``,
    the others slot 1); then 24 rounds of a frame block (each frame's 1374
    tokens attend among themselves) and a global block (every token of the
    scene attends to every other), each round's two outputs kept side by
    side, 2048 wide. Only the rounds the heads read (`taps`, 4, 11, 17 and
    23) are kept: the same results as keeping all 24, at 2.2 GB instead of
    13 GB of f32 tokens for 48 frames.
  * `Block`: pre-LN attention with per-head LayerNorms on q and k and 2D
    rotary embeddings (`RotaryPositionEmbedding2D`), LayerScale, and a GELU
    MLP; attention is `ops.attention.flash_attention` (the hand-written
    kernel on the GPU).
  * `CameraHead`: the last round's camera tokens through an AdaLN-modulated
    trunk of 4 blocks 2048 wide, iterated 4 times on its own pose
    encoding (T, quaternion xyzw, FoV h and w).
  * `DPTHead`: the DPT decoder over the four tapped rounds with VGGT's
    input LayerNorm and sin-cos position embeddings, depth = exp and
    confidence = 1 + exp of its two output channels, 8 frames at a time.

Parameter names are the public code's (``aggregator.patch_embed.*``,
``aggregator.frame_blocks.N.attn.qkv``, ``.attn.q_norm``, ``.ls1.gamma``,
``aggregator.camera_token``, ``camera_head.poseLN_modulation.1``,
``depth_head.projects.i``, ``depth_head.scratch.refinenet1.*``), so the
public checkpoint loads with ``strict=True``, but for ``point_head`` and
``track_head``, which the feed-forward path never calls and which are not
built.

Precision: the aggregator computes in ``dtype`` (bf16 on the main path,
as the public demo's autocast does) with f32 LayerNorm statistics, f32
q/k normalization and rotary embedding, softmax statistics in f32 inside
the kernel, and an f32 residual stream (the LayerScale products are f32);
the camera and depth heads run in float32 outside the autocast, as the
public demo runs them, at PyTorch's default precision, pinned whatever the
caller set (`default_precision`): full-f32 products, TF32 convolutions.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.models.camera import _RESNET_MEAN, _RESNET_STD
from vggsfm_tpu_torch.models.dinov2 import (
    DinoMlp,
    DinoVisionTransformer,
    LayerScale,
    layer_norm,
    linear,
)
from vggsfm_tpu_torch.models.dpt import _Scratch, conv, resize
from vggsfm_tpu_torch.ops import attention as attn_ops
from vggsfm_tpu_torch.utils import trace
from vggsfm_tpu_torch.utils.precision import default_precision

TAPS = (4, 11, 17, 23)
# the pose branch's last bias in the seeded weights (`init_vggt_`)
POSE_BIAS = (0.0,) * 6 + (0.25,) * 3


class RotaryPositionEmbedding2D(nn.Module):
    """2D RoPE: the first half of a head rotates by the row position, the
    second by the column position, each half by rotate-half with angles
    pos * base^(-2k / half), k < half / 2, repeated over both quarters."""

    def __init__(self, frequency: float = 100.0):
        super().__init__()
        self.frequency = frequency

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, H, L, D) float; pos (B or 1, L, 2) integer (row, col)."""
        half = x.shape[-1] // 2
        inv = 1.0 / self.frequency ** (
            torch.arange(0, half, 2, device=x.device).float() / half)
        out = []
        for i, part in enumerate(x.chunk(2, dim=-1)):
            ang = pos[..., i].float()[..., None] * inv
            ang = torch.cat([ang, ang], dim=-1)[:, None]  # (B, 1, L, half)
            a, b = part.chunk(2, dim=-1)
            out.append(part * ang.cos() + torch.cat([-b, a], dim=-1)
                       * ang.sin())
        return torch.cat(out, dim=-1)


def softmax_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, H, L, D), f32 (the camera
    trunk's attention across the S frames)."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(s.float(), dim=-1).to(v.dtype) @ v


class Attention(nn.Module):
    """q|k|v projection, optional per-head q/k LayerNorms (eps 1e-5) and
    rotary embedding, full attention, out-projection. With `kernel` the
    attention is the long-sequence kernel (bf16, heads 64 wide), else
    `softmax_attention`."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False,
                 rope: nn.Module | None = None, dtype=torch.float32,
                 kernel: bool = True):
        super().__init__()
        self.num_heads, self.dtype, self.kernel = num_heads, dtype, kernel
        head = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = nn.LayerNorm(head) if qk_norm else None
        self.k_norm = nn.LayerNorm(head) if qk_norm else None
        self.proj = nn.Linear(dim, dim)
        self.rope = rope

    def forward(self, x: torch.Tensor, pos=None) -> torch.Tensor:
        B, L, C = x.shape
        H, dt = self.num_heads, self.dtype
        D = C // H
        qkv = linear(x, self.qkv, dt).view(B, L, 3, H, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, L, D)
        if self.q_norm is not None:
            q = F.layer_norm(q.float(), (D,), self.q_norm.weight,
                             self.q_norm.bias, self.q_norm.eps)
            k = F.layer_norm(k.float(), (D,), self.k_norm.weight,
                             self.k_norm.bias, self.k_norm.eps)
        if self.rope is not None:
            q, k = self.rope(q.float(), pos), self.rope(k.float(), pos)
        if self.kernel:
            q, k, v = (t.to(dt).reshape(B * H, L, D).contiguous()
                       for t in (q, k, v))
            o = attn_ops.flash_attention(q, k, v, B)
        else:
            o = softmax_attention(q.to(dt), k.to(dt), v)
            o = o.transpose(1, 2).reshape(B, L, C)
        return linear(o, self.proj, dt)


class Block(nn.Module):
    """Pre-LN transformer block (LayerNorms eps 1e-5, LayerScale, GELU MLP
    of `mlp_ratio` x dim) on an f32 residual stream, computing in
    `dtype`."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, rope: nn.Module | None = None,
                 dtype=torch.float32, kernel: bool = True):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qk_norm, rope, dtype, kernel)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = DinoMlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, pos=None) -> torch.Tensor:
        dt = self.dtype
        a = self.attn(layer_norm(x, self.norm1, dt), pos)
        x = x + self.ls1.gamma * a.float()
        h = F.gelu(linear(layer_norm(x, self.norm2, dt), self.mlp.fc1, dt))
        h = linear(h, self.mlp.fc2, dt)
        return x + self.ls2.gamma * h.float()


def patch_positions(gh: int, gw: int, special: int, device) -> torch.Tensor:
    """(1, special + gh * gw, 2) integer (row, col) positions of a frame's
    tokens: (0, 0) for the special tokens, (i + 1, j + 1) for patch (i, j)
    in row-major order."""
    ii, jj = torch.meshgrid(torch.arange(gh, device=device),
                            torch.arange(gw, device=device), indexing="ij")
    grid = torch.stack([ii, jj], dim=-1).reshape(-1, 2) + 1
    return torch.cat([grid.new_zeros(special, 2), grid])[None]


class Aggregator(nn.Module):
    """(S, H, W, 3) images in [0, 1] -> the tapped rounds' tokens, each
    (S, P, 2C) f32: [frame block output | global block output], P = 1 + 4
    registers + (H / 14)(W / 14)."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 4,
                 dino_depth: int = 24, dino_heads: int = 16,
                 rope_freq: float = 100.0, taps=TAPS, dtype=torch.bfloat16):
        super().__init__()
        self.patch_size, self.taps = patch_size, tuple(taps)
        self.patch_embed = DinoVisionTransformer(
            embed_dim=embed_dim, depth=dino_depth, num_heads=dino_heads,
            patch_size=patch_size, num_register_tokens=num_register_tokens,
            pos_embed_size=img_size // patch_size, dtype=dtype, flash=True)
        self.rope = RotaryPositionEmbedding2D(rope_freq)

        def blocks():
            return nn.ModuleList(
                Block(embed_dim, num_heads, mlp_ratio, qk_norm=True,
                      rope=self.rope, dtype=dtype) for _ in range(depth))
        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, embed_dim))
        self.register_token = nn.Parameter(
            torch.zeros(1, 2, num_register_tokens, embed_dim))
        self.patch_start_idx = 1 + num_register_tokens

    def special_tokens(self, S: int) -> torch.Tensor:
        """(S, 1 + registers, C): slot 0 for frame 0, slot 1 for the
        others."""
        slot = torch.tensor([0] + [1] * (S - 1),
                            device=self.camera_token.device)
        return torch.cat([self.camera_token[0, slot],
                          self.register_token[0, slot]], dim=1)

    def forward(self, images: torch.Tensor) -> list:
        S, H, W, _ = images.shape
        x = (images.float() - images.new_tensor(_RESNET_MEAN)) \
            / images.new_tensor(_RESNET_STD)
        with trace.span("vggt.patch_embed"):
            patches = self.patch_embed(x)
        x = torch.cat([self.special_tokens(S).float(), patches.float()],
                      dim=1)
        P, C = x.shape[1:]
        pos = patch_positions(H // self.patch_size, W // self.patch_size,
                              self.patch_start_idx, x.device)
        pos_all = pos.repeat(1, S, 1)
        kept = {}
        for i, (fb, gb) in enumerate(zip(self.frame_blocks,
                                         self.global_blocks)):
            with trace.span("vggt.frame_block"):
                x = fb(x.view(S, P, C), pos)
            f = x
            with trace.span("vggt.global_block"):
                x = gb(x.view(1, S * P, C), pos_all)
            if i in self.taps:
                kept[i] = torch.cat([f.view(S, P, C), x.view(S, P, C)],
                                    dim=-1)
        return [kept[i] for i in self.taps]


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def activate_pose(p: torch.Tensor) -> torch.Tensor:
    """Translation and quaternion linear, the two FoVs relu'd."""
    return torch.cat([p[..., :7], F.relu(p[..., 7:])], dim=-1)


class CameraHead(nn.Module):
    """The last tapped round's camera tokens (S, 2C) -> per iteration the
    activated pose encodings (S, 9), float32."""

    def __init__(self, dim_in: int = 2048, trunk_depth: int = 4,
                 num_heads: int = 16, mlp_ratio: float = 4.0):
        super().__init__()
        self.target_dim = 9
        self.trunk = nn.Sequential(*[
            Block(dim_in, num_heads, mlp_ratio, kernel=False)
            for _ in range(trunk_depth)])
        self.token_norm = nn.LayerNorm(dim_in)
        self.trunk_norm = nn.LayerNorm(dim_in)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim_in)
        self.poseLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(dim_in, 3 * dim_in))
        self.adaln_norm = nn.LayerNorm(dim_in, elementwise_affine=False,
                                       eps=1e-6)
        self.pose_branch = Mlp(dim_in, dim_in // 2, 9)

    @default_precision
    def forward(self, tokens: torch.Tensor, iterations: int = 4) -> list:
        """tokens (S, P, 2C): the last tapped round."""
        t = self.token_norm(tokens[:, 0].float())[None]  # (1, S, 2C)
        S = t.shape[1]
        p, out = None, []
        for _ in range(iterations):
            src = self.empty_pose_tokens.expand(1, S, 9) if p is None else p
            shift, scale, gate = self.poseLN_modulation(
                self.embed_pose(src)).chunk(3, dim=-1)
            u = gate * (self.adaln_norm(t) * (1 + scale) + shift) + t
            u = self.trunk(u)
            delta = self.pose_branch(self.trunk_norm(u))
            p = delta if p is None else p + delta
            out.append(activate_pose(p)[0])
        return out


def uv_grid(gw: int, gh: int, aspect: float, device) -> torch.Tensor:
    """(gh, gw, 2) (u, v) grid spanning the unit diagonal at `aspect`
    (width / height), centred on the pixels."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (gw - 1) / gw, sx * (gw - 1) / gw, gw,
                        device=device)
    ys = torch.linspace(-sy * (gh - 1) / gh, sy * (gh - 1) / gh, gh,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([uu, vv], dim=-1)


def sincos_embed(dim: int, pos: torch.Tensor, omega0: float) -> torch.Tensor:
    """(M,) -> (M, dim): sin then cos of pos / omega0^(k / (dim / 2)),
    computed in float64."""
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device)
    omega = 1.0 / omega0 ** (omega / (dim / 2.0))
    ang = pos.double().reshape(-1)[:, None] * omega
    return torch.cat([ang.sin(), ang.cos()], dim=1).float()


def position_embed(x: torch.Tensor, aspect: float, omega0: float = 100.0,
                   ratio: float = 0.1) -> torch.Tensor:
    """x (B, C, h, w) plus `ratio` times the sin-cos embedding of its (u, v)
    grid (u in the first C / 2 channels, v in the rest)."""
    C, h, w = x.shape[1:]
    uv = uv_grid(w, h, aspect, x.device).reshape(-1, 2)
    emb = torch.cat([sincos_embed(C // 2, uv[:, 0], omega0),
                     sincos_embed(C // 2, uv[:, 1], omega0)], dim=-1)
    return x + ratio * emb.view(h, w, C).permute(2, 0, 1)[None].to(x.dtype)


class DPTHead(nn.Module):
    """The tapped rounds -> depth and confidence (S, H, W), float32: per
    tap the shared LayerNorm, a 1x1 projection, the position embedding and
    a resize (x4, x2 transposed convs, identity, stride-2 conv); the DPT
    fusion of models/dpt.py (its `_Scratch`, whose coarsest refinenet has
    no skip unit here); output_conv1 at the finest level, a resize to the
    image, the position embedding again, conv 3x3 -> ReLU -> conv 1x1 to 2
    channels; depth = exp, confidence = 1 + exp."""

    def __init__(self, dim_in: int = 2048, patch_size: int = 14,
                 output_dim: int = 2, features: int = 256,
                 out_channels=(256, 512, 1024, 1024),
                 patch_start_idx: int = 5):
        super().__init__()
        self.patch_size, self.patch_start_idx = patch_size, patch_start_idx
        self.dtype = torch.float32
        c = out_channels
        self.norm = nn.LayerNorm(dim_in)
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, o, 1) for o in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(features, c, self.dtype)
        del self.scratch.refinenet4.resConfUnit1
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(True),
            nn.Conv2d(32, output_dim, 1))

    @default_precision
    def forward(self, taps: list, image_hw, chunk: int = 8):
        """taps: 4 x (S, P, 2C); -> (depth, conf), each (S, H, W)."""
        S = taps[0].shape[0]
        parts = [self._chunk([t[s:s + chunk] for t in taps], image_hw)
                 for s in range(0, S, chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def _chunk(self, taps: list, image_hw):
        H, W = image_hw
        ps, dt, sc = self.patch_size, self.dtype, self.scratch
        gh, gw = H // ps, W // ps
        aspect = W / H
        feats = []
        for i, t in enumerate(taps):
            x = self.norm(t[:, self.patch_start_idx:].float())
            x = x.transpose(1, 2).reshape(x.shape[0], x.shape[2], gh, gw)
            x = position_embed(conv(x, self.projects[i], dt), aspect)
            if i != 2:
                x = conv(x, self.resize_layers[i], dt)
            feats.append(conv(x, getattr(sc, f"layer{i + 1}_rn"), dt))
        x = sc.refinenet4(feats[3], out_hw=feats[2].shape[-2:])
        x = sc.refinenet3(x, feats[2], out_hw=feats[1].shape[-2:])
        x = sc.refinenet2(x, feats[1], out_hw=feats[0].shape[-2:])
        x = sc.refinenet1(x, feats[0])
        x = conv(x, sc.output_conv1, dt)
        x = position_embed(resize(x, (gh * ps, gw * ps)), aspect)
        x = F.relu(conv(x, sc.output_conv2[0], dt))
        x = conv(x, sc.output_conv2[2], dt).float()
        return torch.exp(x[:, 0]), 1.0 + torch.exp(x[:, 1])


class VGGT(nn.Module):
    """VGGT-1B's aggregator, camera head and depth head at the published
    widths by default. `forward` runs the three on (S, H, W, 3) frames in
    [0, 1]; the runner (vggt/runner.py) calls them one stage each."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 num_register_tokens: int = 4, dino_depth: int = 24,
                 dino_heads: int = 16, trunk_depth: int = 4,
                 head_heads: int = 16, dpt_features: int = 256,
                 dpt_out_channels=(256, 512, 1024, 1024), taps=TAPS,
                 dtype=torch.bfloat16):
        super().__init__()
        if taps[-1] != depth - 1:
            raise ValueError("the camera head reads the last round: taps "
                             f"must end at {depth - 1}, not {taps[-1]}")
        self.aggregator = Aggregator(
            img_size, patch_size, embed_dim, depth, num_heads, 4.0,
            num_register_tokens, dino_depth, dino_heads, taps=taps,
            dtype=dtype)
        self.camera_head = CameraHead(2 * embed_dim, trunk_depth, head_heads)
        self.depth_head = DPTHead(2 * embed_dim, patch_size, 2, dpt_features,
                                  dpt_out_channels, 1 + num_register_tokens)

    def forward(self, images: torch.Tensor, iterations: int = 4,
                chunk: int = 8) -> dict:
        taps = self.aggregator(images)
        poses = self.camera_head(taps[-1], iterations)
        depth, conf = self.depth_head(taps, images.shape[1:3], chunk)
        return {"pose_enc_list": poses, "depth": depth, "depth_conf": conf}


def init_vggt_(model: VGGT, generator: torch.Generator,
               pose_std: float = 1e-3) -> VGGT:
    """Seeded weights (models/camera.py `seeded_init_`: LeCun-normal
    kernels, zero biases, unit norms and LayerScales, pos_embed N(0, 0.02)),
    the special tokens LeCun as their slots' fan-in gives them, and the
    pose branch's last layer N(0, `pose_std`) with bias 0.25 on the
    quaternion's w and the two FoVs: after 4 iterations the cameras are
    finite and plausible (w ~ 1, FoV ~ 1 rad), where relu'd FoVs from
    LeCun weights give infinite focal lengths."""
    from vggsfm_tpu_torch.models.camera import seeded_init_

    seeded_init_(model, generator)
    fc2 = model.camera_head.pose_branch.fc2
    with torch.no_grad():
        fc2.weight.normal_(0.0, pose_std, generator=generator)
        fc2.bias.copy_(torch.tensor(POSE_BIAS))
    return model
