"""Plain float32 reference of VGGT-1B's feed-forward reconstruction, written
from the block equations of "VGGT: Visual Geometry Grounded Transformer"
(Wang et al., CVPR 2025, arXiv:2503.11651) and its public code
(github.com/facebookresearch/vggt: `vggt/models/aggregator.py`,
`vggt/heads/camera_head.py`, `vggt/heads/dpt_head.py`, `demo_colmap.py`).
Plain `torch` operations in float32, one file, importing nothing of the
program under test or of JAX; TF32 is switched off for matrix products and
convolutions whenever a model here is built. Products are F.linear,
torch.matmul and the convolutions, never the `@` operator, so that a torch
function mode sees each of them (the control rounds their operands).

The parameter names are the public code's, so one state dict loads into
this reference, the program and (but for the heads not built) the public
model.

Departures from the public code, each of which leaves the function as it
is:
  * `point_head` and `track_head` are not built: the feed-forward
    reconstruction never calls them.
  * The aggregator returns only the rounds the heads read (`taps`: 4, 11,
    17, 23), not all 24.
  * Attention is softmax(q k^T / sqrt(D)) v written out, over blocks of
    query rows (`attention`) so that the global blocks fit at 48 frames.
  * DINOv2 takes images whose patch grid is its position-embedding grid
    (518 px for ViT-L/14): the public model then does not interpolate it,
    and this reference raises rather than guess the interpolation.
  * The DPT's residual conv units add their input to conv2(relu(conv1(
    relu(input)))), as DepthAnythingV2's; the values this and the
    configuration file list under `assumed` were fixed without the public
    source at hand.
  * Images come as (S, H, W, 3) in [0, 1] (the program's layout), not
    (B, S, 3, H, W); one scene at a time.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
TAPS = (4, 11, 17, 23)
# scores held at once by `attention`: 2^28 f32 values, 1 GiB
SCORE_BUDGET = 2 ** 28


def strict_f32() -> None:
    """Full float32 products and convolutions on the GPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v for (B, H, L, D), in blocks of query
    rows."""
    B, H, L, D = q.shape
    rows = max(1, SCORE_BUDGET // (B * H * k.shape[2]))
    out = []
    for i in range(0, L, rows):
        s = torch.matmul(q[:, :, i:i + rows], k.transpose(-1, -2)) \
            / math.sqrt(D)
        out.append(torch.matmul(torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=2)


# ------------------------------------------------------------- DINOv2

class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DinoAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, L, C = x.shape
        q, k, v = self.qkv(x).view(B, L, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, L, C))


class DinoBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class DinoVisionTransformer(nn.Module):
    """DINOv2 ViT with register tokens: (B, 3, H, W) normalized images ->
    the final-LayerNorm'd patch tokens (B, (H/14)(W/14), C)."""

    def __init__(self, dim=1024, depth=24, heads=16, patch=14, registers=4,
                 grid=37):
        super().__init__()
        self.patch, self.grid, self.registers = patch, grid, registers
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.mask_token = nn.Parameter(torch.zeros(1, dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, registers, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(DinoBlock(dim, heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        B, _, H, W = x.shape
        if (H // self.patch, W // self.patch) != (self.grid, self.grid):
            raise ValueError("the patch grid must be the position grid")
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = x + self.pos_embed[:, 1:]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, -1, -1)
        regs = self.register_tokens.expand(B, -1, -1)
        x = torch.cat([cls, regs, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.registers:]


# ----------------------------------------------------------- aggregator

def rope_2d(x, pos, base=100.0):
    """2D rotary embedding of (B, H, L, D) at integer positions (B or 1,
    L, 2) = (row, col): dims [0, D/2) rotate by the row, [D/2, D) by the
    column; each half x by x cos(a) + rotate_half(x) sin(a), with
    rotate_half(a, b) = (-b, a) and a = pos * base^(-2k / (D / 2)), k <
    D / 4, repeated over both quarters of the half."""
    half = x.shape[-1] // 2
    theta = base ** (-torch.arange(0, half, 2, device=x.device).float()
                     / half)
    out = []
    for i, part in enumerate((x[..., :half], x[..., half:])):
        a = pos[..., i].float()[:, None, :, None] * theta
        a = torch.cat([a, a], dim=-1)
        lo, hi = part[..., :half // 2], part[..., half // 2:]
        out.append(part * torch.cos(a) + torch.cat([-hi, lo], -1)
                   * torch.sin(a))
    return torch.cat(out, dim=-1)


class Attention(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, rope=False):
        super().__init__()
        self.heads, self.use_rope = heads, rope
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = nn.LayerNorm(dim // heads) if qk_norm else None
        self.k_norm = nn.LayerNorm(dim // heads) if qk_norm else None
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos=None):
        B, L, C = x.shape
        q, k, v = self.qkv(x).view(B, L, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.use_rope:
            q, k = rope_2d(q, pos), rope_2d(k, pos)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, L, C))


class Block(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, rope=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads, qk_norm, rope)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class Aggregator(nn.Module):
    """(S, H, W, 3) images in [0, 1] -> for each round in `taps` the
    (S, P, 2C) tokens [frame block output | global block output]."""

    def __init__(self, img_size=518, patch=14, dim=1024, depth=24, heads=16,
                 registers=4, dino_depth=24, dino_heads=16, taps=TAPS):
        super().__init__()
        self.patch, self.taps, self.registers = patch, tuple(taps), registers
        self.patch_embed = DinoVisionTransformer(
            dim, dino_depth, dino_heads, patch, registers, img_size // patch)
        self.frame_blocks = nn.ModuleList(
            Block(dim, heads, True, True) for _ in range(depth))
        self.global_blocks = nn.ModuleList(
            Block(dim, heads, True, True) for _ in range(depth))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, registers, dim))

    def forward(self, images):
        S, H, W, _ = images.shape
        x = images.permute(0, 3, 1, 2)
        x = (x - x.new_tensor(RESNET_MEAN)[:, None, None]) \
            / x.new_tensor(RESNET_STD)[:, None, None]
        patches = self.patch_embed(x)
        special = torch.cat([self.camera_token, self.register_token], dim=2)
        special = torch.cat([special[0, :1], special[0, 1:].expand(
            S - 1, -1, -1)])
        x = torch.cat([special, patches], dim=1)
        P, C = x.shape[1:]
        gh, gw = H // self.patch, W // self.patch
        rows = torch.arange(gh, device=x.device).repeat_interleave(gw) + 1
        cols = torch.arange(gw, device=x.device).repeat(gh) + 1
        pos = torch.cat([torch.zeros(1 + self.registers, 2, device=x.device,
                                     dtype=torch.long),
                         torch.stack([rows, cols], dim=-1)])[None]
        kept = {}
        for i in range(len(self.frame_blocks)):
            x = self.frame_blocks[i](x.reshape(S, P, C), pos)
            f = x
            x = self.global_blocks[i](x.reshape(1, S * P, C),
                                      pos.repeat(1, S, 1))
            if i in self.taps:
                kept[i] = torch.cat([f, x.reshape(S, P, C)], dim=-1)
        return [kept[i] for i in self.taps]


# ---------------------------------------------------------- camera head

class CameraHead(nn.Module):
    """The last round's tokens (S, P, 2C) -> the activated pose encodings
    (S, 9) of each iteration: T (3, linear), quaternion xyzw (4, linear),
    FoV h and w (relu)."""

    def __init__(self, dim=2048, depth=4, heads=16):
        super().__init__()
        self.trunk = nn.Sequential(*[Block(dim, heads) for _ in range(depth)])
        self.token_norm = nn.LayerNorm(dim)
        self.trunk_norm = nn.LayerNorm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(),
                                               nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, elementwise_affine=False,
                                       eps=1e-6)
        self.pose_branch = Mlp(dim, dim // 2, 9)

    def forward(self, tokens, iterations=4):
        t = self.token_norm(tokens[:, 0])[None]
        S = t.shape[1]
        pose, out = None, []
        for _ in range(iterations):
            e = self.embed_pose(self.empty_pose_tokens.expand(1, S, 9)
                                if pose is None else pose)
            shift, scale, gate = self.poseLN_modulation(e).chunk(3, dim=-1)
            u = t + gate * (self.adaln_norm(t) * (1 + scale) + shift)
            delta = self.pose_branch(self.trunk_norm(self.trunk(u)))
            pose = delta if pose is None else pose + delta
            out.append(torch.cat([pose[0, :, :7], F.relu(pose[0, :, 7:])],
                                 dim=-1))
        return out


# ----------------------------------------------------------- depth head

class ResidualConvUnit(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, c, skip=True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, features, out_channels, output_dim):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features,
                                                              skip=i < 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, output_dim, 1))


def position_embedding(C, h, w, aspect, omega0=100.0, ratio=0.1):
    """(1, C, h, w): `ratio` x the sin-cos embedding of the (u, v) grid
    that spans the unit diagonal at `aspect` = W / H, centred on the
    pixels; u fills the first C / 2 channels, v the rest, each as [sin |
    cos] of pos / omega0^(k / (C / 4)), k < C / 4."""
    diag = math.sqrt(aspect ** 2 + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    u = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w,
                       dtype=torch.float64)
    v = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h,
                       dtype=torch.float64)
    omega = 1.0 / omega0 ** (torch.arange(C // 4, dtype=torch.float64)
                             / (C / 4))

    def sincos(p):
        a = p[:, None] * omega
        return torch.cat([a.sin(), a.cos()], dim=-1)
    eu = sincos(u)[None, :, :].expand(h, w, C // 2)
    ev = sincos(v)[:, None, :].expand(h, w, C // 2)
    emb = torch.cat([eu, ev], dim=-1).float()
    return ratio * emb.permute(2, 0, 1)[None]


class DPTHead(nn.Module):
    """The tapped rounds (4 x (S, P, 2C)) -> depth = exp(d) and confidence
    = 1 + exp(c), each (S, H, W), `chunk` frames at a time."""

    def __init__(self, dim=2048, patch=14, features=256,
                 out_channels=(256, 512, 1024, 1024), special=5):
        super().__init__()
        self.patch, self.special = patch, special
        c = out_channels
        self.norm = nn.LayerNorm(dim)
        self.projects = nn.ModuleList(nn.Conv2d(dim, o, 1) for o in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(features, c, 2)

    def forward(self, taps, image_hw, chunk=8):
        S = taps[0].shape[0]
        parts = [self.run(taps, image_hw, s, min(s + chunk, S))
                 for s in range(0, S, chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def run(self, taps, image_hw, s0, s1):
        H, W = image_hw
        gh, gw = H // self.patch, W // self.patch
        sc = self.scratch
        feats = []
        for i, t in enumerate(taps):
            x = self.norm(t[s0:s1, self.special:])
            x = x.transpose(1, 2).reshape(s1 - s0, -1, gh, gw)
            x = self.projects[i](x)
            x = x + position_embedding(x.shape[1], gh, gw, W / H).to(x)
            x = self.resize_layers[i](x)
            feats.append(getattr(sc, f"layer{i + 1}_rn")(x))
        x = sc.refinenet4(feats[3], size=feats[2].shape[-2:])
        x = sc.refinenet3(x, feats[2], size=feats[1].shape[-2:])
        x = sc.refinenet2(x, feats[1], size=feats[0].shape[-2:])
        x = sc.refinenet1(x, feats[0])
        x = sc.output_conv1(x)
        x = F.interpolate(x, size=(gh * self.patch, gw * self.patch),
                          mode="bilinear", align_corners=True)
        x = x + position_embedding(x.shape[1], x.shape[2], x.shape[3],
                                   W / H).to(x)
        x = sc.output_conv2(x)
        return torch.exp(x[:, 0]), 1 + torch.exp(x[:, 1])


# ------------------------------------------------------------ the model

class VGGT(nn.Module):
    """VGGT-1B's aggregator, camera head and depth head (published widths
    by default)."""

    def __init__(self, img_size=518, patch_size=14, embed_dim=1024,
                 depth=24, num_heads=16, num_register_tokens=4,
                 dino_depth=24, dino_heads=16, trunk_depth=4, head_heads=16,
                 dpt_features=256, dpt_out_channels=(256, 512, 1024, 1024),
                 taps=TAPS):
        super().__init__()
        strict_f32()
        self.aggregator = Aggregator(img_size, patch_size, embed_dim, depth,
                                     num_heads, num_register_tokens,
                                     dino_depth, dino_heads, taps)
        self.camera_head = CameraHead(2 * embed_dim, trunk_depth, head_heads)
        self.depth_head = DPTHead(2 * embed_dim, patch_size, dpt_features,
                                  dpt_out_channels, 1 + num_register_tokens)

    def forward(self, images, iterations=4, chunk=8):
        taps = self.aggregator(images)
        poses = self.camera_head(taps[-1], iterations)
        depth, conf = self.depth_head(taps, images.shape[1:3], chunk)
        return {"pose_enc_list": poses, "depth": depth, "depth_conf": conf}


# ------------------------------------------------------------- geometry

def quat_to_mat(q):
    """(..., 4) quaternions xyzw (not necessarily unit) -> (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    return torch.stack([
        1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


def pose_to_cameras(pose, image_hw):
    """(S, 9) pose encodings -> extrinsics [R | T] (S, 3, 4) and pinhole
    intrinsics (S, 3, 3): f_y = (H / 2) / tan(fov_h / 2), f_x = (W / 2) /
    tan(fov_w / 2), principal point (W / 2, H / 2)."""
    H, W = image_hw
    extr = torch.cat([quat_to_mat(pose[:, 3:7]), pose[:, :3, None]], dim=-1)
    K = torch.zeros(pose.shape[0], 3, 3, dtype=pose.dtype,
                    device=pose.device)
    K[:, 0, 0] = (W / 2) / torch.tan(pose[:, 8] / 2)
    K[:, 1, 1] = (H / 2) / torch.tan(pose[:, 7] / 2)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    return extr, K


def unproject(depth, extr, K, frame, x, y):
    """World points of pixels (x, y) of frames `frame` (each (N,)):
    R^T (depth K^-1 [x, y, 1]^T - T)."""
    d = depth[frame, y, x]
    pix = torch.stack([x.to(d.dtype), y.to(d.dtype), torch.ones_like(d)],
                      dim=-1)
    cam = d[:, None] * torch.matmul(torch.linalg.inv(K)[frame],
                                    pix[:, :, None])[..., 0]
    R, T = extr[frame, :, :3], extr[frame, :, 3]
    return torch.matmul(R.transpose(1, 2), (cam - T)[:, :, None])[..., 0]
