"""CoTracker-style iterative track transformer (PyTorch). Counterpart of
vggsfm_tpu/models/tracker.py (reference track_modules/blocks.py:192-471,
base_track_predictor.py, track_predictor.py).

Correlation uses the sample-then-dot form: bilinear interpolation is
linear, so sampling the correlation surface equals combining the dots of
the track feature with the (2r+2)^2 integer-grid neighborhood. Taps outside
the map contribute 0 (grid_sample's zeros padding), including the half-in
corner taps. Where the JAX package computes the full correlation map and
builds one-hot window matrices (TPU costs: DMA issue rate, scalar
gathers), every correlation call of this port, NHWC or flat channel-first,
any number of tracks, is one launch of the hand-written correlation kernel
(ops/corr.py) over all pyramid levels, which reads only the windows' cells.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vggsfm_tpu_torch.models.embeddings import (
    get_2d_embedding,
    get_2d_sincos_pos_embed,
)
from vggsfm_tpu_torch.models.encoders import BasicEncoder, ShallowEncoder
from vggsfm_tpu_torch.models.layers import (
    AttnBlock,
    CrossAttnBlock,
    cast_weight,
    group_norm_1,
)
from vggsfm_tpu_torch.models.sampling import (
    bilinear_sample,
    interpolate_bilinear,
    sample_features4d,
    subpixel_parabola,
)
from vggsfm_tpu_torch.ops.corr import corr_sample_kernel

# ------------------------------------------------------------ pyramids

def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 VALID average pool over the last two axes (odd edges dropped),
    the window summed in row-major order as XLA's reduce_window sums it."""
    H, W = x.shape[-2:]
    h, w = H // 2 * 2, W // 2 * 2
    return (((x[..., 0:h:2, 0:w:2] + x[..., 0:h:2, 1:w:2])
             + x[..., 1:h:2, 0:w:2]) + x[..., 1:h:2, 1:w:2]) / 4.0


def build_corr_pyramid(fmaps: torch.Tensor, num_levels: int,
                       cfirst: bool = False) -> list:
    """(B, S, H, W, C) -> list of up to `num_levels` maps, 2x avg-pooled,
    each contiguous NHWC (the correlation kernel reads every level of a
    call in one layout).

    With `cfirst` the levels are laid out (B, S, C, H, W): one transpose
    at level 0, then channel-first pooling (the JAX package's layout for
    the fine path's NHWC patch maps); the kernel reads them in place.

    Stops early once a map is smaller than 2x2 (reference blocks.py:
    355-361); the missing correlation features are zero-padded downstream.
    """
    x = fmaps.permute(0, 1, 4, 2, 3)  # (B, S, C, H, W)
    if cfirst:
        x = x.contiguous()
        pyramid = [x]
        for _ in range(num_levels - 1):
            if x.shape[-2] < 2 or x.shape[-1] < 2:
                break
            x = _avg_pool2(x)
            pyramid.append(x)
        return pyramid
    pyramid = [fmaps.contiguous()]
    for _ in range(num_levels - 1):
        if x.shape[-2] < 2 or x.shape[-1] < 2:
            break
        x = _avg_pool2(x)
        pyramid.append(x.permute(0, 1, 3, 4, 2).contiguous())
    return pyramid


def build_corr_pyramid_flat(x: torch.Tensor, hw: tuple, num_levels: int):
    """Flat channel-first pyramid: x (B, S, C, H*W) -> (levels list of
    (B, S, C, HW_l), hws list of (H_l, W_l))."""
    B, S, C, _ = x.shape
    H, W = hw
    levels, hws = [x], [(H, W)]
    for _ in range(num_levels - 1):
        if H < 2 or W < 2:
            break
        x = _avg_pool2(x.reshape(B, S, C, H, W))
        H, W = H // 2, W // 2
        x = x.reshape(B, S, C, H * W)
        levels.append(x)
        hws.append((H, W))
    return levels, hws


# ---------------------------------------------------------- correlation

def corr_sample(pyramid: list, coords: torch.Tensor,
                track_feats: torch.Tensor, radius: int,
                cfirst: bool = False) -> torch.Tensor:
    """Correlation features (B, S, N, L*(2r+1)^2) of an NHWC pyramid.

    pyramid: list of (B, S, Hi, Wi, C), or with `cfirst` of
    (B, S, C, Hi, Wi) (`build_corr_pyramid(cfirst=True)`), read in place
    as (H, W, C) views with column stride 1; coords (B, S, N, 2) at level-0
    scale; track_feats (B, S, N, C). One launch of the correlation kernel
    for all levels, any N: the maps are read in their dtype, the features
    take it, and the result comes in the features' dtype. The JAX function
    routes N >= 64 through the full correlation map and N == 1 fine patches
    through a full-map reduce; both compute the same taps, and in bf16
    round the map before the bilinear combine where the kernel rounds once
    at the end (tests/test_torch_corr.py states the difference).
    """
    B, S, N, _ = coords.shape
    C = track_feats.shape[-1]
    if cfirst:
        levels = [lvl.reshape(B * S, *lvl.shape[2:]).permute(0, 2, 3, 1)
                  for lvl in pyramid]
    else:
        levels = [lvl.reshape(B * S, *lvl.shape[2:]) for lvl in pyramid]
    out = corr_sample_kernel(
        levels, coords.reshape(B * S, N, 2).float().contiguous(),
        track_feats.reshape(B * S, N, C).to(levels[0].dtype), radius,
        out_dtype=track_feats.dtype)
    return out.reshape(B, S, N, -1)


def _sample_flat(x0: torch.Tensor, qp: torch.Tensor, hw: tuple):
    """Bilinear-sample flat channel-first features x0 (B, C, HW) at
    qp (B, N, 2) -> (B, N, C), border-clamped."""
    H, W = hw
    B, C, _ = x0.shape
    x_ = qp[..., 0].clamp(0.0, W - 1.0)
    y_ = qp[..., 1].clamp(0.0, H - 1.0)
    x0i = torch.floor(x_)
    y0i = torch.floor(y_)
    fx = (x_ - x0i)[..., None].to(x0.dtype)
    fy = (y_ - y0i)[..., None].to(x0.dtype)
    x0i, y0i = x0i.long(), y0i.long()
    x1i = (x0i + 1).clamp(max=W - 1)
    y1i = (y0i + 1).clamp(max=H - 1)
    xt = x0.transpose(1, 2)  # (B, HW, C)

    def tap(yy, xx):
        return torch.gather(xt, 1, (yy * W + xx)[..., None].expand(-1, -1, C))

    return ((1 - fy) * (1 - fx) * tap(y0i, x0i)
            + (1 - fy) * fx * tap(y0i, x1i)
            + fy * (1 - fx) * tap(y1i, x0i)
            + fy * fx * tap(y1i, x1i))


def _l2n(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x * torch.rsqrt(x.float().square().sum(dim, keepdim=True)
                           + 1e-12).to(x.dtype)


def _argmax_parabola(flat: torch.Tensor, H: int, W: int):
    """Argmax over the flat last axis of (..., H*W) scores + parabola
    sub-cell fit -> (xy (..., 2) f32, peak)."""
    idx = torch.argmax(flat, dim=-1)
    iy = idx // W
    ix = idx % W

    def val(dy, dx):
        yy = (iy + dy).clamp(0, H - 1)
        xx = (ix + dx).clamp(0, W - 1)
        return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

    off_x, off_y, c0 = subpixel_parabola(val)
    xy = torch.stack([ix + off_x, iy + off_y], dim=-1).float()
    return xy, c0


def _global_match_flat(levels0: torch.Tensor, query_feats: torch.Tensor,
                       qp: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Correlation-argmax init on flat channel-first fmaps (no cycle).
    levels0 (B, S, C, HW), query_feats (B, N, C), qp (B, N, 2) ->
    coords (B, S, N, 2) at fmap scale."""
    H, W = hw
    qf = _l2n(query_feats.to(levels0.dtype), -1)
    fm = _l2n(levels0, 2)
    corr = torch.einsum("bscx,bnc->bsnx", fm.float(), qf.float())
    coords, _ = _argmax_parabola(corr, H, W)
    coords[:, 0] = qp.float()
    return coords


def corr_sample_flat(levels: list, hws: list, coords: torch.Tensor,
                     track_feats: torch.Tensor, radius: int):
    """Correlation features from a flat channel-first pyramid.

    levels[i] (B, S, C, HW_i); coords (B, S, N, 2) level-0 scale;
    track_feats (B, S, N, C) -> (B, S, N, L*(2r+1)^2) in the features'
    dtype. The kernel reads the levels in place through (H, W, C) strides:
    one launch, the windows' cells only, no f32 copy of the pyramid.
    """
    B, S, N, C = track_feats.shape
    maps = [lvl.reshape(B * S, C, H, W).permute(0, 2, 3, 1)
            for lvl, (H, W) in zip(levels, hws)]
    out = corr_sample_kernel(
        maps, coords.reshape(B * S, N, 2).float().contiguous(),
        track_feats.reshape(B * S, N, C).to(maps[0].dtype), radius,
        out_dtype=track_feats.dtype)
    return out.reshape(B, S, N, -1)


def global_match_coords(fmaps: torch.Tensor, query_feats: torch.Tensor,
                        qp: torch.Tensor, cycle: bool = False):
    """Correlation-argmax track initialization (weights-free matching).

    fmaps (B, S, H, W, C) level-0 maps; query_feats (B, N, C); qp (B, N, 2)
    query positions at fmap scale. Returns (coords (B, S, N, 2),
    conf (B, S, N) peak cosine similarity, cyc_dist (B, S, N)
    forward-backward match distance in cells, or None without `cycle`).
    Frames are matched one at a time to bound the (N, H*W) f32 scores.
    """
    B, S, H, W, C = fmaps.shape
    qf = _l2n(query_feats.to(fmaps.dtype), -1)
    fmaps = _l2n(fmaps, -1)

    def match(fm, feats):
        corr = torch.einsum("bhwc,bnc->bnhw", fm.float(), feats.float())
        return _argmax_parabola(corr.reshape(B, -1, H * W), H, W)

    fm0 = fmaps[:, 0]
    coords, conf, cyc = [], [], []
    for s in range(S):
        fm = fmaps[:, s]
        xy, c0 = match(fm, qf)
        coords.append(xy)
        conf.append(c0)
        if cycle:
            feats_m = _l2n(bilinear_sample(fm, xy).to(fmaps.dtype), -1)
            back_xy, _ = match(fm0, feats_m)
            cyc.append(torch.linalg.norm(back_xy - qp.float(), dim=-1))
    coords = torch.stack(coords, dim=1)
    conf = torch.stack(conf, dim=1)
    coords[:, 0] = qp.float()
    if not cycle:
        return coords, conf, None
    cyc = torch.stack(cyc, dim=1)
    cyc[:, 0] = 0.0
    return coords, conf, cyc


# ------------------------------------------------------------- modules

class EfficientUpdateFormer(nn.Module):
    """Factored time/space transformer with virtual-track tokens
    (reference blocks.py:192-335). x (B, N, T, input_dim) ->
    (B, N, T, output_dim)."""

    def __init__(self, space_depth: int = 6, time_depth: int = 6,
                 input_dim: int = 664, hidden_size: int = 384,
                 num_heads: int = 8, output_dim: int = 130,
                 mlp_ratio: float = 4.0, add_space_attn: bool = True,
                 num_virtual_tracks: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden_size = hidden_size
        self.add_space_attn = add_space_attn
        self.time_depth, self.space_depth = time_depth, space_depth
        self.input_transform = nn.Linear(input_dim, hidden_size)
        self.flow_head = nn.Linear(hidden_size, output_dim)
        if add_space_attn:
            # reference spelling (blocks.py:222), kept for the checkpoint
            self.virual_tracks = nn.Parameter(
                torch.empty(1, num_virtual_tracks, 1, hidden_size))

        def blocks(cls, n):
            return nn.ModuleList(cls(hidden_size, num_heads, mlp_ratio,
                                     dtype) for _ in range(n))

        self.time_blocks = blocks(AttnBlock, time_depth)
        if add_space_attn:
            self.space_virtual_blocks = blocks(AttnBlock, space_depth)
            self.space_point2virtual_blocks = blocks(CrossAttnBlock,
                                                     space_depth)
            self.space_virtual2point_blocks = blocks(CrossAttnBlock,
                                                     space_depth)

    def forward(self, x, group=None):
        """With `group` (a mesh `Axis`), x holds this rank's block of the
        tracks: the virtual tracks' cross-attention over the point tokens
        (their only coupling) combines the blocks across the group, and
        the replicated virtual tokens come out the same on every rank."""
        B, N, T, _ = x.shape
        dt, Ch = self.dtype, self.hidden_size
        x = x.to(dt)
        tokens = F.linear(x, cast_weight(self.input_transform.weight, dt),
                          cast_weight(self.input_transform.bias, dt))
        init_tokens = tokens
        V = 0
        if self.add_space_attn:
            V = self.virual_tracks.shape[1]
            virtual = cast_weight(self.virual_tracks, dt).expand(B, V, T, Ch)
            tokens = torch.cat([tokens, virtual], dim=1)
        Ntot = tokens.shape[1]
        j = 0
        stride = (self.time_depth // self.space_depth
                  if self.add_space_attn and self.space_depth else 1)
        for i in range(self.time_depth):
            tt = tokens.reshape(B * Ntot, T, Ch)
            tokens = self.time_blocks[i](tt).reshape(B, Ntot, T, Ch)
            if self.add_space_attn and i % stride == 0:
                st = tokens.permute(0, 2, 1, 3).reshape(B * T, Ntot, Ch)
                point_t = st[:, : Ntot - V]
                virt_t = st[:, Ntot - V:]
                virt_t = self.space_virtual2point_blocks[j](virt_t, point_t,
                                                            group=group)
                virt_t = self.space_virtual_blocks[j](virt_t)
                point_t = self.space_point2virtual_blocks[j](point_t, virt_t)
                st = torch.cat([point_t, virt_t], dim=1)
                tokens = st.reshape(B, T, Ntot, Ch).permute(0, 2, 1, 3)
                j += 1
        if self.add_space_attn:
            tokens = tokens[:, : Ntot - V]
        tokens = tokens + init_tokens
        return F.linear(tokens, cast_weight(self.flow_head.weight, dt),
                        cast_weight(self.flow_head.bias, dt))


class BaseTrackerPredictor(nn.Module):
    """Iterative track refinement head (reference base_track_predictor.py).
    The JAX package's ``nn.scan`` over iterations is a Python loop here."""

    def __init__(self, stride: int = 4, corr_levels: int = 5,
                 corr_radius: int = 4, latent_dim: int = 128,
                 hidden_size: int = 384, use_spaceatt: bool = True,
                 depth: int = 6, fine: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.corr_levels = stride, corr_levels
        self.corr_radius, self.latent_dim = corr_radius, latent_dim
        self.fine, self.dtype = fine, dtype
        self.updateformer = EfficientUpdateFormer(
            space_depth=depth if use_spaceatt else 0, time_depth=depth,
            input_dim=self.transformer_dim, hidden_size=hidden_size,
            output_dim=latent_dim + 2, add_space_attn=use_spaceatt,
            dtype=dtype)
        self.norm = nn.GroupNorm(1, latent_dim)
        self.ffeat_updater = nn.Sequential(nn.Linear(latent_dim, latent_dim),
                                           nn.GELU())
        if not fine:
            self.vis_predictor = nn.Sequential(nn.Linear(latent_dim, 1))

    @property
    def transformer_dim(self) -> int:
        d = (self.corr_levels * (self.corr_radius * 2 + 1) ** 2
             + self.latent_dim * 2)
        if self.fine:
            return d + (4 if d % 2 == 0 else 5)
        return d + (4 - d % 4) % 4

    def _dense(self, lin: nn.Linear, x):
        dt = self.dtype
        return F.linear(x.to(dt), cast_weight(lin.weight, dt),
                        cast_weight(lin.bias, dt))

    def _iter_step(self, coords, track_feats, pyramid, sampled_pos, qp,
                   flat_hws, corr_cfirst=False, group=None):
        B, S, N, _ = coords.shape
        if flat_hws is not None:
            fcorrs = corr_sample_flat(pyramid, flat_hws, coords, track_feats,
                                      self.corr_radius)
        else:
            fcorrs = corr_sample(pyramid, coords, track_feats,
                                 self.corr_radius, cfirst=corr_cfirst)
        flows_bn = (coords - coords[:, 0:1]).permute(0, 2, 1, 3)
        flows_emb = get_2d_embedding(flows_bn, self.latent_dim // 2,
                                     cat_coords=False)
        xx = torch.cat([flows_emb, flows_bn,
                        fcorrs.permute(0, 2, 1, 3).float(),
                        track_feats.permute(0, 2, 1, 3).float()], dim=-1)
        pad = self.transformer_dim - xx.shape[-1]
        if pad > 0:
            xx = F.pad(xx, (0, pad))
        xx = xx + sampled_pos[:, :, None, :]

        delta = self.updateformer(xx, group=group)  # (B, N, S, latent + 2)
        delta_coords = delta[..., :2].float().permute(0, 2, 1, 3)
        df = delta[..., 2:].reshape(-1, self.latent_dim)
        df = group_norm_1(df, self.norm.weight, self.norm.bias)
        df = F.gelu(self._dense(self.ffeat_updater[0], df)).to(self.dtype)
        tfeats_bn = track_feats.permute(0, 2, 1, 3).reshape(
            -1, self.latent_dim)
        track_feats = (tfeats_bn + df).reshape(
            B, N, S, self.latent_dim).permute(0, 2, 1, 3)
        coords = coords + delta_coords
        coords[:, 0] = qp
        return coords, track_feats

    def forward(self, query_points, fmaps, iters: int = 4,
                down_ratio: int = 1, return_feat: bool = False,
                matching_init: bool = False, matching_vis: bool = False,
                fmaps_flat_hw: tuple | None = None, group=None):
        """query_points (B, N, 2) pixels; fmaps (B, S, HH, WW, C) — or,
        with ``fmaps_flat_hw=(HH, WW)``, flat channel-first
        (B, S, C, HH*WW). With `group` (a mesh `Axis`), the query points
        are this rank's block of the tracks (`EfficientUpdateFormer`).

        Returns (coord_predictions list, visibility (B, S, N) or None
        [, track_feats, query_feats]).
        """
        B, N, _ = query_points.shape
        if fmaps_flat_hw is not None:
            _, S, C, _ = fmaps.shape
            HH, WW = fmaps_flat_hw
        else:
            _, S, HH, WW, C = fmaps.shape
        assert C == self.latent_dim
        fmaps = fmaps.to(self.dtype)
        scale = float(self.stride) * float(down_ratio)
        qp = query_points.float() / scale
        coords = qp[:, None].expand(B, S, N, 2).clone()

        if fmaps_flat_hw is not None:
            query_feats = _sample_flat(fmaps[:, 0], qp, (HH, WW))
        else:
            query_feats = sample_features4d(fmaps[:, 0], qp)
        track_feats = query_feats[:, None].expand(B, S, N, C)

        match_cyc = None
        if matching_init:
            if fmaps_flat_hw is not None:
                assert not matching_vis, \
                    "cycle matching is not supported on the flat fine path"
                coords = _global_match_flat(fmaps, query_feats, qp,
                                            (HH, WW))
            else:
                coords, _, match_cyc = global_match_coords(
                    fmaps, query_feats, qp, cycle=matching_vis)

        # the JAX package's rule for the channel-first pyramid: the fine
        # predictor's one track per NHWC patch map with few channels
        corr_cfirst = (fmaps_flat_hw is None and self.fine and N == 1
                       and HH * WW <= 4096 and C < 128)
        flat_hws = None
        if fmaps_flat_hw is not None:
            pyramid, flat_hws = build_corr_pyramid_flat(
                fmaps, (HH, WW), self.corr_levels)
        else:
            pyramid = build_corr_pyramid(fmaps, self.corr_levels,
                                         cfirst=corr_cfirst)

        # one sincos grid for every batch element, sampled with the
        # flattened (1, B*N, 2) query set
        pos_grid = get_2d_sincos_pos_embed(self.transformer_dim, (HH, WW),
                                           device=qp.device)
        sampled_pos = bilinear_sample(
            pos_grid, qp.reshape(1, B * N, 2)).reshape(B, N, -1)

        coord_preds = []
        for _ in range(iters):
            coords, track_feats = self._iter_step(
                coords, track_feats, pyramid, sampled_pos, qp, flat_hws,
                corr_cfirst, group)
            coord_preds.append(coords * scale)

        vis = None
        if not self.fine:
            if matching_vis and match_cyc is not None:
                # weights-free visibility from the forward-backward match
                vis = torch.sigmoid(2.0 * (1.5 - match_cyc))
            else:
                v = self._dense(self.vis_predictor[0],
                                track_feats.reshape(-1, self.latent_dim))
                vis = torch.sigmoid(v.float().reshape(B, S, N))
        if return_feat:
            return coord_preds, vis, track_feats, query_feats
        return coord_preds, vis


class TrackerPredictor(nn.Module):
    """Coarse + fine two-stage tracker (reference track_predictor.py):
    coarse BasicEncoder (stride 4, down ratio 2) + 6-layer space/time
    former; fine ShallowEncoder (stride 1) + 4-layer time-only former on
    31x31 patches. Its state_dict keys are the reference checkpoint's
    ``track_predictor.*`` keys with the prefix stripped."""

    def __init__(self, coarse_stride: int = 4, coarse_down_ratio: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.coarse_stride, self.coarse_down_ratio = (coarse_stride,
                                                      coarse_down_ratio)
        self.dtype = dtype
        self.coarse_fnet = BasicEncoder(128, coarse_stride, dtype)
        self.coarse_predictor = BaseTrackerPredictor(stride=coarse_stride,
                                                     dtype=dtype)
        self.fine_fnet = ShallowEncoder(32, 1, dtype)
        self.fine_predictor = BaseTrackerPredictor(
            stride=1, depth=4, corr_levels=3, corr_radius=3, latent_dim=32,
            hidden_size=256, fine=True, use_spaceatt=False, dtype=dtype)

    def process_images_to_fmaps(self, images):
        """(B, S, H, W, 3) in [0, 1] -> (B, S, H', W', 128) features."""
        B, S, H, W, _ = images.shape
        x = images.reshape(B * S, H, W, 3)
        if self.coarse_down_ratio > 1:
            x = interpolate_bilinear(x, (H // self.coarse_down_ratio,
                                         W // self.coarse_down_ratio))
        fmaps = self.coarse_fnet(x)
        return fmaps.reshape(B, S, *fmaps.shape[1:])

    def forward(self, images, query_points, fmaps=None, coarse_iters=6,
                matching_init=False, matching_vis=False, group=None):
        """Coarse-only forward (fine refinement: models/refine.py); with
        `group`, on this rank's block of the query points.
        Returns (coarse_pred_track (B, S, N, 2), pred_vis (B, S, N))."""
        if fmaps is None:
            fmaps = self.process_images_to_fmaps(images)
        coord_preds, vis = self.coarse_predictor(
            query_points, fmaps, iters=coarse_iters,
            down_ratio=self.coarse_down_ratio, matching_init=matching_init,
            matching_vis=matching_vis, group=group)
        return coord_preds[-1], vis


@torch.no_grad()
def init_tracker_(model: nn.Module, generator: torch.Generator):
    """Random init from `generator`, mirroring the JAX package's: every
    Linear/Conv kernel LeCun-normal (truncated at 2 std), biases 0,
    GroupNorm/LayerNorm scale 1 and bias 0, virtual tracks N(0, 1), and
    flow_head zero so a fresh tracker predicts zero deltas and keeps the
    matching init."""
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("virual_tracks"):
            p.normal_(0.0, 1.0, generator=generator)
        elif ".norm." in f".{name}" or "norm_context" in name:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf.endswith("bias"):
            p.zero_()
        elif "flow_head" in name:
            p.zero_()
        else:
            fan_in = p[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return model
