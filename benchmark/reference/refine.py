"""Fine track refinement on 31x31 patches + confidence scoring.
Counterpart of vggsfm_tpu/models/refine.py (reference
track_modules/refine_track.py:24-294).

Patches are gathered by index at integer-floored, frame-clamped window
corners (x and y clamped independently), as the JAX package does with its
tile gathers.
"""

from __future__ import annotations

import torch

from .sampling import subpixel_parabola


def _window_grid(size: int, device):
    r = torch.arange(size, device=device)
    return torch.meshgrid(r, r, indexing="ij")  # (dy, dx)


def _gather_windows(img: torch.Tensor, tl_x: torch.Tensor,
                    tl_y: torch.Tensor, size: int) -> torch.Tensor:
    """img (T, H, W, C), tl (T, N) in-frame top-left corners ->
    (T, N, size, size, C)."""
    T, H, W, C = img.shape
    N = tl_x.shape[1]
    dy, dx = _window_grid(size, img.device)
    idx = ((tl_y[..., None, None] + dy) * W
           + (tl_x[..., None, None] + dx)).reshape(T, N * size * size)
    win = torch.gather(img.reshape(T, H * W, C), 1,
                       idx[..., None].expand(-1, -1, C))
    return win.reshape(T, N, size, size, C)


def extract_patches(images: torch.Tensor, centers: torch.Tensor,
                    pradius: int):
    """psize x psize patches (psize = 2 pradius + 1) at integer-floored
    corners.

    images (B, S, H, W, C); centers (B, S, N, 2) xy. Returns
    (patches (B, S, N, psize, psize, C), topleft (B, S, N, 2) the
    frame-clamped integer corners, to map patch coords back).
    """
    B, S, H, W, C = images.shape
    N = centers.shape[2]
    psize = 2 * pradius + 1
    topleft_raw = torch.floor(centers).long() - pradius
    tl_x = topleft_raw[..., 0].clamp(0, W - psize)
    tl_y = topleft_raw[..., 1].clamp(0, H - psize)
    patches = _gather_windows(images.reshape(B * S, H, W, C),
                              tl_x.reshape(B * S, N),
                              tl_y.reshape(B * S, N), psize)
    return (patches.reshape(B, S, N, psize, psize, C),
            torch.stack([tl_x, tl_y], dim=-1))


def ncc_subpixel_refine(images: torch.Tensor, coords: torch.Tensor,
                        search: int = 3, win: int = 3):
    """Classical NCC template-matching polish on raw pixels.

    For every track and frame, slide the query frame's (2 win + 1)^2 gray
    window over a +/- search integer grid around the rounded estimate,
    take the NCC argmax and parabola-fit it to sub-pixel. At the borders
    the JAX package's two branches are kept (its refine.py:187-206): where
    H % 8 == 0 and W % 128 == 0 the searched region is shifted inside the
    frame and the estimate re-centered on it; at other frame shapes each
    tap is clamped to the frame.

    images (B, S, H, W, 3) in [0, 1]; coords (B, S, N, 2), frame 0 the
    query (stays pinned). Returns (refined coords, peak NCC confidence
    (B, S, N) in [0, 1], 1 on the query frame).
    """
    B, S, H, W, _ = images.shape
    N = coords.shape[2]
    gray = (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])  # (B, S, H, W)
    wsz = 2 * win + 1
    gsz = wsz + 2 * search
    dev = coords.device

    # template: bilinear window at the fractional query position
    qxy = coords[:, 0]
    dy, dx = _window_grid(wsz, dev)
    tx = qxy[..., 0, None, None] + (dx - win)
    ty = qxy[..., 1, None, None] + (dy - win)
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    flat0 = gray[:, 0].reshape(B, H * W)

    def gather0(ix, iy):
        ixc = ix.long().clamp(0, W - 1)
        iyc = iy.long().clamp(0, H - 1)
        return torch.gather(flat0, 1, (iyc * W + ixc).reshape(B, -1)
                            ).reshape(B, N, wsz, wsz)

    tmpl = ((1 - fy) * ((1 - fx) * gather0(x0, y0)
                        + fx * gather0(x0 + 1, y0))
            + fy * ((1 - fx) * gather0(x0, y0 + 1)
                    + fx * gather0(x0 + 1, y0 + 1)))
    tmpl = tmpl.reshape(B, N, wsz * wsz)
    tmpl = tmpl - tmpl.mean(-1, keepdim=True)
    tmpl = tmpl * torch.rsqrt((tmpl * tmpl).sum(-1, keepdim=True) + 1e-8)

    base = torch.round(coords).long()
    if H % 8 == 0 and W % 128 == 0:
        tl_x = (base[..., 0] - (win + search)).clamp(0, W - gsz)
        tl_y = (base[..., 1] - (win + search)).clamp(0, H - gsz)
        region = _gather_windows(gray.reshape(B * S, H, W, 1),
                                 tl_x.reshape(B * S, N),
                                 tl_y.reshape(B * S, N),
                                 gsz)[..., 0].reshape(B, S, N, gsz, gsz)
        base = torch.stack([tl_x + win + search, tl_y + win + search],
                           dim=-1)
    else:
        gy, gx = _window_grid(gsz, dev)
        rx = (base[..., 0, None, None] + gx - (win + search)).clamp(0, W - 1)
        ry = (base[..., 1, None, None] + gy - (win + search)).clamp(0, H - 1)
        region = torch.gather(gray.reshape(B * S, H * W), 1,
                              (ry * W + rx).reshape(B * S, N * gsz * gsz)
                              ).reshape(B, S, N, gsz, gsz)

    osz = 2 * search + 1
    wins = region.unfold(3, wsz, 1).unfold(4, wsz, 1)  # (B,S,N,o,o,w,w)
    wins = wins.reshape(B, S, N, osz * osz, wsz * wsz)
    wins = wins - wins.mean(-1, keepdim=True)
    denom = torch.rsqrt((wins * wins).sum(-1) + 1e-8)
    ncc = torch.einsum("bnk,bsnok->bsno", tmpl, wins) * denom

    best = torch.argmax(ncc, dim=-1)
    by = best // osz
    bx = best % osz

    def val(dy_, dx_):
        yy = (by + dy_).clamp(0, osz - 1)
        xx = (bx + dx_).clamp(0, osz - 1)
        return torch.gather(ncc, -1, (yy * osz + xx)[..., None])[..., 0]

    sub_x, sub_y, c0 = subpixel_parabola(val)
    out = torch.stack([base[..., 0] + (bx - search) + sub_x,
                       base[..., 1] + (by - search) + sub_y], dim=-1)
    conf = c0.clamp(0.0, 1.0)
    conf[:, 0] = 1.0
    out[:, 0] = coords[:, 0]
    return out, conf


def refine_track(images, fine_fnet_apply, fine_tracker_apply, coarse_pred,
                 compute_score: bool = True, pradius: int = 15,
                 sradius: int = 2, fine_iters: int = 6,
                 matching_init: bool = False, subpixel_refine: bool = False,
                 patch_dtype=None, flat_fnet: bool = True):
    """Refine coarse tracks on local patches with the fine tracker.

    images (B, S, H, W, 3) in [0, 1]; coarse_pred (B, S, N, 2).
    fine_fnet_apply: (B', psize, psize, 3) -> (B', C, psize*psize) flat
      channel-first with `flat_fnet` (the runner's path), else NHWC
      (B', psize, psize, C) (the sharded step's path; the fine predictor
      then takes the channel-first pyramid).
    fine_tracker_apply: (query_points, fmaps, iters, return_feat,
      matching_init[, fmaps_flat_hw]) -> (coord_preds, vis, track_feats,
      query_feats); `fmaps_flat_hw` is passed on the flat path only.
    Returns (refined_tracks (B, S, N, 2), score (B, S, N) or None).
    """
    B, S, N, _ = coarse_pred.shape
    psize = 2 * pradius + 1
    img_for_patches = (images if patch_dtype is None
                       else images.to(patch_dtype))
    patches, topleft = extract_patches(img_for_patches, coarse_pred, pradius)
    # (B, S, N) -> (B, N, S): each track becomes its own short "video"
    patches = patches.permute(0, 2, 1, 3, 4, 5)
    track_frac = coarse_pred - torch.floor(coarse_pred)
    patch_query = (track_frac[:, 0] + pradius).reshape(B * N, 1, 2)

    pf = fine_fnet_apply(patches.reshape(B * N * S, psize, psize, 3))
    if flat_fnet:
        C_out = pf.shape[1]
        patch_feat = pf.reshape(B, N, S, C_out, psize * psize)
        patch_fmaps = pf.reshape(B * N, S, C_out, psize * psize)
        coord_preds, _, _, query_feat = fine_tracker_apply(
            patch_query, patch_fmaps, fine_iters, True, matching_init,
            (psize, psize))
    else:
        if pf.dim() != 4 or pf.shape[1:3] != (psize, psize):
            raise ValueError(f"flat_fnet=False takes NHWC patch features "
                             f"(B', {psize}, {psize}, C); got "
                             f"{tuple(pf.shape)}")
        C_out = pf.shape[-1]
        # (B*N, S, psize, psize, C): each track its own "video", a free
        # reshape in the (B, N, S) order
        patch_feat = pf.reshape(B, N, S, psize, psize, C_out)
        patch_fmaps = pf.reshape(B * N, S, psize, psize, C_out)
        coord_preds, _, _, query_feat = fine_tracker_apply(
            patch_query, patch_fmaps, fine_iters, True, matching_init)

    fine_patch_track = coord_preds[-1]  # (B*N, S, 1, 2) patch coords
    fine_level = fine_patch_track.reshape(B, N, S, 2).permute(0, 2, 1, 3)
    refined = fine_level + topleft
    refined[:, 0] = coarse_pred[:, 0]
    ncc_conf = None
    if subpixel_refine:
        refined, ncc_conf = ncc_subpixel_refine(images, refined)

    score = None
    if compute_score:
        if ncc_conf is not None:
            # weights-free mode: the NCC peak is the confidence
            score = ncc_conf
        else:
            score = compute_score_fn(query_feat, patch_feat,
                                     fine_patch_track, sradius, psize,
                                     B, N, S, C_out, flat=flat_fnet)
    return refined, score


def compute_score_fn(query_feat, patch_feat, fine_patch_track, sradius,
                     psize, B, N, S, C_out, flat: bool = True):
    """Confidence = spread (std) of the local similarity heatmap
    (reference refine_track.py:190-294, dsnt soft-argmax inlined).
    patch_feat arrives flat channel-first (B, N, S, C, psize*psize) with
    `flat`, else NHWC (B, N, S, psize, psize, C)."""
    ssize = 2 * sradius + 1
    dev = fine_patch_track.device
    centers = fine_patch_track.reshape(B, N, S, 2)
    tl = (torch.floor(centers).long() - sradius).clamp(0, psize - ssize)
    dy, dx = _window_grid(ssize, dev)
    ys = tl[..., 1, None, None] + dy
    xs = tl[..., 0, None, None] + dx
    qf = query_feat.reshape(B, N, C_out)
    if flat:
        idx = (ys * psize + xs).reshape(B, N, S, 1, ssize * ssize)
        windows = torch.gather(patch_feat, 4,
                               idx.expand(-1, -1, -1, C_out, -1))
        sim = torch.einsum("bnc,bnscr->bnsr", qf, windows[:, :, 1:])
    else:
        idx = (ys * psize + xs).reshape(B, N, S, ssize * ssize, 1)
        windows = torch.gather(
            patch_feat.reshape(B, N, S, psize * psize, C_out), 3,
            idx.expand(-1, -1, -1, -1, C_out))
        sim = torch.einsum("bnc,bnsrc->bnsr", qf, windows[:, :, 1:])
    heat = torch.softmax(sim.float() / C_out ** 0.5, dim=-1)

    lin = torch.linspace(-1.0, 1.0, ssize, device=dev)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(ssize * ssize, 2)
    mean = heat @ grid
    second = heat @ grid ** 2
    var = second - mean ** 2
    std = torch.sqrt(var.clamp(min=1e-10)).sum(-1).permute(0, 2, 1)
    return torch.cat([torch.ones_like(std[:, :1]), std], dim=1)
