"""Positional embeddings. Counterpart of vggsfm_tpu/models/embeddings.py
(reference vggsfm/models/utils.py:204-344)."""

from __future__ import annotations

import torch


def get_1d_sincos_pos_embed_from_grid(embed_dim: int,
                                      pos: torch.Tensor) -> torch.Tensor:
    """(M,) positions -> (M, D) [sin | cos] embedding."""
    omega = (torch.arange(embed_dim // 2, dtype=torch.float32,
                          device=pos.device) / (embed_dim / 2.0))
    omega = 1.0 / 10000 ** omega
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size,
                            device=None) -> torch.Tensor:
    """(1, H, W, D) 2D sincos embedding grid (NHWC)."""
    if isinstance(grid_size, tuple):
        gh, gw = grid_size
    else:
        gh = gw = grid_size
    grid_h, grid_w = torch.meshgrid(
        torch.arange(gh, dtype=torch.float32, device=device),
        torch.arange(gw, dtype=torch.float32, device=device),
        indexing="ij")
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid_w)
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid_h)
    emb = torch.cat([emb_h, emb_w], dim=1)
    return emb.reshape(1, gh, gw, embed_dim)


def get_2d_embedding(xy: torch.Tensor, C: int,
                     cat_coords: bool = True) -> torch.Tensor:
    """Per-point sin/cos embedding of 2D coords, (..., 2) -> (..., 2C):
    the reference's linear frequency ladder ``arange(0, C, 2) * (1000/C)``,
    sin at even and cos at odd channels."""
    x = xy[..., 0:1]
    y = xy[..., 1:2]
    div_term = (torch.arange(0, C, 2, dtype=torch.float32,
                             device=xy.device) * (1000.0 / C))[None, :]
    pe_x = torch.stack([torch.sin(x * div_term), torch.cos(x * div_term)],
                       dim=-1).reshape(*xy.shape[:-1], C)
    pe_y = torch.stack([torch.sin(y * div_term), torch.cos(y * div_term)],
                       dim=-1).reshape(*xy.shape[:-1], C)
    pe = torch.cat([pe_x, pe_y], dim=-1)
    if cat_coords:
        pe = torch.cat([xy, pe], dim=-1)
    return pe


def harmonic_embedding(x: torch.Tensor, n_harmonic_functions: int = 10,
                       omega_0: float = 1.0, logspace: bool = True,
                       append_input: bool = False) -> torch.Tensor:
    """[sin(2^k w x) | cos(2^k w x)] harmonic embedding, (..., D) ->
    (..., 2 D n) (+ D with `append_input`); the camera's PoseEmbedding
    (reference minipytorch3d/harmonic_embedding.py)."""
    if logspace:
        freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=torch.float32,
                                    device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_harmonic_functions - 1),
                               n_harmonic_functions, dtype=torch.float32,
                               device=x.device)
    embed = (x[..., None] * (freqs * omega_0)).reshape(
        *x.shape[:-1], x.shape[-1] * n_harmonic_functions)
    out = [torch.sin(embed), torch.cos(embed)]
    if append_input:
        out.append(x)
    return torch.cat(out, dim=-1)
