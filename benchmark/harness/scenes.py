"""Synthetic scenes with planted cameras: a frozen copy of the port's
`utils/synth.render_two_plane_scene`, with the heavy parts on the device.

The random draws are numpy's, in the original's order, so a scene is the
same for the same seed as the original's; the value-noise upsampling and
the per-view plane warps (the original's cost: 21.6 s on the host for 144
frames at 512 px) run in torch on the device, the warps in float64 as the
original computes them. The confetti shapes are blended on the host in
float32, in order, as in the original.

Each view warps two textured fronto-parallel planes at depths z_fg and
z_bg; the planted extrinsics and intrinsics are ground truth.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _confetti(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    size = img.shape[0]
    n_shapes = max(24, (size * size) // 1500)
    smax = max(6, min(48, size // 6))
    for _ in range(n_shapes):
        w = int(rng.uniform(3, smax))
        h = int(rng.uniform(3, smax))
        x0 = int(rng.integers(0, size - w))
        y0 = int(rng.integers(0, size - h))
        color = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        if rng.uniform() < 0.5:
            mask = ((xx - w / 2) ** 2 / (w / 2) ** 2
                    + (yy - h / 2) ** 2 / (h / 2) ** 2) <= 1.0
        else:
            mask = np.ones((h, w), bool)
        alpha = float(rng.uniform(0.25, 0.5))
        region = img[y0:y0 + h, x0:x0 + w]
        region[mask] = (1 - alpha) * region[mask] + alpha * color
    return img


def value_noise(rng: np.random.Generator, size: int, device,
                octaves: int = 7) -> np.ndarray:
    """Multi-octave value noise in [0, 1] with confetti, (size, size, 3)
    float32 on the host. Each octave's grid is drawn on the host and
    upsampled on the device (align_corners bilinear = the original's
    linspace sampling)."""
    img = torch.zeros((3, size, size), dtype=torch.float32, device=device)
    amp_total = 0.0
    for o in range(octaves):
        cells = min(size, max(2, size // (2 ** (octaves - o))))
        amp = 1.0 / (o + 1)
        coarse = rng.uniform(size=(cells, cells, 3)).astype(np.float32)
        grid = torch.from_numpy(coarse).to(device).permute(2, 0, 1)[None]
        img += amp * F.interpolate(grid.double(), size=(size, size),
                                   mode="bilinear",
                                   align_corners=True)[0].float()
        amp_total += amp
    img /= amp_total
    img = ((img - 0.5) * 2.2 + 0.5).clamp(0.0, 1.0)
    return _confetti(rng, img.permute(1, 2, 0).contiguous().cpu().numpy())


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _warp(texture: torch.Tensor, H_img_from_tex: np.ndarray, out_size: int):
    """Inverse-warp a (T, T, 3) texture by the tex -> image homography:
    (image (R, R, 3) float64, coverage mask (R, R))."""
    T = texture.shape[0]
    dev = texture.device
    Hinv = torch.from_numpy(np.linalg.inv(H_img_from_tex)).to(dev)
    r = torch.arange(out_size, device=dev, dtype=torch.float64)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    tex = pix @ Hinv.T
    u = tex[:, 0] / tex[:, 2]
    v = tex[:, 1] / tex[:, 2]
    ok = (u >= 0) & (u <= T - 1) & (v >= 0) & (v <= T - 1) & (tex[:, 2] != 0)
    u = u.clamp(0, T - 1)
    v = v.clamp(0, T - 1)
    u0 = u.floor().long()
    v0 = v.floor().long()
    u1 = (u0 + 1).clamp(max=T - 1)
    v1 = (v0 + 1).clamp(max=T - 1)
    wu = (u - u0)[:, None]
    wv = (v - v0)[:, None]
    t = texture.double()
    img = ((1 - wv) * ((1 - wu) * t[v0, u0] + wu * t[v0, u1])
           + wv * ((1 - wu) * t[v1, u0] + wu * t[v1, u1]))
    return (img.reshape(out_size, out_size, 3),
            ok.reshape(out_size, out_size))


def render_two_plane_scene(num_frames: int, image_size: int, seed: int,
                           device, baseline: float = 0.06,
                           z_fg: float = 2.0, z_bg: float = 4.0,
                           fg_half_extent_frac: float = 0.35) -> dict:
    """S views of two textured planes, the camera translating along x with
    a small inward yaw. Returns ``images`` (S, R, R, 3) float32 in [0, 1]
    on `device`, ``extrinsics`` (S, 3, 4) world -> camera (OpenCV) and
    ``intrinsics`` (S, 3, 3) float32 numpy (focal R, principal point
    R / 2)."""
    S, R = num_frames, image_size
    rng = np.random.default_rng(seed)
    f = float(R)
    K = np.array([[f, 0, R / 2.0], [0, f, R / 2.0], [0, 0, 1]], np.float64)
    centers = np.zeros((S, 3))
    centers[:, 0] = (np.arange(S) - (S - 1) / 2.0) * baseline
    centers[:, 1] = (rng.uniform(size=S) - 0.5) * 0.2 * baseline
    z_mid = 0.5 * (z_fg + z_bg)
    extrinsics = np.zeros((S, 3, 4))
    for s in range(S):
        Rm = _rot_y(-0.5 * np.arctan2(centers[s, 0], z_mid))
        extrinsics[s, :, :3] = Rm
        extrinsics[s, :, 3] = -Rm @ centers[s]

    max_off = abs(centers[:, 0]).max()
    half_bg = 0.75 * z_bg + max_off + 0.3
    half_fg = fg_half_extent_frac * z_fg

    def plane(half, texel_per_unit):
        T = int(2 * half * texel_per_unit)
        sxy = 2 * half / (T - 1)
        A = np.array([[sxy, 0, -half], [0, sxy, -half], [0, 0, 1]],
                     np.float64)
        return T, A

    T_bg, A_bg = plane(half_bg, R / z_bg)
    T_fg, A_fg = plane(half_fg, R / z_fg)
    tex_bg = torch.from_numpy(value_noise(rng, T_bg, device)).to(device)
    tex_fg = torch.from_numpy(value_noise(rng, T_fg, device)).to(device)

    images = torch.empty((S, R, R, 3), dtype=torch.float32, device=device)
    for s in range(S):
        Rm = extrinsics[s, :, :3]
        t = extrinsics[s, :, 3]

        def img_from_tex(A, z):
            Hp = K @ np.column_stack([Rm[:, 0], Rm[:, 1], Rm[:, 2] * z + t])
            return Hp @ A

        bg, _ = _warp(tex_bg, img_from_tex(A_bg, z_bg), R)
        fg, fg_mask = _warp(tex_fg, img_from_tex(A_fg, z_fg), R)
        images[s] = torch.where(fg_mask[..., None], fg, bg).float()
    return {
        "images": images,
        "extrinsics": extrinsics.astype(np.float32),
        "intrinsics": np.broadcast_to(K.astype(np.float32),
                                      (S, 3, 3)).copy(),
    }


def as_loaded(images: torch.Tensor) -> np.ndarray:
    """Frames in the form the demo loader hands the runner: (S, R, R, 3)
    float32 numpy in [0, 1], quantized to 8 bits as an image file is."""
    return (torch.round(images * 255.0) / 255.0).cpu().numpy()
