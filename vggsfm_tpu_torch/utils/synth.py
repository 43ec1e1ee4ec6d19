"""Synthetic multi-plane scenes with planted cameras (geometric oracle),
numpy only. A copy of vggsfm_tpu/utils/synth.py's `render_two_plane_scene`
with `_value_noise`, `_rot_y` and `_warp_plane`, so the port does not
import the JAX package.

Each view is an exact inverse-homography warp of textured fronto-parallel
planes at two depths, so the planted extrinsics/intrinsics are ground
truth that a correct pipeline must recover (up to the global similarity
gauge). Two planes at different depths give true parallax: a single
plane would be a degenerate (homography) configuration for
fundamental-matrix estimation.
"""

from __future__ import annotations

import numpy as np


def _value_noise(rng: np.random.Generator, size: int,
                 octaves: int = 7) -> np.ndarray:
    """Multi-octave value noise in [0, 1], (size, size, 3).

    Spectrum shaping matters twice over: blob/corner detectors need
    energy at fine scales (2-4 px) or the keypoint yield collapses, while
    correlation matching on stride-8 feature maps needs the *dominant*
    energy at coarse scales (a flat spectrum turns the texture into
    self-similar speckle that aliases away at the fmap resolution and
    mismatches everywhere). A 1/f rolloff down to 1-2 px cells serves
    both: photographs have the same spectrum.
    """
    img = np.zeros((size, size, 3), np.float32)
    amp_total = 0.0
    for o in range(octaves):
        cells = min(size, max(2, size // (2 ** (octaves - o))))
        amp = 1.0 / (o + 1)
        coarse = rng.uniform(size=(cells, cells, 3)).astype(np.float32)
        # bilinear upsample to full size
        ys = np.linspace(0, cells - 1, size)
        xs = np.linspace(0, cells - 1, size)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, cells - 1)
        x1 = np.minimum(x0 + 1, cells - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        up = ((1 - wy) * ((1 - wx) * coarse[y0][:, x0]
                          + wx * coarse[y0][:, x1])
              + wy * ((1 - wx) * coarse[y1][:, x0]
                      + wx * coarse[y1][:, x1]))
        img += amp * up
        amp_total += amp
    img /= amp_total
    # stretch contrast so detectors find strong structure
    img = np.clip((img - 0.5) * 2.2 + 0.5, 0.0, 1.0)

    # scatter distinctive high-contrast shapes ("confetti"): pure value
    # noise is maximally self-similar — wrong correspondences still
    # correlate strongly, which no real photograph exhibits. Random
    # ellipses/rectangles give the texture unique, trackable landmarks
    # with photographic local-distinctiveness.
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
        # moderate blend: the shape is a distinctive landmark but the
        # fine-scale noise stays visible inside it (a flat interior would
        # starve NCC/feature matching of local texture)
        alpha = float(rng.uniform(0.25, 0.5))
        region = img[y0:y0 + h, x0:x0 + w]
        region[mask] = (1 - alpha) * region[mask] + alpha * color
    return img


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _warp_plane(texture: np.ndarray, H_img_from_tex: np.ndarray,
                out_size: int):
    """Inverse-warp `texture` by the tex->image homography.

    Returns (image (R, R, 3), coverage mask (R, R)) — mask is False where
    the pixel's ray misses the texture extent.
    """
    T = texture.shape[0]
    Hinv = np.linalg.inv(H_img_from_tex)
    xs, ys = np.meshgrid(np.arange(out_size), np.arange(out_size),
                         indexing="xy")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    tex = pix @ Hinv.T
    u = tex[:, 0] / tex[:, 2]
    v = tex[:, 1] / tex[:, 2]
    ok = (u >= 0) & (u <= T - 1) & (v >= 0) & (v <= T - 1) & (tex[:, 2] != 0)
    u = np.clip(u, 0, T - 1)
    v = np.clip(v, 0, T - 1)
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    u1 = np.minimum(u0 + 1, T - 1)
    v1 = np.minimum(v0 + 1, T - 1)
    wu = (u - u0)[:, None]
    wv = (v - v0)[:, None]
    img = ((1 - wv) * ((1 - wu) * texture[v0, u0] + wu * texture[v0, u1])
           + wv * ((1 - wu) * texture[v1, u0] + wu * texture[v1, u1]))
    return (img.reshape(out_size, out_size, 3),
            ok.reshape(out_size, out_size))


def render_two_plane_scene(num_frames: int = 8, image_size: int = 1024,
                           seed: int = 0, baseline: float = 0.06,
                           z_fg: float = 2.0, z_bg: float = 4.0,
                           fg_half_extent_frac: float = 0.35):
    """Render S views of two textured fronto-parallel planes.

    The camera translates along x (total baseline `baseline * (S-1)`) with a
    small compensating yaw so the scene stays centered. Background plane at
    z_bg fills every view; a foreground square at z_fg covers the image
    center and provides parallax against the background.

    Returns dict:
      ``images``     (S, R, R, 3) float32 in [0, 1]
      ``extrinsics`` (S, 3, 4) world->cam OpenCV (planted ground truth)
      ``intrinsics`` (S, 3, 3) (focal = R, pp = R/2)
    """
    S, R = num_frames, image_size
    rng = np.random.default_rng(seed)
    f = float(R)
    K = np.array([[f, 0, R / 2.0], [0, f, R / 2.0], [0, 0, 1]], np.float64)

    # camera centers and small inward yaw
    centers = np.zeros((S, 3))
    centers[:, 0] = (np.arange(S) - (S - 1) / 2.0) * baseline
    centers[:, 1] = (rng.uniform(size=S) - 0.5) * 0.2 * baseline
    z_mid = 0.5 * (z_fg + z_bg)
    extrinsics = np.zeros((S, 3, 4))
    for s in range(S):
        yaw = -0.5 * np.arctan2(centers[s, 0], z_mid)
        Rm = _rot_y(yaw)
        extrinsics[s, :, :3] = Rm
        extrinsics[s, :, 3] = -Rm @ centers[s]

    # plane extents sized so the background covers every view
    max_off = abs(centers[:, 0]).max()
    half_bg = 0.75 * z_bg + max_off + 0.3
    half_fg = fg_half_extent_frac * z_fg

    def plane_setup(z, half, texel_per_unit):
        T = int(2 * half * texel_per_unit)
        # tex->world affine for [u, v, 1] -> [X, Y, 1] on the plane
        sxy = 2 * half / (T - 1)
        A = np.array([[sxy, 0, -half], [0, sxy, -half], [0, 0, 1]],
                     np.float64)
        return T, A, z

    T_bg, A_bg, _ = plane_setup(z_bg, half_bg, R / z_bg)
    T_fg, A_fg, _ = plane_setup(z_fg, half_fg, R / z_fg)
    tex_bg = _value_noise(rng, T_bg)
    tex_fg = _value_noise(rng, T_fg)

    images = np.zeros((S, R, R, 3), np.float32)
    for s in range(S):
        Rm = extrinsics[s, :, :3]
        t = extrinsics[s, :, 3]

        def img_from_tex(A, z):
            # plane [X, Y, 1] -> image: K [r1 r2 (r3*z + t)]
            Hp = K @ np.column_stack([Rm[:, 0], Rm[:, 1], Rm[:, 2] * z + t])
            return Hp @ A

        bg, _ = _warp_plane(tex_bg, img_from_tex(A_bg, z_bg), R)
        fg, fg_mask = _warp_plane(tex_fg, img_from_tex(A_fg, z_fg), R)
        out = np.where(fg_mask[..., None], fg, bg)
        images[s] = out.astype(np.float32)

    return {
        "images": images,
        "extrinsics": extrinsics.astype(np.float32),
        "intrinsics": np.broadcast_to(K.astype(np.float32),
                                      (S, 3, 3)).copy(),
    }


def write_scene_folder(scene: dict, out_dir: str, seed: int = 0) -> list:
    """A rendered scene as a scene folder, as examples/render_scene.py
    writes one: OUT/images/frame_%04d.png (8-bit, Pillow) and the planted
    cameras as a COLMAP model under OUT/sparse/0, with 64 seeded scene
    points so the model is well-formed. Returns the image names."""
    import os

    from PIL import Image

    from vggsfm_tpu_torch.io import arrays_to_reconstruction, write_model

    images = scene["images"]
    S, size = images.shape[:2]
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    names = []
    for i, im in enumerate(images):
        name = f"frame_{i:04d}.png"
        Image.fromarray((im * 255).astype(np.uint8)).save(
            os.path.join(img_dir, name))
        names.append(name)
    extr = scene["extrinsics"].astype(np.float64)
    intr = scene["intrinsics"].astype(np.float64)
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-1.0, 1.0, 64),
                           rng.uniform(-1.0, 1.0, 64),
                           rng.uniform(2.0, 4.0, 64)])
    tracks = np.zeros((S, len(pts), 2))
    for s in range(S):
        uv = (intr[s] @ ((extr[s, :, :3] @ pts.T).T + extr[s, :, 3]).T).T
        tracks[s] = uv[:, :2] / uv[:, 2:]
    inb = ((tracks >= 0) & (tracks < size)).all(axis=-1)
    rec = arrays_to_reconstruction(pts, extr, intr, tracks, inb,
                                   (size, size), image_names=names)
    write_model(rec, os.path.join(out_dir, "sparse", "0"), ext=".bin")
    return names
