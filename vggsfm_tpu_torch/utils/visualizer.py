"""Track visualization: PNG frames, an animated GIF and an mp4 video.
Counterpart of vggsfm_tpu/utils/visualizer.py (reference
vggsfm/utils/visualizer.py:62-371, which draws the tracked points on each
frame and writes an mp4): frames render through numpy and PIL with
rainbow-indexed track colors, export as per-frame PNGs and an animated
GIF, and, when OpenCV's VideoWriter has a working codec (mp4v; MJPG .avi
as fallback), as the reference's mp4 too. Also the reprojection overlay
of the reference's utils/utils.py:428-571: projected 3D points drawn
against their 2D tracks, projected with the port's `project_points` on
the host's arrays.

Inputs are host arrays (numpy); the runner passes the copy it already
made for the export. The frames of one call are encoded in threads
(Pillow's PNG encoder and its quantizer release the interpreter lock):
the files are the ones a serial loop writes, at a fraction of its time
on 1024-px frames.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# threads that encode the frames of one call
WORKERS = min(8, os.cpu_count() or 1)


def save_pngs(frames: list, paths: list) -> None:
    """Each RGB uint8 frame to its PNG path, in threads."""
    from PIL import Image

    with ThreadPoolExecutor(WORKERS) as ex:
        list(ex.map(lambda f, p: Image.fromarray(f).save(p), frames, paths))


def save_gif(frames: list, path: str) -> None:
    """An animated GIF of RGB uint8 frames, 200 ms each, looping. Each
    frame is quantized in a thread to an adaptive palette, which is what
    Pillow's GIF writer does to an RGB frame, so the file is the one that
    saving the RGB frames writes."""
    from PIL import Image

    with ThreadPoolExecutor(WORKERS) as ex:
        pal = list(ex.map(lambda f: Image.fromarray(f).convert(
            "P", palette=Image.Palette.ADAPTIVE), frames))
    pal[0].save(path, save_all=True, append_images=pal[1:], duration=200,
                loop=0)


def write_video(frames: list, path: str, fps: int = 5) -> str | None:
    """Encode RGB uint8 frames to video via cv2.VideoWriter.

    Tries the container/codec implied by `path` (mp4 -> mp4v), falls
    back to MJPG .avi, returns the written path or None when no codec
    is available (callers always also have PNG/GIF outputs).
    """
    if not frames:
        return None
    try:
        import cv2
    except ImportError:
        return None
    h, w = frames[0].shape[:2]
    candidates = [(path, "mp4v" if path.endswith(".mp4") else "MJPG")]
    if path.endswith(".mp4"):
        candidates.append((path[:-4] + ".avi", "MJPG"))
    for p, codec in candidates:
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*codec), fps,
                             (w, h))
        if not vw.isOpened():
            continue
        for f in frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
        vw.release()
        return p
    return None


def _colormap(n: int) -> np.ndarray:
    """(n, 3) uint8 rainbow colors by track index."""
    t = np.linspace(0.0, 1.0, max(n, 2))
    r = np.clip(1.5 - np.abs(3 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(3 * t - 0.75) * 2, 0, 1)
    b = np.clip(1.5 - np.abs(3 * t) * 2 + 1.0, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def draw_points(image: np.ndarray, xy: np.ndarray, colors: np.ndarray,
                radius: int = 2, valid: np.ndarray | None = None):
    """Stamp colored squares at xy on a copy of (H, W, 3) uint8 image."""
    out = image.copy()
    H, W = out.shape[:2]
    if valid is None:
        valid = np.ones(len(xy), bool)
    for (x, y), c, ok in zip(np.asarray(xy), colors, valid):
        if not ok:
            continue
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            y0, y1 = max(0, yi - radius), min(H, yi + radius + 1)
            x0, x1 = max(0, xi - radius), min(W, xi + radius + 1)
            out[y0:y1, x0:x1] = c
    return out


def visualize_query_points(image: np.ndarray, xy: np.ndarray,
                           path: str, valid: np.ndarray | None = None,
                           radius: int = 4):
    """Save one frame with its extracted query points stamped green.

    Parity: utils/utils.py:311-338 (`visual_query_points` — the
    reference's cv2.circle debug overlay; squares here, no cv2 in-env).
    `image` is (H, W, 3) float [0,1] or uint8; `xy` is (N, 2) pixels.
    """
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
    colors = np.tile(np.array([[0, 255, 0]], np.uint8), (len(xy), 1))
    out = draw_points(img, xy, colors, radius=radius, valid=valid)
    Image.fromarray(out).save(path)
    return path


def visualize_tracks(images: np.ndarray, tracks: np.ndarray,
                     visibility: np.ndarray | None, output_dir: str,
                     prefix: str = "tracks", gif: bool = True,
                     max_tracks: int = 256) -> list:
    """Render tracked points over every frame.

    Args:
      images: (S, H, W, 3) float [0,1] or uint8.
      tracks: (S, N, 2); visibility: optional (S, N).

    Writes `<prefix>_####.png` per frame, `<prefix>.gif`, and
    `<prefix>.mp4` (reference parity, visualizer.py:87-135; skipped only
    if no cv2 codec works); returns the written paths.
    """
    os.makedirs(output_dir, exist_ok=True)
    imgs = np.asarray(images)
    if imgs.dtype != np.uint8:
        imgs = np.clip(imgs * 255, 0, 255).astype(np.uint8)
    S, H, W, _ = imgs.shape
    N = min(tracks.shape[1], max_tracks)
    colors = _colormap(N)

    paths = []
    frames = []
    for s in range(S):
        valid = None
        if visibility is not None:
            valid = np.asarray(visibility[s, :N]) > 0.05
        frames.append(draw_points(imgs[s], tracks[s, :N], colors,
                                  valid=valid))
        paths.append(os.path.join(output_dir, f"{prefix}_{s:04d}.png"))
    save_pngs(frames, paths)
    if gif and frames:
        gp = os.path.join(output_dir, f"{prefix}.gif")
        save_gif(frames, gp)
        paths.append(gp)
    vp = write_video(frames, os.path.join(output_dir, f"{prefix}.mp4"))
    if vp:
        paths.append(vp)
    return paths


def visualize_reprojections(images: np.ndarray, tracks: np.ndarray,
                            points3d: np.ndarray, extrinsics: np.ndarray,
                            intrinsics: np.ndarray, valid_tracks: np.ndarray,
                            output_dir: str, extra_params=None) -> list:
    """Overlay observed tracks (colored) and reprojected 3D points (white).

    Parity: utils/utils.py:428-571 (`create_video_with_reprojections`).
    `extra_params` (radial distortion) must be passed for SIMPLE_RADIAL
    models — the observations live in distorted pixel space.
    """
    import torch

    from vggsfm_tpu_torch.geometry.cameras import project_points

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32))

    proj = project_points(
        f32(points3d), f32(extrinsics), f32(intrinsics),
        extra_params=None if extra_params is None else f32(extra_params),
    ).numpy()
    imgs = np.asarray(images)
    if imgs.dtype != np.uint8:
        imgs = np.clip(imgs * 255, 0, 255).astype(np.uint8)
    S = imgs.shape[0]
    N = min(tracks.shape[1], 256)
    colors = _colormap(N)
    white = np.full((N, 3), 255, np.uint8)

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    frames = []
    for s in range(S):
        frame = draw_points(imgs[s], tracks[s, :N], colors,
                            valid=np.asarray(valid_tracks[:N]))
        frames.append(draw_points(frame, proj[s, :N], white, radius=1,
                                  valid=np.asarray(valid_tracks[:N])))
        paths.append(os.path.join(output_dir, f"reproj_{s:04d}.png"))
    save_pngs(frames, paths)
    # the reference's reprojection VIDEO (utils/utils.py:428-571)
    vp = write_video(frames, os.path.join(output_dir, "reproj.mp4"))
    if vp:
        paths.append(vp)
    return paths
