"""Scene-folder loader: sorted images (+optional masks) -> dense batch.
Counterpart of vggsfm_tpu/datasets/demo_loader.py (reference
vggsfm/datasets/demo_loader.py:35-483): center square-crop to the longest
side, Pillow bilinear resize to `img_size` (1024 default), 8-vector crop
parameters [W, H, crop_width, s, bbox_after(4)], optional binary masks
from `masks/`, optional COLMAP ground truth from `sparse/0` (read with
the port's COLMAP reader). Outputs are channels-last numpy arrays; the
runner moves them to its device.
"""

from __future__ import annotations

import os

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp")


def _crop_square_longest(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Center-crop/pad to a square with side max(H, W); returns (sq, bbox)."""
    h, w = arr.shape[:2]
    dim = max(h, w)
    top = (h - dim) // 2
    left = (w - dim) // 2
    bbox = np.array([left, top, left + dim, top + dim], np.float64)
    out = np.zeros((dim, dim) + arr.shape[2:], arr.dtype)
    ys = max(0, -top)
    xs = max(0, -left)
    out[ys: ys + h, xs: xs + w] = arr
    return out, bbox


def _resize(arr: np.ndarray, size: int) -> np.ndarray:
    img = Image.fromarray(arr)
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img)


def crop_parameters(width, height, bbox, crop_dim, img_size) -> np.ndarray:
    """8-vector crop params. Parity: demo_loader.py:399-434."""
    length = max(width, height)
    s = length / min(width, height)
    crop_width = 2 * s * (bbox[2] - bbox[0]) / length
    bbox_after = np.asarray(bbox, np.float64) / crop_dim * img_size
    return np.array([width, height, crop_width, s, *bbox_after], np.float32)


def pad_and_resize_image(image: np.ndarray, img_size: int,
                         mask: np.ndarray | None = None):
    """(H, W, 3) uint8 -> ((img_size, img_size, 3) float32 in [0,1],
    mask or None, crop_params (8,))."""
    h, w = image.shape[:2]
    sq, bbox = _crop_square_longest(image)
    crop_dim = sq.shape[0]
    out = _resize(sq, img_size).astype(np.float32) / 255.0
    params = crop_parameters(w, h, bbox, crop_dim, img_size)
    mask_out = None
    if mask is not None:
        msq, _ = _crop_square_longest(mask)
        mask_out = _resize(msq, img_size).astype(np.float32) / 255.0
    return out, mask_out, params


class DemoLoader:
    """Load a scene directory: `images/` (or bare image files) + `masks/`.

    Attributes after construction: ``image_paths``; `load()` returns a dict
    with ``images (S, R, R, 3)``, ``masks (S, R, R) or None``,
    ``crop_params (S, 8)``, ``original_images`` dict, ``image_names``.
    """

    def __init__(self, scene_dir: str, img_size: int = 1024,
                 load_gt: bool = False):
        if Image is None:
            raise ImportError("PIL is required for DemoLoader")
        self.scene_dir = scene_dir
        self.img_size = img_size
        self.load_gt = load_gt

        img_dir = os.path.join(scene_dir, "images")
        if not os.path.isdir(img_dir):
            img_dir = scene_dir
        self.image_paths = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith(_IMG_EXTS))
        if not self.image_paths:
            raise FileNotFoundError(f"no images found under {scene_dir}")

        mask_dir = os.path.join(scene_dir, "masks")
        self.mask_paths = None
        if os.path.isdir(mask_dir):
            masks = sorted(
                os.path.join(mask_dir, f) for f in os.listdir(mask_dir)
                if f.lower().endswith(_IMG_EXTS))
            if len(masks) == len(self.image_paths):
                self.mask_paths = masks

    def __len__(self):
        return len(self.image_paths)

    def load(self) -> dict:
        images, masks, params, originals = [], [], [], {}
        for i, path in enumerate(self.image_paths):
            raw = np.asarray(Image.open(path).convert("RGB"))
            originals[os.path.basename(path)] = raw
            mask = None
            if self.mask_paths is not None:
                mask = np.asarray(
                    Image.open(self.mask_paths[i]).convert("L"))
            img, msk, par = pad_and_resize_image(raw, self.img_size, mask)
            images.append(img)
            params.append(par)
            if msk is not None:
                masks.append(msk)

        out = {
            "images": np.stack(images),
            "crop_params": np.stack(params),
            "masks": np.stack(masks) if masks else None,
            "original_images": originals,
            "image_names": [os.path.basename(p) for p in self.image_paths],
            "scene_dir": self.scene_dir,
        }
        if self.load_gt:
            out["gt"] = self._load_colmap_gt()
        return out

    def _load_colmap_gt(self):
        from vggsfm_tpu_torch.io.colmap import read_model

        sparse = os.path.join(self.scene_dir, "sparse", "0")
        if not os.path.isdir(sparse):
            sparse = os.path.join(self.scene_dir, "sparse")
        if not os.path.isdir(sparse):
            return None
        from vggsfm_tpu_torch.io.bridge import reconstruction_to_arrays

        rec = read_model(sparse)
        pts, extr, intr, extra, _ = reconstruction_to_arrays(rec)
        names = [rec.images[i].name for i in sorted(rec.images)]
        return {"extrinsics": extr, "intrinsics": intr, "points": pts,
                "extra_params": extra, "image_names": names}
