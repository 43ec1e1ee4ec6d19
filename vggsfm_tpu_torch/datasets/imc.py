"""IMC phototourism benchmark dataset and evaluation harness (host-side,
numpy, with the scoring in PyTorch). Counterpart of
vggsfm_tpu/datasets/imc.py (reference vggsfm/datasets/imc.py:36-199: bag
lists, per-image calibration from h5; the AUC of
vggsfm/utils/metric.py:107-218 is the port's `geometry.metrics`). h5py is
optional: calibrations also load from .npz files with the same keys (K,
R, T), and without h5py the writers fall back to .npz.

Directory layout (IMC 2020 phototourism):
    <IMC_DIR>/<location>/set_100/sub_set/<bag>.txt   image lists
    <IMC_DIR>/<location>/set_100/images/*.jpg
    <IMC_DIR>/<location>/set_100/calibration/calibration_<name>.h5
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from vggsfm_tpu_torch.datasets.demo_loader import pad_and_resize_image

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def load_calibration(path: str) -> dict:
    """Read a calibration file (.h5 through h5py, or .npz) -> {K, R, T}."""
    if path.endswith(".npz"):
        data = np.load(path)
        return {k: np.asarray(data[k]) for k in ("K", "R", "T")}
    if h5py is None:
        raise ImportError("h5py required for .h5 calibration files")
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in ("K", "R", "T")}


def parse_bag_list(bag_file: str, root: str) -> list:
    """The image paths of a bag list, each joined to `root`."""
    out = []
    with open(bag_file) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(os.path.join(root, line))
    return out


class IMCDataset:
    """IMC bags: per-bag image paths and GT cameras.

    `sequences` maps a bag name ("<bag>_<location>") to a list of
    {filepath, R, T, K}.
    """

    def __init__(self, imc_dir: str, img_size: int = 1024,
                 exclude_london_bridge: bool = False,
                 calib_ext: str = ".h5"):
        self.img_size = img_size
        self.sequences = {}
        bag_files = sorted(glob.glob(
            os.path.join(imc_dir, "*/set_100/sub_set/*.txt")))
        if exclude_london_bridge:
            bag_files = [b for b in bag_files if "london_bridge" not in b]
        for bag_file in bag_files:
            parts = bag_file.split("/")
            location = parts[-4]
            bag_info = os.path.splitext(parts[-1])[0]
            name = f"{bag_info}_{location}"
            root = "/".join(parts[:-2])
            entries = []
            for img_path in parse_bag_list(bag_file, root):
                base = os.path.splitext(os.path.basename(img_path))[0]
                calib_path = os.path.join(
                    os.path.dirname(img_path).replace("images",
                                                      "calibration"),
                    f"calibration_{base}{calib_ext}")
                calib = load_calibration(calib_path)
                entries.append({
                    "filepath": img_path,
                    "R": np.asarray(calib["R"], np.float64),
                    "T": np.asarray(calib["T"], np.float64).reshape(3),
                    "K": np.asarray(calib["K"], np.float64),
                })
            if entries:
                self.sequences[name] = entries

    def sequence_names(self):
        return sorted(self.sequences)

    def load_bag(self, name: str) -> dict:
        """A bag's images (square crop, resize) and GT cameras, the
        extrinsics relative to frame 0 (the pipeline's convention), the
        intrinsics in the original pixels and in the model input's."""
        from PIL import Image

        from vggsfm_tpu_torch.datasets.camera_transform import (
            adjust_intrinsics_from_crop_params,
            first_camera_transform,
        )

        entries = self.sequences[name]
        images, params, extr, intr = [], [], [], []
        for e in entries:
            raw = np.asarray(Image.open(e["filepath"]).convert("RGB"))
            img, _, par = pad_and_resize_image(raw, self.img_size)
            images.append(img)
            params.append(par)
            extr.append(np.concatenate([e["R"], e["T"][:, None]], axis=1))
            intr.append(e["K"])
        params = np.stack(params)
        extr, _ = first_camera_transform(np.stack(extr))
        intr = np.stack(intr)
        # the GT intrinsics moved as the loader's crop and resize move the
        # pixels (the reference's adjust_camera_to_bbox_crop_ /
        # adjust_camera_to_image_scale_ chain)
        intr_resized = adjust_intrinsics_from_crop_params(
            intr, params, self.img_size)
        return {
            "images": np.stack(images),
            "crop_params": params,
            "gt_extrinsics": extr.numpy().astype(np.float32),
            "gt_intrinsics": intr.astype(np.float32),
            "gt_intrinsics_resized": intr_resized.numpy().astype(
                np.float32),
            "image_names": [os.path.basename(e["filepath"])
                            for e in entries],
        }


def save_h5(dict_to_save: dict, filename: str) -> None:
    """Write a flat dict of arrays to HDF5 (.npz without h5py, or when
    the name ends in .npz). The IMC benchmark's interchange format
    (reference imc_helper.py:629-657); a '/' in a key becomes '-', so each
    key stays one dataset."""
    if h5py is None or filename.endswith(".npz"):
        np.savez(filename if filename.endswith(".npz")
                 else filename + ".npz",
                 **{k.replace("/", "-"): np.asarray(v)
                    for k, v in dict_to_save.items()})
        return
    with h5py.File(filename, "w") as f:
        for k, v in dict_to_save.items():
            f[k.replace("/", "-")] = np.asarray(v)


def load_h5(filename: str) -> dict:
    """Inverse of `save_h5` (.h5 through h5py, or .npz)."""
    if filename.endswith(".npz"):
        data = np.load(filename)
        return {k: np.asarray(data[k]) for k in data.files}
    if h5py is None:
        raise ImportError("h5py required for .h5 files")
    out = {}
    with h5py.File(filename, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, np.asarray(v))
                     if isinstance(v, h5py.Dataset) else None)
    return out


def save_pose_submission(out_dir: str, bag_name: str, image_names: list,
                         pred_extrinsics) -> str:
    """Write one bag's predicted poses in the IMC submission layout: one
    file per bag with a dataset ``pose_<image-stem>`` of the (3, 4)
    world->cam matrix (the benchmark scores relative poses, so the runner's
    gauge is valid as it is). Returns the written path (.h5, or .npz
    without h5py)."""
    os.makedirs(out_dir, exist_ok=True)
    extr = (pred_extrinsics.detach().cpu().numpy()
            if torch.is_tensor(pred_extrinsics) else pred_extrinsics)
    extr = np.asarray(extr, np.float64)
    payload = {}
    for name, E in zip(image_names, extr):
        stem = os.path.splitext(os.path.basename(name))[0]
        payload[f"pose_{stem}"] = E
    ext = ".h5" if h5py is not None else ".npz"
    path = os.path.join(out_dir, f"{bag_name}{ext}")
    save_h5(payload, path)
    return path


def evaluate_bag(pred_extrinsics, gt_extrinsics, device="cpu") -> dict:
    """AUC@30 and the per-pair errors of one bag: (S, 3, 4) predicted and
    GT extrinsics (numpy or tensors), scored in f32 on `device` (the CPU
    by default: the GT is numpy). Returns ``auc30`` (float) and numpy
    ``rot_err_deg``, ``trans_err_deg`` and ``pair_mask`` (S*S,)."""
    from vggsfm_tpu_torch.geometry.metrics import (
        pose_auc30,
        relative_pose_errors,
    )

    def t(a):
        return torch.as_tensor(a).to(device, torch.float32)

    pred, gt = t(pred_extrinsics), t(gt_extrinsics)
    r_err, t_err, mask = relative_pose_errors(pred, gt)
    auc = pose_auc30(pred, gt)
    return {
        "auc30": float(auc),
        "rot_err_deg": r_err.cpu().numpy(),
        "trans_err_deg": t_err.cpu().numpy(),
        "pair_mask": mask.cpu().numpy(),
    }
