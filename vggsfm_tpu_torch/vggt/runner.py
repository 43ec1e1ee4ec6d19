"""VGGT-1B's feed-forward reconstruction on the port: frames -> cameras,
depth maps and a coloured point cloud, exported as a COLMAP model.

The path of the public repository's `demo_colmap.py` without `--use_ba`
(github.com/facebookresearch/vggt): the aggregator over every frame of a
scene, the camera head's 4 iterations, the depth head 8 frames at a time,
then every pixel unprojected to the world through its predicted depth and
camera, those with confidence >= 5.0 kept, at most 100,000 of them drawn
at random (a generator seeded from `VGGTConfig.seed`), one PINHOLE camera
per frame.

`VGGTRunner.reconstruct(images)` runs the stages ``vggt.aggregate``,
``vggt.camera``, ``vggt.depth`` and ``vggt.points`` (each timed into
``timings``, the device's work included) inside the call span
``vggt.reconstruct``, and with ``output_dir`` the host-side export
``vggt.export``. It returns the sparse runner's keys where they apply:
``extrinsics`` (S, 3, 4), ``intrinsics`` (S, 3, 3), ``points3d`` (N, 3),
``colors`` (N, 3) uint8, and ``points_xyf`` (N, 3: pixel x, y and the
frame), ``depth`` and ``depth_conf`` (S, H, W), ``pose_enc`` (S, 9),
``timings``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from vggsfm_tpu_torch.geometry.cameras import (
    fov_pose_to_extri_intri,
    unproject_depth,
)
from vggsfm_tpu_torch.models.vggt import VGGT, init_vggt_
from vggsfm_tpu_torch.utils import trace
from vggsfm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class VGGTConfig:
    img_size: int = 518  # the square the frames are loaded at
    camera_iters: int = 4
    depth_chunk: int = 8  # frames per depth-head call
    conf_thres: float = 5.0  # demo_colmap.py's conf_thres_value
    max_points: int = 100_000  # demo_colmap.py's max_points_for_colmap
    seed: int = 42  # the draw of the kept points; the seeded weights
    checkpoint: str | None = None  # a VGGT state dict (strict)
    model: dict = dataclasses.field(default_factory=dict)  # VGGT(**model)


class VGGTRunner:
    """VGGT's feed-forward reconstruction on one device. The weights are
    `state_dict` if given, else `cfg.checkpoint`, else seeded
    (`init_vggt_` from `cfg.seed`); a state dict's tensors are taken as
    they are (``assign``), so one on the device is not copied."""

    dtype = torch.bfloat16  # the aggregator's, as the demo's autocast

    def __init__(self, cfg: VGGTConfig | None = None, device="cuda",
                 state_dict: dict | None = None):
        self.cfg = cfg = cfg or VGGTConfig()
        self.device = resolve_device(device)
        if state_dict is None and cfg.checkpoint:
            state_dict = torch.load(cfg.checkpoint, map_location=self.device)
            state_dict = state_dict.get("model", state_dict)
        if state_dict is not None:
            with torch.device("meta"):
                self.model = VGGT(**cfg.model, dtype=self.dtype)
            self.model.load_state_dict(state_dict, strict=True, assign=True)
        else:
            with torch.device(self.device):
                self.model = VGGT(**cfg.model, dtype=self.dtype)
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            init_vggt_(self.model, gen)
        self.model.eval()

    @torch.inference_mode()
    def reconstruct(self, images, output_dir: str | None = None,
                    image_names: list | None = None,
                    crop_params=None) -> dict:
        """(S, H, W, 3) frames in [0, 1] (host or device) -> the
        reconstruction (module docstring); with `output_dir` the COLMAP
        model is written to ``output_dir/sparse``, in the original images'
        pixels where `crop_params` (the demo loader's) are given."""
        cfg, dev, m = self.cfg, self.device, self.model
        timings: dict = {}
        with trace.call("vggt.reconstruct"):
            x = torch.as_tensor(images, dtype=torch.float32).to(dev)
            S, H, W, _ = x.shape
            with trace.stage("vggt.aggregate", timings, dev):
                taps = m.aggregator(x)
            with trace.stage("vggt.camera", timings, dev):
                pose = m.camera_head(taps[-1], cfg.camera_iters)[-1]
                extr, intr = fov_pose_to_extri_intri(pose, (H, W))
            with trace.stage("vggt.depth", timings, dev):
                depth, conf = m.depth_head(taps, (H, W), cfg.depth_chunk)
            with trace.stage("vggt.points", timings, dev):
                pts = self.points(x, depth, conf, extr, intr)
            out = {"extrinsics": extr, "intrinsics": intr, "pose_enc": pose,
                   "depth": depth, "depth_conf": conf, **pts,
                   "timings": timings}
            if output_dir is not None:
                with trace.stage("vggt.export", timings):
                    write_colmap(out, (W, H), os.path.join(output_dir,
                                                           "sparse"),
                                 image_names, crop_params, cfg.img_size)
        return out

    def points(self, images, depth, conf, extr, intr) -> dict:
        """The world points of the pixels with confidence >= `conf_thres`,
        at most `max_points` of them drawn at random (in pixel order):
        ``points3d``, ``colors`` (the frame's RGB, x 255 truncated) and
        ``points_xyf``."""
        cfg = self.cfg
        S, H, W = depth.shape
        world = unproject_depth(depth, extr, intr).reshape(-1, 3)
        mask = (conf >= cfg.conf_thres).reshape(-1)
        idx = torch.nonzero(mask).squeeze(1)
        trace.count("vggt.points_candidates", idx.numel())
        if idx.numel() > cfg.max_points:
            gen = torch.Generator(device=idx.device).manual_seed(cfg.seed)
            pick = torch.randperm(idx.numel(), generator=gen,
                                  device=idx.device)[:cfg.max_points]
            idx = idx[pick.sort().values]
        trace.count("vggt.points_kept", idx.numel())
        f, rest = idx // (H * W), idx % (H * W)
        xyf = torch.stack([rest % W, rest // W, f], dim=-1)
        colors = (images.reshape(-1, 3)[idx] * 255).to(torch.uint8)
        return {"points3d": world[idx], "colors": colors,
                "points_xyf": xyf}


def write_colmap(out: dict, image_wh, path: str, image_names=None,
                 crop_params=None, img_size: int = 518) -> None:
    """The reconstruction as a COLMAP model at `path`: one PINHOLE camera
    and image per frame, each point with its one observation (the pixel it
    was unprojected from), as `demo_colmap.py` writes it without tracks."""
    from vggsfm_tpu_torch.io.bridge import (
        _camera_params,
        _matrix_to_quat,
        rescale_reconstruction_to_original,
    )
    from vggsfm_tpu_torch.io.colmap import (
        Camera,
        Image,
        Point3D,
        Reconstruction,
        write_model,
    )

    extr = out["extrinsics"].double().cpu().numpy()
    intr = out["intrinsics"].double().cpu().numpy()
    pts = out["points3d"].double().cpu().numpy()
    rgb = out["colors"].cpu().numpy()
    xyf = out["points_xyf"].cpu().numpy()
    S = len(extr)
    frame = xyf[:, 2]
    # each point's index among its frame's observations
    order = np.argsort(frame, kind="stable")
    rank = np.empty(len(frame), np.int64)
    starts = np.searchsorted(frame[order], np.arange(S))
    rank[order] = np.arange(len(frame)) - starts[frame[order]]
    cameras, images = {}, {}
    for s in range(S):
        cameras[s + 1] = Camera(s + 1, "PINHOLE", int(image_wh[0]),
                                int(image_wh[1]),
                                _camera_params("PINHOLE", intr[s], None))
        sel = np.nonzero(frame == s)[0]
        images[s + 1] = Image(
            id=s + 1, qvec=_matrix_to_quat(extr[s, :, :3]),
            tvec=extr[s, :, 3].copy(), camera_id=s + 1,
            name=(image_names[s] if image_names is not None
                  else f"image_{s:04d}.png"),
            xys=xyf[sel, :2].astype(np.float64),
            point3D_ids=sel.astype(np.int64))
    points = {p: Point3D(p, pts[p], rgb[p], 0.0,
                         np.array([frame[p] + 1], np.int32),
                         np.array([rank[p]], np.int32))
              for p in range(len(pts))}
    rec = Reconstruction(cameras, images, points)
    if crop_params is not None:
        rescale_reconstruction_to_original(rec, crop_params, img_size,
                                           image_names)
    write_model(rec, path)
