"""VGGSfMRunner, the sparse pipeline from a folder of images to a COLMAP
model: query-frame ranking, camera initialization, query-point extraction
and tracking (feature maps -> coarse tracks -> fine tracks, chunked over
query points), the re-query of frames that see too few points, the
preliminary two-view cameras, the hybrid choice of the SfM's initial
cameras, the SfM solve and its gauge normalization, the track colors, the
extra-point densification, the dense depth maps, the COLMAP / GLB export,
the visuals and the profiler trace, and the scene loader around it.
Counterpart of vggsfm_tpu/runner.py (`_stage`, `_score_camera_init`,
`select_query_frames`, `_fmaps`, `_query_points`, `_coarse_track`,
`_fine_track`, `predict_tracks`, `_comple_nonvis`, `sparse_reconstruct`,
`_choose_camera_init`, `triangulate_extra_points`, `_load_depth_model`,
`_disparity`, `dense_reconstruct`, `save_dense_depth_maps`,
`save_reconstruction`, `run_scene`, the checkpoint by path; reference
runners/runner.py:133-162, 292-633, 776-860, 887-911, 1068-1282).

Runs on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vggsfm_tpu_torch.datasets.demo_loader import DemoLoader
from vggsfm_tpu_torch.extractors.dispatch import (
    get_query_points,
    get_query_points_batched,
    grid_keypoints,
)
from vggsfm_tpu_torch.geometry.cameras import (
    cam_from_img,
    pose_encoding_to_extri_intri,
)
from vggsfm_tpu_torch.geometry.metrics import pose_auc30
from vggsfm_tpu_torch.io.bridge import (
    arrays_to_reconstruction,
    rescale_reconstruction_to_original,
)
from vggsfm_tpu_torch.io.colmap import Point3D, write_model
from vggsfm_tpu_torch.io.glb import reconstruction_to_glb
from vggsfm_tpu_torch.models.camera import CameraPredictor, init_camera_
from vggsfm_tpu_torch.models.dpt import DepthAnything, init_depth_anything_
from vggsfm_tpu_torch.models.refine import refine_track
from vggsfm_tpu_torch.models.sampling import (
    bilinear_sample,
    interpolate_bilinear,
    sample_features4d,
)
from vggsfm_tpu_torch.models.tracker import TrackerPredictor, init_tracker_
from vggsfm_tpu_torch.ops.triangulation import (
    triangulate_by_pair,
    triangulate_tracks,
)
from vggsfm_tpu_torch.sfm.normalize import normalize_reconstruction
from vggsfm_tpu_torch.sfm.triangulator import SfmConfig, run_sfm
from vggsfm_tpu_torch.twoview.preliminary import estimate_preliminary_cameras
from vggsfm_tpu_torch.utils.camera_avg import (
    average_camera_prediction,
    rank_by_dino_similarity,
    rank_by_interval,
    rank_by_midpoint,
)
from vggsfm_tpu_torch.utils.depth import (
    align_depth_maps_to_sfm,
    write_colmap_array,
)
from vggsfm_tpu_torch.utils.device import resolve_device
from vggsfm_tpu_torch.utils.precision import f32_matmuls
from vggsfm_tpu_torch.utils.visualizer import WORKERS as VISUAL_WORKERS
from vggsfm_tpu_torch.utils.visualizer import (
    visualize_query_points,
    visualize_reprojections,
    visualize_tracks,
)


def _score_camera_init(extr, intr, tracks, vis, fmat_mask, focal_scale):
    """Init-pair support under a candidate camera set: for the best
    partner frame, the tracks that are epipolar inliers, in front of both
    cameras and triangulated at an angle of at least 2 degrees. A focal at
    or near the decode clamp (0.2x / 5x of `focal_scale`) is a saturated
    decode, never a real estimate: it scores -1, below even a
    zero-support competitor. extr (S, 3, 4), intr (S, 3, 3), tracks
    (S, N, 2), vis (S, N), fmat_mask (S-1, N) -> a 0-d int tensor."""
    _, cheir, tri = triangulate_by_pair(extr, cam_from_img(tracks, intr))
    inl = fmat_mask & (vis > 0.05)[1:] & cheir & (tri >= 2.0)
    f = intr[..., 0, 0]
    saturated = ((f <= 0.21 * focal_scale) | (f >= 4.9 * focal_scale)).any()
    return torch.where(saturated, -1, inl.sum(-1).max())


def track_colors(images, tracks, weight):
    """Mean color of each track: images (S, H, W, 3) sampled bilinearly
    (border-clamped) at tracks (S, P, 2), averaged over the frames where
    weight (S, P) holds -> (P, 3); 0 where it holds nowhere."""
    rgb = sample_features4d(images, tracks)  # S acts as the batch
    w = weight.to(rgb.dtype)[..., None]
    return (rgb * w).sum(0) / w.sum(0).clamp(min=1)


# what the export reads of the predictions
EXPORT_KEYS = ("points3d", "extrinsics", "intrinsics", "extra_params",
                "pred_track", "valid_tracks", "valid_2d_mask",
                "valid_frame_mask", "colors", "additional_points")


def to_host(predictions: dict) -> dict:
    """The arrays of a predictions dict as numpy: every device tensor
    (one level of nested dicts too) is copied without blocking, then one
    synchronization waits for all the copies."""
    def start(v):
        if isinstance(v, dict):
            return {k: start(x) for k, x in v.items()}
        if torch.is_tensor(v):
            return v.detach().to("cpu", non_blocking=True)
        return v

    def finish(v):
        if isinstance(v, dict):
            return {k: finish(x) for k, x in v.items()}
        return v.numpy() if torch.is_tensor(v) else v

    copies = start(predictions)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return finish(copies)


@dataclasses.dataclass
class RunnerConfig:
    """The fields of vggsfm_tpu.runner.RunnerConfig that the port reads,
    with its defaults."""

    # the loader's square image side (`run_scene`), and the frame size the
    # exported model is rescaled from
    img_size: int = 1024
    # a reference checkpoint (vggsfm_v2_0_0.bin): its track_predictor.* and
    # camera_predictor.* entries; a path that does not exist leaves the
    # seeded weights, as in the JAX runner
    checkpoint: str | None = None
    query_frame_num: int = 3
    max_query_pts: int = 4096
    # 'auto': aliked with a trained checkpoint (VGGSFM_TPU_ALIKED_CKPT),
    # else sift+harris; methods combine with '+'
    # (extractors/dispatch.py)
    query_method: str = "auto"
    # ensemble the camera prediction over the query orderings
    avg_pose: bool = True
    # midpoint query ranking instead of DINO-similarity FPS
    query_by_midpoint: bool = False
    # stride ranking 0, k, 2k, ... with k = S // query_num + 1 (midpoint
    # takes precedence when both are set)
    query_by_interval: bool = False
    fine_tracking: bool = True
    coarse_iters: int = 6
    max_points_num: int = 163840  # track-frames per coarse tracker call
    max_fine_points_num: int = 32768  # track-frames per fine call
    # `track_frames` re-queries the frames that see fewer than
    # min_vis_points points (`_comple_nonvis`)
    comple_nonvis: bool = True
    min_vis_points: int = 500
    seed: int = 0
    # correlation-argmax init, cycle-consistency visibility and NCC polish:
    # the weights-free operating mode (the latter two only without loaded
    # weights, as in the JAX runner)
    matching_init: bool = True
    # 'bf16' runs the neural path in bfloat16, 'f32' in float32
    precision: str = "bf16"
    # epipolar (Sampson) inlier threshold of the preliminary two-view
    # fundamental estimation, in px
    fmat_thres: float = 4.0
    # SfM initial cameras: 'neural' (camera predictor), 'twoview' (the
    # preliminary essential-matrix poses) or 'hybrid' (score both by
    # init-pair support, keep the winner)
    camera_init: str = "hybrid"
    # anchor the solve on the top-ranked query frame: swap it with frame 0,
    # swap the outputs back
    center_order: bool = False
    # the SfM solve (SfmConfig): camera model, one camera for all frames,
    # focal refinement, forced pose-refinement rounds, global BA rounds,
    # reprojection gates in px
    camera_type: str = "SIMPLE_PINHOLE"
    shared_camera: bool = False
    refine_focal: bool = True
    robust_refine: int = 2
    ba_iters: int = 2
    max_reproj_error: float = 4.0
    init_max_reproj_error: float = 4.0
    # the mean color of each track over the frames that see it
    extract_color: bool = True
    # grid-point densification: one extra query point every N pixels,
    # tracked and triangulated without BA (<= 0 disables)
    extra_pt_pixel_interval: int = -1
    # append the extra points (trackless) to the exported COLMAP model
    concat_extra_points: bool = False
    # track each frame's extra grid only into a window of this many
    # neighbor frames (<= 0: all frames)
    extra_by_neighbor: int = -1
    # drop the frames whose camera failed the solve from the exported model
    filter_invalid_frame: bool = True
    # write OUT/scene.glb: the point cloud and the camera frusta
    make_glb: bool = False
    # dense monocular depth maps aligned to the sparse reconstruction,
    # written to OUT/depths/*.bin (COLMAP array format)
    dense_depth: bool = False
    # a DepthAnythingV2 checkpoint (depth_anything_v2_vit{b,l}.pth); seeded
    # ViT-B weights otherwise
    depth_checkpoint: str | None = None
    # the square side each frame is resized to for the DPT
    depth_input_size: int = 518
    # OUT/visuals: the query points of each query frame, the tracks over
    # every frame (PNGs, GIF, mp4), the reprojections (PNGs, mp4)
    visual_query_points: bool = False
    visual_tracks: bool = False
    make_reproj_frames: bool = False
    # write a torch.profiler trace (Chrome JSON) of each sparse_reconstruct
    # here, every stage a named range
    profile_dir: str | None = None


class VGGSfMRunner:
    """`state_dict` / `camera_state_dict`: the tracker's and the camera
    predictor's weights (the reference checkpoint's ``track_predictor.*``
    and ``camera_predictor.*`` entries, prefix stripped); else those of
    the checkpoint at `cfg.checkpoint` when the path exists; seeded random
    weights otherwise. The camera predictor is built on its first use."""

    def __init__(self, cfg: RunnerConfig = RunnerConfig(), device="cuda",
                 state_dict: dict | None = None,
                 camera_state_dict: dict | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.checkpoint and os.path.exists(cfg.checkpoint):
            ckpt = torch.load(cfg.checkpoint, map_location="cpu")

            def part(prefix):
                return {k[len(prefix):]: v for k, v in ckpt.items()
                        if k.startswith(prefix)} or None

            if state_dict is None:
                state_dict = part("track_predictor.")
            if camera_state_dict is None:
                camera_state_dict = part("camera_predictor.")
        if cfg.precision not in ("bf16", "f32"):
            raise ValueError(f"precision must be 'bf16' or 'f32', got "
                             f"{cfg.precision!r}")
        self.dtype = (torch.bfloat16 if cfg.precision == "bf16"
                      else torch.float32)
        tracker = TrackerPredictor(dtype=self.dtype)
        if state_dict is not None:
            tracker.load_state_dict(state_dict)
        else:
            init_tracker_(tracker, torch.Generator().manual_seed(cfg.seed))
        self._weights_loaded = state_dict is not None
        self.tracker = tracker.to(self.device).eval()
        self._camera_state_dict = camera_state_dict
        self._camera = None
        self._depth = None  # DepthAnything, built on first use
        self._query_point_log: list = []  # (frame, xy, valid) per extract
        self._profiler = None
        self.trace_path = None
        self.timings: dict = {}

    @property
    def camera(self) -> CameraPredictor:
        """The camera predictor (DINOv2 + pose trunk), built on first use."""
        if self._camera is None:
            camera = CameraPredictor(dtype=self.dtype)
            if self._camera_state_dict is not None:
                camera.load_state_dict(self._camera_state_dict)
            else:
                init_camera_(camera,
                             torch.Generator().manual_seed(self.cfg.seed))
            self._camera = camera.to(self.device).eval()
        return self._camera

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Accumulate the wall time of a stage, device work included; a
        named range of the trace while profiling."""
        t0 = time.perf_counter()
        with (torch.profiler.record_function(name)
              if self._profiler is not None else contextlib.nullcontext()):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)

    @contextlib.contextmanager
    def _profiling(self):
        """With `cfg.profile_dir`, a torch.profiler trace (CPU and, on the
        GPU, CUDA activities) of the body, written as a Chrome trace into
        that folder (its path in `trace_path`). The profiler stops when
        the body ends, by an exception too, so a failed call leaves none
        running."""
        if self.cfg.profile_dir is None:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self._profiler = prof
            try:
                yield
            finally:
                self._profiler = None
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.cfg.profile_dir, f"sparse_reconstruct_"
            f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
        prof.export_chrome_trace(self.trace_path)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device, torch.float32)

    @torch.inference_mode()
    def _coarse_track(self, fmaps, qp, stage="coarse"):
        minit = self.cfg.matching_init
        mvis = minit and not self._weights_loaded
        with self._stage(stage):
            preds, vis = self.tracker.coarse_predictor(
                qp, fmaps, iters=self.cfg.coarse_iters,
                down_ratio=self.tracker.coarse_down_ratio,
                matching_init=minit, matching_vis=mvis)
        return preds[-1], vis

    @torch.inference_mode()
    def _fine_track(self, images, coarse):
        minit = self.cfg.matching_init
        # the NCC polish only in the weights-free mode
        subpix = minit and not self._weights_loaded
        tr = self.tracker

        def fnet(x):
            return tr.fine_fnet(x, flat_cfirst=True)

        def ftrack(q, f, iters, return_feat, matching_init,
                   fmaps_flat_hw=None):
            return tr.fine_predictor(q, f, iters=iters,
                                     return_feat=return_feat,
                                     matching_init=matching_init,
                                     fmaps_flat_hw=fmaps_flat_hw)

        with self._stage("fine"):
            return refine_track(images, fnet, ftrack, coarse,
                                compute_score=True, matching_init=minit,
                                subpixel_refine=subpix,
                                patch_dtype=tr.dtype)

    @torch.inference_mode()
    def select_query_frames(self, images) -> list:
        """Rank the query frames of (1, S, H, W, 3) images in [0, 1]:
        DINO-similarity farthest-point sampling by default, midpoint or
        interval spread as configured. Frame 0 first."""
        cfg = self.cfg
        images = self._to_device(images)
        S = images.shape[1]
        q = min(cfg.query_frame_num, S)
        with self._stage("query_rank"):
            if q <= 1 or S <= 2:
                return [0]
            if cfg.query_by_midpoint:
                return rank_by_midpoint(S, q)
            if cfg.query_by_interval:
                return rank_by_interval(S, S // q + 1)[:q]
            desc = self.camera.frame_descriptors(images)
            return rank_by_dino_similarity(desc[0], q)[:q]

    @torch.inference_mode()
    def camera_init(self, images, query_indices):
        """Cameras of (1, S, H, W, 3) images in [0, 1] from the camera
        predictor (4 trunk iterations): with `avg_pose`, one batched forward
        over the orderings that put each query frame first, averaged;
        else one forward. Returns (extrinsics (S, 3, 4), intrinsics
        (S, 3, 3)), f32, relative to frame 0."""
        images = self._to_device(images)
        H, W = images.shape[2:4]
        with self._stage("camera_init"):
            if self.cfg.avg_pose:
                return average_camera_prediction(
                    lambda im: self.camera(im, iters=4)["pred_pose_enc"],
                    images, (H, W), query_indices=list(query_indices),
                    model_input_size=self.camera.down_size)
            pose_enc = self.camera(images, iters=4)["pred_pose_enc"]
            return pose_encoding_to_extri_intri(pose_enc[0], (H, W))

    @torch.inference_mode()
    def camera_forward(self, images):
        """One camera-predictor forward (4 trunk iterations) on (B, S, H, W,
        3) images in [0, 1]: the predictor's dict, ``pred_pose_enc``
        (B, S, 8). The JAX runner's `_camera_forward`, which the video
        runner calls per window."""
        return self.camera(self._to_device(images), iters=4)

    @torch.inference_mode()
    def fmaps(self, images):
        """Coarse feature maps of (B, S, H, W, 3) images in [0, 1]."""
        images = self._to_device(images)
        with self._stage("fmaps"):
            return self.tracker.process_images_to_fmaps(images)

    @torch.inference_mode()
    def query_points(self, images, query_indices, masks=None,
                     query_method=None, max_query_pts=None):
        """Query keypoints of each query frame of (B, S, H, W, 3) images:
        (list of (max_query_pts, 2) xy, list of (max_query_pts,) valid).

        Without segmentation masks all query frames go through each
        detector in one batch; with `masks` (S, H, W), pixels above 0.5
        are invalid and the frames are extracted one by one. Each frame
        subsamples with its own permutation, drawn in frame order from a
        generator seeded with `cfg.seed`. With `cfg.visual_query_points`
        each frame's points are logged for the visuals.
        """
        cfg = self.cfg
        images = self._to_device(images)
        method = query_method or cfg.query_method
        max_pts = max_query_pts or cfg.max_query_pts
        gen = torch.Generator().manual_seed(cfg.seed)
        with self._stage("query_points"):
            if masks is None and len(query_indices) > 1:
                idx = torch.as_tensor(np.asarray(query_indices),
                                      device=self.device)
                qp, valid = get_query_points_batched(images[0, idx], gen,
                                                     method, max_pts)
                self._log_query_points(query_indices, qp, valid)
                return list(qp), list(valid)
            qps, valids = [], []
            for qframe in query_indices:
                seg = None
                if masks is not None:
                    seg = self._to_device(masks[qframe]) > 0.5
                qp, valid = get_query_points(images[0, qframe], gen, method,
                                             max_pts, seg_invalid_mask=seg)
                qps.append(qp)
                valids.append(valid)
            self._log_query_points(query_indices, qps, valids)
            return qps, valids

    def _log_query_points(self, frames, qps, valids):
        if self.cfg.visual_query_points:
            self._query_point_log.extend(
                (int(f), q, v) for f, q, v in zip(frames, qps, valids))

    @torch.inference_mode()
    def predict_tracks(self, images, fmaps, query_indices,
                       query_points=None, query_valid=None, masks=None,
                       query_method=None, max_query_pts=None):
        """Track from each query frame; concatenate over query frames.

        images (B, S, H, W, 3) in [0, 1]; fmaps from `fmaps(images)`;
        query_indices: the query frames. The runner extracts each frame's
        query points (`query_points`, with `masks`, and `query_method` /
        `max_query_pts` overriding the config), unless the caller gives
        them: query_points, a list of (N, 2) xy pixel arrays, one per
        query frame, and optionally query_valid, a list of (N,) masks.
        Invalid points get visibility 0.

        Frames are reordered so each query frame comes first, points are
        chunked per coarse call (`max_points_num // S`) and per fine call
        (`max_fine_points_num // S`, at most 4096), and the outputs are put
        back in the original frame order. Returns (tracks (B, S, P, 2),
        vis (B, S, P), score (B, S, P)) with P = sum of the N.
        """
        cfg = self.cfg
        images = self._to_device(images)
        B, S = images.shape[:2]
        if query_points is None:
            query_points, query_valid = self.query_points(
                images, query_indices, masks, query_method, max_query_pts)
        orders = []
        for qframe in query_indices:
            order = np.arange(S)
            order[0], order[qframe] = qframe, 0
            orders.append(order)
        orders = np.stack(orders)
        inv_orders = np.argsort(orders, axis=1)

        chunk = max(256, cfg.max_points_num // S)
        fine_chunk = max(128, min(4096, cfg.max_fine_points_num // S))

        all_track, all_vis, all_score = [], [], []
        for qi in range(len(query_indices)):
            order = torch.as_tensor(orders[qi], device=self.device)
            imgs_q = images[:, order]
            fmaps_q = fmaps[:, order]
            qp = self._to_device(query_points[qi])
            tracks, viss, scores = [], [], []
            for start in range(0, qp.shape[0], chunk):
                qp_c = qp[None, start: start + chunk]
                coarse, vis = self._coarse_track(fmaps_q, qp_c)
                if cfg.fine_tracking:
                    fines, fscores = [], []
                    for fs in range(0, coarse.shape[2], fine_chunk):
                        f, sc = self._fine_track(
                            imgs_q, coarse[:, :, fs: fs + fine_chunk])
                        fines.append(f)
                        fscores.append(sc)
                    fine = torch.cat(fines, dim=2)
                    score = torch.cat(fscores, dim=2)
                else:
                    fine, score = coarse, torch.ones_like(vis)
                tracks.append(fine)
                viss.append(vis)
                scores.append(score)
            inv = torch.as_tensor(inv_orders[qi], device=self.device)
            track = torch.cat(tracks, dim=2)[:, inv]
            vis = torch.cat(viss, dim=2)[:, inv]
            score = torch.cat(scores, dim=2)[:, inv]
            if query_valid is not None:
                valid = query_valid[qi]
                if not torch.is_tensor(valid):
                    valid = torch.as_tensor(np.asarray(valid))
                vis = vis * valid.to(self.device, vis.dtype)[None, None, :]
            all_track.append(track)
            all_vis.append(vis)
            all_score.append(score)
        return (torch.cat(all_track, dim=2), torch.cat(all_vis, dim=2),
                torch.cat(all_score, dim=2))

    def track_frames(self, images, fmaps, query_indices, masks=None):
        """The tracking stage of the JAX runner's `sparse_reconstruct`:
        `predict_tracks` from the query frames with the runner's own query
        points, then, with `cfg.comple_nonvis`, the re-query of the frames
        that see too few of them. Same arguments and returns as
        `predict_tracks`."""
        track, vis, score = self.predict_tracks(images, fmaps, query_indices,
                                                masks=masks)
        if self.cfg.comple_nonvis:
            track, vis, score = self._comple_nonvis(images, fmaps, track,
                                                    vis, score, masks)
        return track, vis, score

    def _comple_nonvis(self, images, fmaps, track, vis, score, masks=None):
        """Re-query the frames with too few visible points, then escalate
        (reference `comple_nonvis_frames`, runners/runner.py:1201-1282):
        query from the first frame that sees fewer than `min_vis_points`
        points above visibility 0.05; when the same frame stays short, one
        final trial re-queries all remaining short frames with the
        combined extractors at half the point budget, then stops. The
        count is read on the host, one device-to-host copy per round."""
        cfg = self.cfg

        def bad_frames(v):
            count = (v[0] > 0.05).sum(dim=-1).cpu().numpy()
            return [int(i) for i in np.nonzero(count < cfg.min_vis_points)[0]]

        bad = bad_frames(vis)
        last_query = -1
        final_trial = False
        while bad:
            if bad[0] == last_query:
                final_trial = True
                method = "sp+sift+aliked"
                max_pts = cfg.max_query_pts // 2
                query_list = bad
            else:
                method = cfg.query_method
                max_pts = cfg.max_query_pts
                query_list = [bad[0]]
            last_query = bad[0]

            t2, v2, s2 = self.predict_tracks(
                images, fmaps, query_list, masks=masks, query_method=method,
                max_query_pts=max_pts)
            track = torch.cat([track, t2], dim=2)
            vis = torch.cat([vis, v2], dim=2)
            score = torch.cat([score, s2], dim=2)
            bad = bad_frames(vis)
            if final_trial:
                break
        return track, vis, score

    @torch.inference_mode()
    def preliminary(self, track, vis, score, width, height,
                    sample_idx=None):
        """The preliminary two-view cameras of (1, S, N) tracks: LORANSAC
        fundamental matrices of every frame against frame 0 (1024 minimal
        sets drawn from a CPU generator seeded with `cfg.seed + 1`, or
        `sample_idx` (1024, 7); `lo_num` 128; Sampson threshold
        `cfg.fmat_thres`; the fine tracker's scores gate the tracks when
        fine tracking ran), then E, (R, t) and the cheirality choice. The
        dict of `estimate_preliminary_cameras`."""
        cfg = self.cfg
        with self._stage("preliminary"):
            return estimate_preliminary_cameras(
                track, vis, width, height,
                torch.Generator().manual_seed(cfg.seed + 1),
                tracks_score=score if cfg.fine_tracking else None,
                max_error=cfg.fmat_thres, max_ransac_iters=1024,
                lo_num=128, sample_idx=sample_idx)

    @torch.inference_mode()
    def _choose_camera_init(self, extr_neural, intr_neural, pre, track,
                            vis):
        """The SfM's initial cameras per `cfg.camera_init`: (extrinsics
        (S, 3, 4), intrinsics (S, 3, 3), scores). 'hybrid' scores the
        neural cameras and the two-view ones by init-pair support
        (`_score_camera_init`, the saturation scale being the two-view
        default focal max(W, H)) and keeps the neural ones where they score
        at least as high; the choice is made on the device, and `scores`
        is the (2,) tensor [neural, two-view] (None in the other modes)."""
        cfg = self.cfg
        if cfg.camera_init == "neural":
            return extr_neural, intr_neural, None
        S = track.shape[1]
        extr_tv = pre["extrinsics"][0]
        intr_tv = pre["default_intri"].expand(S, 3, 3)
        if cfg.camera_init == "twoview":
            return extr_tv, intr_tv, None
        if cfg.camera_init != "hybrid":
            raise ValueError(f"unknown camera_init {cfg.camera_init}")
        with self._stage("camera_choice"):
            scale = intr_tv[0, 0, 0]
            fm = pre["fmat_inlier_mask"][0]
            s_n = _score_camera_init(extr_neural, intr_neural, track[0],
                                     vis[0], fm, scale)
            s_t = _score_camera_init(extr_tv, intr_tv, track[0], vis[0], fm,
                                     scale)
            c = s_n >= s_t
            return (torch.where(c, extr_neural, extr_tv),
                    torch.where(c, intr_neural, intr_tv),
                    torch.stack([s_n, s_t]))

    def sfm_config(self) -> SfmConfig:
        """The solve's options from the runner's."""
        cfg = self.cfg
        return SfmConfig(init_max_reproj_error=cfg.init_max_reproj_error,
                         max_reproj_error=cfg.max_reproj_error,
                         robust_refine=cfg.robust_refine,
                         ba_iters=cfg.ba_iters,
                         shared_camera=cfg.shared_camera,
                         refine_focal=cfg.refine_focal,
                         camera_type=cfg.camera_type, seed=cfg.seed)

    @torch.inference_mode()
    def solve(self, extr, intr, track, vis, score, pre, width, height):
        """Step 6 of the JAX runner: `run_sfm` from the initial cameras
        (S, 3, 4), (S, 3, 3) on (1, S, N) tracks, visibility and scores
        with the preliminary stage's epipolar inliers, under `timings` key
        `sfm` (its parts under `sfm.<part>`), then the gauge normalization
        on the registered frames. Returns `run_sfm`'s dict, normalized."""
        with self._stage("sfm"):
            out = run_sfm(extr, intr, track[0], vis[0], (width, height),
                          fmat_inlier_mask=pre["fmat_inlier_mask"][0],
                          score=score[0], cfg=self.sfm_config(),
                          stage=lambda name: self._stage(f"sfm.{name}"))
        out["extrinsics"], out["points3d"], _, _ = normalize_reconstruction(
            out["extrinsics"], out["points3d"],
            registered=out["valid_frame_mask"])
        return out

    @torch.inference_mode()
    def sparse_reconstruct(self, images, masks=None, image_names=None,
                           output_dir=None, crop_params=None):
        """The sparse pipeline on (S, H, W, 3) images in [0, 1] (uint8
        images are scaled): the JAX runner's steps in its order and under
        its `timings` keys: `query_rank`, the `center_order` swap,
        `camera_init`, `fmaps`, `tracking` (`track_frames`:
        `query_points`, `coarse`, `fine` within it), `preliminary`, the
        camera-init choice (`camera_choice`; the JAX runner leaves the
        choice untimed), the SfM solve (`sfm`, its parts `sfm.<part>`) and
        its gauge normalization, the track colors (`cfg.extract_color`),
        the extra points (`extra_points`, with `cfg.extra_pt_pixel_interval
        > 0`; their coarse calls `extra_points.coarse`), and with
        `output_dir` the export (`export`: `export.build`,
        `export.write`): `save_reconstruction` and, with `cfg.make_glb`,
        OUT/scene.glb. With `cfg.dense_depth`, the dense depth maps
        (`dense_depth`, after the extra points), written under the export
        to OUT/depths (`export.depths`). With `output_dir` and
        `cfg.visual_query_points`, `visual_tracks` or `make_reproj_frames`,
        the visuals to OUT/visuals (`visuals`) from the export's host copy.
        With `cfg.profile_dir`, a trace of the call (`_profiling`).
        masks: optional (S, H, W) segmentation, pixels above
        0.5 invalid for query points; image_names: the exported images'
        names; crop_params: (S, 8) rows of the loader, to export in the
        original images' pixels.

        Returns the JAX runner's keys: the solve's ``extrinsics``
        (S, 3, 4, normalized), ``intrinsics`` (S, 3, 3), ``extra_params``
        (S, K) or None, ``points3d`` (P, 3, normalized), ``valid_tracks``
        (P,), ``valid_2d_mask`` (S, P), ``valid_frame_mask`` (S,),
        ``init_idx``; the tracks ``pred_track`` (1, S, P, 2),
        ``pred_vis`` and ``pred_score`` (1, S, P); ``colors`` (P, 3) in
        [0, 1] or None; ``additional_points`` (`triangulate_extra_points`)
        when asked for; ``total_time`` (s, the export excluded, as in the
        JAX runner) and ``timings``; and ``preliminary`` (the dict of
        `preliminary`, in the solve's frame order), the chosen initial
        cameras ``init_extrinsics`` and ``init_intrinsics``,
        ``init_scores`` ([neural, two-view] support, or None) and
        ``query_indices``; with `cfg.dense_depth` those of
        `dense_reconstruct`. Arrays stay tensors on the runner's device.

        With `center_order` every stage and the export run on the swapped
        frames (image id 1 of the model is the top-ranked frame, under its
        own name); the per-frame outputs are then swapped back to the
        caller's frame order and ``center_perm`` is set.
        """
        with self._profiling():
            return self._sparse_reconstruct(images, masks, image_names,
                                            output_dir, crop_params)

    def _sparse_reconstruct(self, images, masks, image_names, output_dir,
                            crop_params):
        cfg = self.cfg
        t_start = time.perf_counter()
        # the caller's numpy frames serve the visuals as they are
        host_images = None if torch.is_tensor(images) else np.asarray(images)
        x = torch.as_tensor(images if torch.is_tensor(images)
                            else host_images).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        images = x[None]
        S, H, W = images.shape[1:4]
        self.timings = {}
        self._query_point_log = []

        # 1. query frames
        query_indices = self.select_query_frames(images)
        # 1b. center_order: swap the top-ranked frame with frame 0 (a
        # self-inverse permutation) for every stage and the export; the
        # per-frame outputs are swapped back before returning
        center_perm = None
        if cfg.center_order and query_indices and query_indices[0] != 0:
            center = query_indices[0]
            center_perm = np.arange(S)
            center_perm[0], center_perm[center] = center, 0
            images = images[:, torch.as_tensor(center_perm,
                                               device=self.device)]
            if masks is not None:
                masks = np.asarray(masks)[center_perm]
            if host_images is not None:
                host_images = host_images[center_perm]
            if image_names is not None:
                image_names = [image_names[i] for i in center_perm]
            if crop_params is not None:
                crop_params = np.asarray(crop_params)[center_perm]
            query_indices = [center if i == 0 else (0 if i == center else i)
                             for i in query_indices]
        # 2. camera init
        extr0, intr0 = self.camera_init(images, query_indices)
        # 3. feature maps
        fmaps = self.fmaps(images)
        # 4. tracking, with the re-query of short frames
        with self._stage("tracking"):
            track, vis, score = self.track_frames(images, fmaps,
                                                  query_indices, masks)
        # 5. preliminary two-view cameras
        pre = self.preliminary(track, vis, score, W, H)
        # 5b. the SfM's initial cameras
        extr, intr, scores = self._choose_camera_init(extr0, intr0, pre,
                                                      track, vis)
        # 6. the SfM solve, gauge-normalized
        out = self.solve(extr, intr, track, vis, score, pre, W, H)
        # 7. colors, on the device
        out["colors"] = (track_colors(images[0], track[0],
                                      out["valid_2d_mask"])
                         if cfg.extract_color else None)
        out.update(pred_track=track, pred_vis=vis, pred_score=score,
                   preliminary=pre, init_extrinsics=extr,
                   init_intrinsics=intr, init_scores=scores,
                   query_indices=query_indices)
        # the extra points, on the normalized cameras
        if cfg.extra_pt_pixel_interval > 0:
            iv = cfg.extra_pt_pixel_interval
            with self._stage("extra_points"):
                out["additional_points"] = self.triangulate_extra_points(
                    images, fmaps, out["extrinsics"], out["intrinsics"],
                    num_extra=max(1, (H // iv) * (W // iv)),
                    by_neighbor=cfg.extra_by_neighbor,
                    extra_params=out["extra_params"])
        if cfg.dense_depth:
            with self._stage("dense_depth"):
                self.dense_reconstruct(images, out)
        out["total_time"] = time.perf_counter() - t_start
        # the export, in the solve's frame order
        if output_dir is not None:
            visuals = (cfg.visual_query_points or cfg.visual_tracks
                       or cfg.make_reproj_frames)
            with self._stage("export"):
                want = {k: out.get(k) for k in EXPORT_KEYS}
                if visuals:
                    # one host copy serves the export and the visuals
                    want["pred_vis"] = out["pred_vis"].float()
                    want["query_log"] = {
                        str(i): {"xy": q, "valid": v}
                        for i, (_, q, v) in enumerate(self._query_point_log)}
                    if host_images is None:
                        want["images"] = images[0]
                host = to_host(want)
                self.save_reconstruction(host, (W, H), image_names,
                                         output_dir, crop_params=crop_params)
                if cfg.make_glb:
                    reconstruction_to_glb(
                        host, os.path.join(output_dir, "scene.glb"),
                        image_size=(W, H))
                if cfg.dense_depth:
                    with self._stage("export.depths"):
                        self.save_dense_depth_maps(
                            out["depth_maps"], image_names, output_dir,
                            crop_params=crop_params)
            if visuals:
                with self._stage("visuals"):
                    self.write_visuals(
                        host, host.get("images", host_images), output_dir)
        out["timings"] = dict(self.timings)
        if center_perm is not None:
            perm = torch.as_tensor(center_perm, device=self.device)
            for k in ("extrinsics", "intrinsics", "extra_params",
                      "valid_frame_mask", "valid_2d_mask",
                      "init_extrinsics", "init_intrinsics", "depth_maps",
                      "depth_align_coeffs", "depth_inlier_frac"):
                if out.get(k) is not None:
                    out[k] = out[k][perm]
            for k in ("pred_track", "pred_vis", "pred_score"):
                out[k] = out[k][:, perm]
            out["center_perm"] = center_perm
        return out

    @torch.inference_mode()
    def triangulate_extra_points(self, images, fmaps, extrinsics,
                                 intrinsics, num_extra: int = 4096,
                                 by_neighbor: int = -1, extra_params=None):
        """Densify (reference runners/runner.py:635-742): every frame
        queries its own pixel grid (`grid_keypoints`, `num_extra` points),
        tracked by the coarse tracker over a window of `by_neighbor` frames
        around it (<= 0: all frames; the frame itself first), in chunks of
        `max(256, max_points_num // S)` points, then LORANSAC-triangulated
        against the given cameras (64 pair trials, seed 7 + frame), no BA.
        A point is valid with at least min(3, window) inlier frames; its
        color is the mean over the window's frames that see it (visibility
        above 0.05).

        images (1, S, H, W, 3) in [0, 1], fmaps from `fmaps(images)`,
        cameras (S, 3, 4), (S, 3, 3), extra_params (S, K) or None. Returns
        a dict of tensors on the runner's device: ``points3d (S*N, 3)``,
        ``valid (S*N,)``, ``colors (S*N, 3)``, ``query_frame (S*N,)``.
        """
        images = self._to_device(images)
        extrinsics = self._to_device(extrinsics)
        intrinsics = self._to_device(intrinsics)
        if extra_params is not None:
            extra_params = self._to_device(extra_params)
        S, H, W = images.shape[1:4]
        qp = grid_keypoints(H, W, num_extra, device=self.device)[None]
        N = qp.shape[1]
        chunk = max(256, self.cfg.max_points_num // S)
        L = S if by_neighbor <= 0 else max(2, min(S, by_neighbor))

        parts = {"points3d": [], "valid": [], "colors": [],
                 "query_frame": []}
        for q in range(S):
            n0 = 0 if L == S else int(np.clip(q - L // 2, 0, S - L))
            order = np.arange(n0, n0 + L)
            rel_q = q - n0
            order[0], order[rel_q] = order[rel_q], order[0]
            idx = torch.as_tensor(order, device=self.device)
            fmaps_q = fmaps[:, idx]
            tracked = [self._coarse_track(fmaps_q,
                                          qp[:, start: start + chunk],
                                          stage="extra_points.coarse")
                       for start in range(0, N, chunk)]
            tr = torch.cat([t for t, _ in tracked], dim=2)[0]  # (L, N, 2)
            vi = torch.cat([v for _, v in tracked], dim=2)[0]
            tn = cam_from_img(tr, intrinsics[idx],
                              None if extra_params is None
                              else extra_params[idx])
            pts, inl_num, _ = triangulate_tracks(
                extrinsics[idx], tn, track_vis=vi, max_ransac_iters=64,
                seed=7 + q)
            parts["points3d"].append(pts)
            # a 2-frame window can never reach 3 inliers: require what the
            # window can support
            parts["valid"].append(inl_num >= min(3, L))
            parts["colors"].append(track_colors(images[0, idx], tr,
                                                vi > 0.05))
            parts["query_frame"].append(torch.full(
                (N,), q, dtype=torch.int32, device=self.device))
        return {k: torch.cat(v) for k, v in parts.items()}

    def write_visuals(self, host: dict, images, output_dir: str) -> None:
        """OUT/visuals from host arrays (the export's copy): with
        `cfg.visual_query_points` each logged query frame's points
        (query_points_QQ_fFFFF.png), with `cfg.visual_tracks` the tracks
        over every frame (tracks_FFFF.png, tracks.gif, tracks.mp4), with
        `cfg.make_reproj_frames` the tracks against the reprojected points
        (reproj_FFFF.png, reproj.mp4); the mp4s only where OpenCV has a
        codec. images (S, H, W, 3) float in [0, 1] or uint8."""
        cfg = self.cfg
        vdir = os.path.join(output_dir, "visuals")
        if cfg.visual_query_points:
            def one(item):
                qi, (qframe, _, _) = item
                log = host["query_log"][str(qi)]
                visualize_query_points(
                    images[qframe], log["xy"],
                    os.path.join(vdir,
                                 f"query_points_{qi:02d}_f{qframe:04d}.png"),
                    valid=log["valid"] > 0.5)

            with ThreadPoolExecutor(VISUAL_WORKERS) as ex:
                list(ex.map(one, enumerate(self._query_point_log)))
        if cfg.visual_tracks:
            visualize_tracks(images, host["pred_track"][0],
                             host["pred_vis"][0], vdir)
        if cfg.make_reproj_frames:
            visualize_reprojections(
                images, host["pred_track"][0], host["points3d"],
                host["extrinsics"], host["intrinsics"], host["valid_tracks"],
                vdir, extra_params=host["extra_params"])

    def _load_depth_model(self) -> DepthAnything:
        """The DPT depth model, built on first use in the runner's
        precision: the checkpoint at `cfg.depth_checkpoint` when the path
        exists (24 ``pretrained.blocks`` make it the ViT-L configuration,
        else ViT-B; its register tokens, if any, counted), loaded strictly;
        seeded ViT-B weights otherwise."""
        if self._depth is None:
            ckpt = self.cfg.depth_checkpoint
            if ckpt and os.path.exists(ckpt):
                sd = torch.load(ckpt, map_location="cpu")
                depth = 1 + max(int(k.split(".")[2]) for k in sd
                                if k.startswith("pretrained.blocks."))
                regs = sd.get("pretrained.register_tokens")
                kw = {"dtype": self.dtype, "num_register_tokens":
                      0 if regs is None else regs.shape[1]}
                model = (DepthAnything.vitl(**kw) if depth == 24
                         else DepthAnything(**kw))
                model.load_state_dict(sd)
            else:
                model = DepthAnything(dtype=self.dtype)
                init_depth_anything_(
                    model, torch.Generator().manual_seed(self.cfg.seed))
            self._depth = model.to(self.device).eval()
        return self._depth

    @torch.inference_mode()
    def _disparity(self, images) -> torch.Tensor:
        """(1, S, H, W, 3) images in [0, 1] -> (S, H, W) relative
        disparity, f32: each frame resized to `cfg.depth_input_size`
        squared, through the DPT, resized back; one frame at a time, so
        the peak memory is one ViT forward."""
        model = self._load_depth_model()
        r = self.cfg.depth_input_size
        H, W = images.shape[2:4]
        out = []
        for s in range(images.shape[1]):
            with f32_matmuls():
                x = interpolate_bilinear(images[0, s:s + 1], (r, r))
            d = model(x)
            with f32_matmuls():
                out.append(interpolate_bilinear(d[..., None], (H, W))[..., 0])
        return torch.cat(out)

    @torch.inference_mode()
    def dense_reconstruct(self, images, predictions, sample_idx=None):
        """Monocular disparity per frame of (1, S, H, W, 3) images,
        aligned to the sparse solve's depths (`align_depth_maps_to_sfm`
        on the observations of the valid tracks; its RANSAC draws from a
        CPU generator seeded with `cfg.seed + 7`, or `sample_idx`
        (S, 256, 2)). Adds ``depth_maps`` (S, H, W), ``depth_align_coeffs``
        (S, 2) and ``depth_inlier_frac`` (S,) to `predictions` (tensors or
        numpy in; tensors on the runner's device out)."""
        images = self._to_device(images)
        disp = self._disparity(images)

        def dev(k, dtype=torch.float32):
            v = predictions[k]
            return torch.as_tensor(v if torch.is_tensor(v)
                                   else np.asarray(v)).to(self.device, dtype)

        obs = dev("valid_2d_mask", torch.bool) \
            & dev("valid_tracks", torch.bool)[None]
        depth_maps, a, b, inl = align_depth_maps_to_sfm(
            disp, dev("extrinsics"), dev("points3d"), dev("pred_track")[0],
            obs, torch.Generator().manual_seed(self.cfg.seed + 7),
            sample_idx=sample_idx)
        predictions.update(depth_maps=depth_maps,
                           depth_align_coeffs=torch.stack([a, b], dim=-1),
                           depth_inlier_frac=inl)
        return predictions

    @torch.inference_mode()
    def save_dense_depth_maps(self, depth_maps, image_names, output_dir,
                              crop_params=None):
        """OUT/depths/<image stem>.bin (COLMAP array format), one per frame
        of (S, H, W) depth maps; with crop_params, resampled on the maps'
        device to each original image's resolution (the export's inverse
        rescale: original pixel (x, y) lies at (x / ratio + left,
        y / ratio + top) in the square the maps cover; the grid built in
        f64, sampled in f32, bilinear, border-clamped)."""
        depth_dir = os.path.join(output_dir, "depths")
        os.makedirs(depth_dir, exist_ok=True)
        maps = torch.as_tensor(depth_maps if torch.is_tensor(depth_maps)
                               else np.asarray(depth_maps)).float()
        S = maps.shape[0]
        names = image_names or [f"image_{s:06d}" for s in range(S)]
        for s in range(S):
            dmap = maps[s]
            if crop_params is not None:
                real_w, real_h = (int(crop_params[s][0]),
                                  int(crop_params[s][1]))
                ratio = max(real_w, real_h) / float(self.cfg.img_size)
                left, top = np.abs(np.asarray(crop_params[s][4:6],
                                              np.float64))
                gx, gy = np.meshgrid(np.arange(real_w), np.arange(real_h))
                coords = torch.as_tensor(
                    np.stack([gx / ratio + left, gy / ratio + top],
                             axis=-1)[None], dtype=torch.float32,
                    device=maps.device)
                dmap = bilinear_sample(dmap[None, ..., None], coords,
                                       padding_mode="border")[0, ..., 0]
            stem = os.path.splitext(os.path.basename(names[s]))[0]
            write_colmap_array(os.path.join(depth_dir, stem + ".bin"),
                               dmap.cpu().numpy())

    def save_reconstruction(self, predictions, image_size, image_names,
                            output_dir, crop_params=None):
        """Write the COLMAP sparse model OUT/sparse/{cameras,images,
        points3D}.bin of a predictions dict (tensors or numpy, copied to
        the host once), in the original images' pixels when crop_params
        are given (reference runners/runner.py:887-911, :1009-1052);
        returns the `Reconstruction`. Timed as `export.build` (the
        Reconstruction) and `export.write` (the files).

        The observations are `valid_2d_mask & valid_tracks`; with
        `cfg.filter_invalid_frame` the invalid frames' observations are
        dropped and their images removed. Colors become uint8 (x 255,
        clipped). With ``additional_points`` in the predictions, their
        valid points go to OUT/additional_points.npz and, with
        `cfg.concat_extra_points`, into the model as trackless points
        after the tracked ones."""
        cfg = self.cfg
        p = to_host({k: predictions.get(k) for k in EXPORT_KEYS})
        extra = p["additional_points"]
        with self._stage("export.build"):
            valid = p["valid_tracks"]
            obs = p["valid_2d_mask"] & valid[None]
            valid_frames = p["valid_frame_mask"]
            filter_frames = cfg.filter_invalid_frame and \
                valid_frames is not None
            if filter_frames:
                # no point track may reference a frame about to be removed
                obs = obs & valid_frames[:, None]
            colors = p["colors"]
            rec = arrays_to_reconstruction(
                p["points3d"], p["extrinsics"], p["intrinsics"],
                p["pred_track"][0], obs, image_size,
                extra_params=p["extra_params"],
                shared_camera=cfg.shared_camera,
                camera_type=cfg.camera_type, image_names=image_names,
                colors=(None if colors is None
                        else np.clip(colors * 255, 0, 255).astype(np.uint8)))
            if filter_frames:
                for s in np.nonzero(~valid_frames)[0]:
                    rec.images.pop(int(s) + 1, None)
            if extra is not None and cfg.concat_extra_points:
                # trackless points (reference add_point3D with an empty
                # Track, runners/runner.py:549-560)
                next_id = (max(rec.points3D) + 1) if rec.points3D else 1
                rgb255 = np.clip(extra["colors"] * 255, 0,
                                 255).astype(np.uint8)
                for i in np.nonzero(extra["valid"])[0]:
                    rec.points3D[next_id] = Point3D(
                        id=next_id,
                        xyz=np.asarray(extra["points3d"][i], np.float64),
                        rgb=rgb255[i], error=0.0,
                        image_ids=np.zeros((0,), np.int32),
                        point2D_idxs=np.zeros((0,), np.int32))
                    next_id += 1
            if crop_params is not None:
                rec = rescale_reconstruction_to_original(
                    rec, crop_params, cfg.img_size, image_names=image_names,
                    shared_camera=cfg.shared_camera)
        with self._stage("export.write"):
            if extra is not None:
                os.makedirs(output_dir, exist_ok=True)
                np.savez_compressed(
                    os.path.join(output_dir, "additional_points.npz"),
                    points3d=extra["points3d"][extra["valid"]],
                    colors=extra["colors"][extra["valid"]],
                    sfm_points_num=int(valid.sum()),
                    additional_points_num=int(extra["valid"].sum()))
            write_model(rec, os.path.join(output_dir, "sparse"), ext=".bin")
        return rec

    def run_scene(self, scene_dir: str, output_dir: str | None = None,
                  load_gt: bool = False):
        """Load a scene folder (`DemoLoader` at `cfg.img_size`: images/
        or bare image files, masks/ when present) and reconstruct it,
        exporting to `output_dir` in the original images' pixels. With
        `load_gt`, the COLMAP model under SCENE/sparse[/0] is read and the
        predictions gain ``gt_auc30`` (AUC@30 of the frames matched to it
        by image name) and ``gt_frames_matched``."""
        data = DemoLoader(scene_dir, img_size=self.cfg.img_size,
                          load_gt=load_gt).load()
        predictions = self.sparse_reconstruct(
            data["images"], masks=data["masks"],
            image_names=data["image_names"], output_dir=output_dir,
            crop_params=data["crop_params"])
        gt = data.get("gt")
        if load_gt and gt is not None:
            # by image NAME: COLMAP numbers images in registration order
            # and may register a subset
            gt_by_name = {n: i for i, n in enumerate(gt["image_names"])}
            pairs = [(i, gt_by_name[n])
                     for i, n in enumerate(data["image_names"])
                     if n in gt_by_name]
            if len(pairs) >= 2:
                pred_idx, gt_idx = (list(x) for x in zip(*pairs))
                extr = predictions["extrinsics"]
                predictions["gt_auc30"] = float(pose_auc30(
                    extr[torch.as_tensor(pred_idx, device=extr.device)],
                    torch.as_tensor(gt["extrinsics"][gt_idx],
                                    dtype=torch.float32,
                                    device=extr.device)))
                predictions["gt_frames_matched"] = len(pred_idx)
        return predictions
