"""VGGSfMRunner, the sparse pipeline through the SfM solve: query-frame
ranking, camera initialization, query-point extraction and tracking
(feature maps -> coarse tracks -> fine tracks, chunked over query points),
the re-query of frames that see too few points, the preliminary two-view
cameras, the hybrid choice of the SfM's initial cameras, the SfM solve and
its gauge normalization. Counterpart of those parts of
vggsfm_tpu/runner.py (`_score_camera_init`, `select_query_frames`,
`_fmaps`, `_query_points`, `_coarse_track`, `_fine_track`,
`predict_tracks`, `_comple_nonvis`, `sparse_reconstruct`'s steps 1-6 and
the normalization, `_choose_camera_init`; reference
runners/runner.py:292-633, 1068-1282).

Runs on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from vggsfm_tpu_torch.extractors.dispatch import (
    get_query_points,
    get_query_points_batched,
)
from vggsfm_tpu_torch.geometry.cameras import (
    cam_from_img,
    pose_encoding_to_extri_intri,
)
from vggsfm_tpu_torch.models.camera import CameraPredictor, init_camera_
from vggsfm_tpu_torch.models.refine import refine_track
from vggsfm_tpu_torch.models.tracker import TrackerPredictor, init_tracker_
from vggsfm_tpu_torch.ops.triangulation import triangulate_by_pair
from vggsfm_tpu_torch.sfm.normalize import normalize_reconstruction
from vggsfm_tpu_torch.sfm.triangulator import SfmConfig, run_sfm
from vggsfm_tpu_torch.twoview.preliminary import estimate_preliminary_cameras
from vggsfm_tpu_torch.utils.camera_avg import (
    average_camera_prediction,
    rank_by_dino_similarity,
    rank_by_interval,
    rank_by_midpoint,
)
from vggsfm_tpu_torch.utils.device import resolve_device


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


@dataclasses.dataclass
class RunnerConfig:
    """The fields of vggsfm_tpu.runner.RunnerConfig that the stages
    through the SfM solve read."""

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


class VGGSfMRunner:
    """`state_dict` / `camera_state_dict`: the tracker's and the camera
    predictor's weights (the reference checkpoint's ``track_predictor.*``
    and ``camera_predictor.*`` entries, prefix stripped); seeded random
    weights otherwise. The camera predictor is built on its first use."""

    def __init__(self, cfg: RunnerConfig = RunnerConfig(), device="cuda",
                 state_dict: dict | None = None,
                 camera_state_dict: dict | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
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
        """Accumulate the wall time of a stage, device work included."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device, torch.float32)

    @torch.inference_mode()
    def _coarse_track(self, fmaps, qp):
        minit = self.cfg.matching_init
        mvis = minit and not self._weights_loaded
        with self._stage("coarse"):
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
        generator seeded with `cfg.seed`.
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
            return qps, valids

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
    def sparse_reconstruct(self, images, masks=None):
        """The sparse pipeline on (S, H, W, 3) images in [0, 1] (uint8
        images are scaled): the JAX runner's steps 1 to 6 in its order and
        under its `timings` keys: `query_rank`, the `center_order` swap,
        `camera_init`, `fmaps`, `tracking` (`track_frames`:
        `query_points`, `coarse`, `fine` within it), `preliminary`, the
        camera-init choice (`camera_choice`; the JAX runner leaves the
        choice untimed), the SfM solve (`sfm`, its parts `sfm.<part>`),
        then the gauge normalization. masks: optional (S, H, W)
        segmentation, pixels above 0.5 invalid for query points.

        Returns the JAX runner's keys: the solve's ``extrinsics``
        (S, 3, 4, normalized), ``intrinsics`` (S, 3, 3), ``extra_params``
        (S, K) or None, ``points3d`` (P, 3, normalized), ``valid_tracks``
        (P,), ``valid_2d_mask`` (S, P), ``valid_frame_mask`` (S,),
        ``init_idx``; the tracks ``pred_track`` (1, S, P, 2),
        ``pred_vis`` and ``pred_score`` (1, S, P); and ``preliminary``
        (the dict of `preliminary`, in the solve's frame order), the
        chosen initial cameras ``init_extrinsics`` and
        ``init_intrinsics``, ``init_scores`` ([neural, two-view] support,
        or None), ``query_indices`` and ``timings``. With `center_order`
        the per-frame outputs are swapped back to the caller's frame order
        and ``center_perm`` is set. Colors and the export come with the
        next slice of the port.
        """
        cfg = self.cfg
        x = torch.as_tensor(images if torch.is_tensor(images)
                            else np.asarray(images)).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        images = x[None]
        S, H, W = images.shape[1:4]
        self.timings = {}

        # 1. query frames
        query_indices = self.select_query_frames(images)
        # 1b. center_order: swap the top-ranked frame with frame 0 (a
        # self-inverse permutation), swapped back before returning
        center_perm = None
        if cfg.center_order and query_indices and query_indices[0] != 0:
            center = query_indices[0]
            center_perm = np.arange(S)
            center_perm[0], center_perm[center] = center, 0
            images = images[:, torch.as_tensor(center_perm,
                                               device=self.device)]
            if masks is not None:
                masks = np.asarray(masks)[center_perm]
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
        out.update(pred_track=track, pred_vis=vis, pred_score=score,
                   preliminary=pre, init_extrinsics=extr,
                   init_intrinsics=intr, init_scores=scores,
                   query_indices=query_indices,
                   timings=dict(self.timings))
        if center_perm is not None:
            perm = torch.as_tensor(center_perm, device=self.device)
            for k in ("extrinsics", "intrinsics", "extra_params",
                      "valid_frame_mask", "valid_2d_mask",
                      "init_extrinsics", "init_intrinsics"):
                if out[k] is not None:
                    out[k] = out[k][perm]
            for k in ("pred_track", "pred_vis", "pred_score"):
                out[k] = out[k][:, perm]
            out["center_perm"] = center_perm
        return out
