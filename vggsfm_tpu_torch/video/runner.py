"""Windowed incremental reconstruction for long sequences (PyTorch).
Counterpart of vggsfm_tpu/video/runner.py (reference
vggsfm/runners/video_runner.py):
  * process_initial_window (:121-140)  -> the sparse runner's solve of the
    initial window;
  * move_window / prepare_window_data (:640-751, :1051-1187) -> track map
    points + fresh queries through each window;
  * align_next_window (:941-1017)      -> PnP + pose refinement against the
    frozen map (every new frame of the window at once);
  * triangulate_window_points (:1189-1262) -> LORANSAC triangulation of the
    new tracks over the window;
  * windowed BA with constant old poses/points (:800-836, 1321-1331) ->
    the dense LM with freeze masks;
  * joint_BA (:494-541)                -> the sparse implicit-Schur LM over
    the whole registered sequence (ba/sparse_lm.py).

The map lives on the host as growing numpy registries (points, flat
observations); the solves run on the sparse runner's device. Windows are
padded as in the JAX package, where the padding keeps every step at a
fixed shape: the window is filled to `window_size + 1` frames by repeating
its last frame, and those repeats go through the tracker, whose time
attention sees them, so the tracks depend on the padding. The query budget
is `max_query_pts * pts_mult` map slots, then as many fresh points.

Random draws come from CPU generators seeded with the integers the JAX
package feeds its PRNG keys: the fresh query points `seed + 17 * start +
pts_mult` (`_fresh_queries`), the PnP minimal sets `seed + start`
(`_pnp_samples`); the window triangulation's pair schedule is numpy,
seeded with the window's end, in both packages. Runs where the sparse
runner runs (the GPU unless it was built with device="cpu").
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from vggsfm_tpu_torch.ba import (
    BAConfig,
    SparseBAConfig,
    bundle_adjust,
    bundle_adjust_sparse,
)
from vggsfm_tpu_torch.extractors.dispatch import get_query_points
from vggsfm_tpu_torch.geometry.alignment import (
    align_camera_extrinsics,
    apply_transformation,
)
from vggsfm_tpu_torch.geometry.cameras import (
    cam_from_img,
    pose_encoding_to_extri_intri,
    project_points,
)
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
from vggsfm_tpu_torch.ops.triangulation import triangulate_tracks
from vggsfm_tpu_torch.parallel.merge import (
    frame_block,
    fuse_duplicate_points,
    merge_partial_maps,
    save_partial,
    wait_for_partials,
)
from vggsfm_tpu_torch.parallel.mesh import make_mesh
from vggsfm_tpu_torch.parallel.multihost import distributed_bundle_adjust
from vggsfm_tpu_torch.sfm.normalize import (
    filter_map_observations,
    normalize_reconstruction,
)
from vggsfm_tpu_torch.sfm.refine import refine_poses
from vggsfm_tpu_torch.twoview.pnp import absolute_pose_ransac
from vggsfm_tpu_torch.twoview.utils import generate_samples
from vggsfm_tpu_torch.utils import trace

# PnP budget of a window attempt (the JAX runner's absolute_pose_ransac
# arguments)
_PNP_ITERS = 128


@dataclasses.dataclass
class VideoConfig:
    # reference video operating point (cfgs/video_demo.yaml:6-13):
    # 32/16/6 windows; the shipped CLI additionally defaults to a shared
    # SIMPLE_RADIAL camera + midpoint query ranking (video_demo.py)
    init_window_size: int = 32
    window_size: int = 16
    joint_ba_interval: int = 6
    max_query_pts: int = 1024
    query_method: str = "auto"  # see extractors/dispatch.py
    min_inlier_per_frame: int = 30
    max_reproj_error: float = 4.0
    vis_thresh: float = 0.05
    seed: int = 0
    # ---- robustness retries (parity: video_runner.py:712-751, :169-176)
    # when PnP registration collapses: retry with 2x query points, then a
    # shrunk window, then step the query frame back; finally fall back to
    # camera-predictor poses aligned onto the map (:655-686).
    min_window_size: int = 2
    max_step_back: int = 2
    align_with_camera_predictor: bool = True
    # one shared camera across the sequence (joint BA ties the focal step)
    shared_camera: bool = True
    # SIMPLE_PINHOLE | SIMPLE_RADIAL — the reference's video default is
    # SIMPLE_RADIAL with a shared camera (cfgs/video_demo.yaml). With
    # SIMPLE_RADIAL one radial coefficient per frame is carried through
    # the incremental map (PnP registers on undistorted pixels; the
    # joint BA refines k, tied when shared_camera)
    camera_type: str = "SIMPLE_PINHOLE"
    # shard the joint BA's observations over this many ranks of the
    # default process group (parallel/multihost.py
    # distributed_bundle_adjust); <= 1, or a group of fewer ranks, keeps
    # the plain solver. One process drives one card, so the ranks stand
    # where the JAX package counts its devices
    distributed_ba_devices: int = 0
    # 3D cell size for duplicate-track fusion at the multi-host map merge
    # (parallel/merge.py fuse_duplicate_points)
    merge_fuse_tol: float = 0.02


class MapRegistry:
    """Host-side map state: growing point + observation stores."""

    def __init__(self):
        self.xyz = np.zeros((0, 3), np.float32)
        self.obs_frame = np.zeros((0,), np.int32)
        self.obs_point = np.zeros((0,), np.int32)
        self.obs_xy = np.zeros((0, 2), np.float32)

    def save(self, path: str) -> None:
        np.savez_compressed(path, xyz=self.xyz, obs_frame=self.obs_frame,
                            obs_point=self.obs_point, obs_xy=self.obs_xy)

    @classmethod
    def load(cls, path: str) -> "MapRegistry":
        data = np.load(path)
        reg = cls()
        reg.xyz = data["xyz"]
        reg.obs_frame = data["obs_frame"]
        reg.obs_point = data["obs_point"]
        reg.obs_xy = data["obs_xy"]
        return reg

    @property
    def num_points(self):
        return len(self.xyz)

    def add_points(self, xyz: np.ndarray) -> np.ndarray:
        start = self.num_points
        self.xyz = np.concatenate([self.xyz, np.asarray(xyz, np.float32)])
        return np.arange(start, self.num_points, dtype=np.int32)

    def add_observations(self, frames, points, xys):
        self.obs_frame = np.concatenate(
            [self.obs_frame, np.asarray(frames, np.int32)])
        self.obs_point = np.concatenate(
            [self.obs_point, np.asarray(points, np.int32)])
        self.obs_xy = np.concatenate(
            [self.obs_xy, np.asarray(xys, np.float32)])


def _np(x):
    """A host numpy copy of a tensor (or the array itself)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class VideoRunner:
    """Incremental runner driving a VGGSfMRunner's models over windows.

    `timings` accumulates the wall time of the stages `video.init`,
    `video.windows` (one stage `video.window` a window; its tracker calls
    also under `video.track`) and `video.joint_ba` (`utils/trace.py`);
    `windows` holds one record per processed window, from its stage: its
    frames, the attempts of the retry schedule it took, the frames PnP
    registered, whether the camera fill ran, its wall time and its
    tracker time."""

    def __init__(self, sparse_runner, cfg: VideoConfig = VideoConfig()):
        self.r = sparse_runner
        self.cfg = cfg
        self.device = sparse_runner.device
        self.timings: dict = {}
        self.windows: list = []
        self._mesh = None  # the joint BA's mesh, made on first use

    # ------------------------------------------------------------------

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        """A numpy array (or tensor) on the runner's device."""
        x = x if torch.is_tensor(x) else torch.as_tensor(
            np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def _track_window(self, images_w, query_xy, frames_w=None):
        """Track query points (N, 2) through window frames (Sw, R, R, 3).

        Frame 0 of the window is the query frame; `frames_w` carries the
        global frame indices (informational: lets tests substitute an
        oracle tracker). Returns (tracks (Sw, N, 2), vis (Sw, N)) as numpy.
        """
        with trace.stage("video.track", self.timings, self.device):
            imgs = self.r._to_device(images_w)[None]
            fmaps = self.r.fmaps(imgs)
            track, vis = self.r._coarse_track(
                fmaps, self.r._to_device(query_xy)[None])
            if self.r.cfg.fine_tracking:
                track, _ = self.r._fine_track(imgs, track)
            return _np(track[0].float()), _np(vis[0].float())

    def _undistort_px(self, tracks, intrinsics, extra):
        """Distorted pixels -> ideal pinhole pixels (same K).

        PnP and DLT triangulation are pinhole solvers; with SIMPLE_RADIAL
        the observations are first mapped through the Newton undistortion
        (cam_from_img) and re-projected with the bare K.
        """
        if extra is None:
            return tracks
        tn = cam_from_img(self._t(tracks), self._t(intrinsics),
                          self._t(extra))
        f = self._t(intrinsics[..., 0:1, 0:1])
        pp = self._t(intrinsics[..., :2, 2][..., None, :])
        return _np(tn * f + pp)

    def _fresh_queries(self, image, start: int, pts_mult: int, budget: int):
        """The fresh query points of a window attempt on its query frame:
        (xy (budget, 2), valid (budget,)) as numpy, the subsample drawn
        from a CPU generator seeded `seed + 17 * start + pts_mult` (the
        JAX package's key)."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed + 17 * start + pts_mult)
        xy, valid = get_query_points(self._t(image), gen,
                                     self.cfg.query_method, budget)
        return _np(xy), _np(valid)

    def _pnp_samples(self, start: int, budget: int) -> torch.Tensor:
        """The PnP minimal sets of a window attempt, (_PNP_ITERS, 6) indices
        into the map slots, from a CPU generator seeded `seed + start`
        (the JAX package's key)."""
        gen = torch.Generator().manual_seed(self.cfg.seed + start)
        return generate_samples(gen, budget, _PNP_ITERS, 6)[0]

    def _attempt_window(self, images, reg, extrinsics, intrinsics, q,
                        start, w_end, pts_mult=1, pad_frames=None,
                        extra=None):
        """Track from query frame `q` through [start, w_end) and
        PnP-register the new frames against the frozen map.

        One attempt of the retry schedule (parity: video_runner.py's
        prepare_window_data + align_next_window, :941-1017). Returns a
        dict with the tracked window and per-frame PnP results; ``ok``
        marks frames whose inlier count clears `min_inlier_per_frame`.
        """
        cfg = self.cfg
        H = W = images.shape[1]
        frames_w = [q] + list(range(start, w_end))
        Sw = len(frames_w)
        # the JAX package's fixed shapes: the query budget and the window
        # length padded to their schedule values (the padding reaches the
        # tracker, so it is kept)
        budget = cfg.max_query_pts * pts_mult
        Sw_full = max(pad_frames or Sw, Sw)
        frames_pad = frames_w + [frames_w[-1]] * (Sw_full - Sw)

        # query points: reprojected map points visible in q + fresh
        proj_q = _np(project_points(
            self._t(reg.xyz), self._t(extrinsics[q][None]),
            self._t(intrinsics[q][None]),
            extra_params=(None if extra is None
                          else self._t(extra[q][None]))))[0]
        vis_q = ((proj_q[:, 0] >= 0) & (proj_q[:, 0] < W)
                 & (proj_q[:, 1] >= 0) & (proj_q[:, 1] < H))
        map_sel = np.nonzero(vis_q)[0][-budget:]
        n_map = len(map_sel)
        map_xy = np.zeros((budget, 2), np.float32)
        map_xy[:n_map] = proj_q[map_sel]
        map_ids = np.zeros((budget,), np.int32)
        map_ids[:n_map] = map_sel
        map_valid = np.zeros((budget,), bool)
        map_valid[:n_map] = True

        fresh_xy, fresh_valid = self._fresh_queries(images[q], start,
                                                    pts_mult, budget)
        query_xy = np.concatenate([map_xy, fresh_xy], axis=0)
        valid = np.concatenate([map_valid, fresh_valid])
        tracks_p, vis_p = self._track_window(images[frames_pad], query_xy,
                                             frames_w=frames_pad)
        tracks_w = tracks_p[:Sw]
        vis_w = vis_p[:Sw] * valid[None]

        map_tracks = tracks_w[:, :budget]  # (Sw, budget, 2)
        map_vis = (vis_w[:, :budget] > cfg.vis_thresh) & map_valid[None]
        X_map = np.zeros((budget, 3), np.float32)
        X_map[:n_map] = reg.xyz[map_sel]

        if n_map >= 6:
            pnp_px = self._undistort_px(
                tracks_p[1:, :budget], intrinsics[q],
                None if extra is None else extra[q])
            with trace.span("video.pnp"):
                pnp = absolute_pose_ransac(
                    self._t(np.repeat(X_map[None], Sw_full - 1, 0)),
                    self._t(pnp_px),
                    self._t(np.repeat(intrinsics[q][None], Sw_full - 1, 0)),
                    valid_mask=self._t(
                        (vis_p[1:, :budget] > cfg.vis_thresh)
                        & map_valid[None], torch.bool),
                    max_ransac_iters=_PNP_ITERS, lo_num=16, f_trials=1,
                    sample_idx=self._pnp_samples(start, budget))
                extr_new = _np(pnp["extrinsics"])[:Sw - 1]
                ok = (_np(pnp["inlier_num"])
                      >= cfg.min_inlier_per_frame)[:Sw - 1]
        else:
            extr_new = np.repeat(extrinsics[q][None], Sw - 1, 0)
            ok = np.zeros((Sw - 1,), bool)
        return {"q": q, "w_end": w_end, "frames_w": frames_w,
                "tracks": tracks_w, "vis": vis_w, "n_map": n_map,
                "budget": budget, "map_ids": map_ids,
                "map_tracks": map_tracks, "map_vis": map_vis,
                "extr_new": extr_new, "ok": ok}

    def _camera_align_window(self, images_w, extr_w, anchors, image_hw):
        """Camera-predictor poses for a window, SE3+scale-aligned onto the
        trusted (anchor) frames of the registered trajectory.

        Parity: video_runner.py:655-686 (predict_cameras per window +
        utils/align.py:145-252 alignment). Returns (Sw, 3, 4) aligned
        extrinsics, or None when there are no anchors to align against.
        """
        n_anchor = int(np.asarray(anchors).sum())
        if n_anchor < 1:
            return None
        pe = self.r.camera_forward(np.asarray(images_w)[None])[
            "pred_pose_enc"]
        extr_pred, _ = pose_encoding_to_extri_intri(pe[0], image_hw)
        a_idx = torch.as_tensor(np.nonzero(np.asarray(anchors))[0],
                                device=extr_pred.device)
        R_a, T_a, s_a = align_camera_extrinsics(
            extr_pred[a_idx], self._t(np.asarray(extr_w))[a_idx],
            estimate_scale=n_anchor > 1)
        return _np(apply_transformation(extr_pred, R_a, T_a, s_a))

    def save_checkpoint(self, path: str, reg, extrinsics, intrinsics,
                        registered, end: int, windows_done: int,
                        extra=None) -> None:
        """Persist the full incremental state (resume point): the map
        registry (`path.map.npz`) + camera arrays and window cursor
        (`path.state.npz`), the JAX package's keys."""
        reg.save(path + ".map.npz")
        state = dict(extrinsics=extrinsics, intrinsics=intrinsics,
                     registered=registered, end=end,
                     windows_done=windows_done)
        if extra is not None:
            state["extra_params"] = extra
        np.savez_compressed(path + ".state.npz", **state)

    @staticmethod
    def load_checkpoint(path: str):
        reg = MapRegistry.load(path + ".map.npz")
        st = np.load(path + ".state.npz")
        extra = (st["extra_params"].copy()
                 if "extra_params" in st.files else None)
        return (reg, st["extrinsics"].copy(), st["intrinsics"].copy(),
                st["registered"].copy(), int(st["end"]),
                int(st["windows_done"]), extra)

    def _process_range(self, images, reg, extrinsics, intrinsics, extra,
                       registered, end, stop, windows_done,
                       checkpoint_path=None, joint_ba=True):
        """Advance the incremental pipeline over frames [end, stop).

        Each window's query is the nearest registered frame before `end`
        (single-host: simply end-1; a multi-host block's first window
        anchors on the shared initial window). `joint_ba=False` skips the
        periodic joint BA + gauge normalization — multi-host block
        processing must leave the shared map prefix and the block's gauge
        untouched so host-0's merge + ONE global joint BA (the only
        cross-host steps) sees consistent coordinates.

        Returns the advanced (end, windows_done).
        """
        cfg = self.cfg
        while end < stop:
            with trace.stage("video.window", self.timings, self.device,
                             key="video.windows") as win:
                end = self._window(win, images, reg, extrinsics,
                                   intrinsics, extra, registered, end, stop)
            windows_done += 1
            self.windows.append({
                **win.attrs, "seconds": win.seconds,
                "track_seconds": win.inner.get("video.track", 0.0)})

            if windows_done % cfg.joint_ba_interval == 0 or end >= stop:
                if joint_ba:
                    self._joint_ba(extrinsics, intrinsics, reg, registered,
                                   extra=extra)
                if checkpoint_path is not None:
                    self.save_checkpoint(checkpoint_path, reg, extrinsics,
                                         intrinsics, registered, end,
                                         windows_done, extra=extra)

        return end, windows_done

    def _window(self, win, images, reg, extrinsics, intrinsics, extra,
                registered, end, stop) -> int:
        """One window from frame `end`: its attempts of the retry
        schedule, the PnP registration (or the fill), the pose
        refinement, the new map observations, the triangulation of the
        fresh tracks and the window BA, all on the arrays in place.
        Notes the window's record on the stage `win` and returns the
        window's end."""
        cfg = self.cfg
        W = images.shape[2]
        H = images.shape[1]
        # ---- retry schedule when PnP registration collapses:
        # full window -> 2x query points -> shrunk window -> step the
        # query frame back (parity: video_runner.py:712-751, :169-176)
        regd = np.nonzero(registered[:end])[0]
        q0 = int(regd[-1])
        schedule = [
            (q0, cfg.window_size, 1),
            (q0, cfg.window_size, 2),
            (q0, max(cfg.min_window_size, cfg.window_size // 2), 2),
        ]
        for back in range(1, cfg.max_step_back + 1):
            if len(regd) > back:
                schedule.append((int(regd[-1 - back]),
                                 cfg.window_size, 2))
        res = None
        attempts = 0
        for q, wsz, mult in schedule:
            attempts += 1
            attempt = self._attempt_window(
                images, reg, extrinsics, intrinsics, q, end,
                min(end + wsz, stop), mult, pad_frames=wsz + 1,
                extra=extra)
            if attempt["ok"].any():
                res = attempt
                break
        if res is None:
            res = attempt  # nothing registered by PnP; fall through

        q = res["q"]
        w_end = res["w_end"]
        frames_w = res["frames_w"]
        Sw = len(frames_w)
        new_frames = frames_w[1:]
        tracks_w, vis_w = res["tracks"], res["vis"]
        n_map, map_ids = res["n_map"], res["map_ids"]
        budget = res["budget"]
        map_tracks, map_vis = res["map_tracks"], res["map_vis"]
        X_map = reg.xyz[map_ids]
        extr_new, ok = res["extr_new"], res["ok"]

        # ---- fill frames PnP could not place: camera-predictor poses
        # aligned SE3+scale onto the registered map (parity:
        # video_runner.py:655-686 via utils/align.py:145-252), else the
        # query pose
        fill = np.repeat(extrinsics[q][None], Sw - 1, 0)
        camera_aligned = False
        if not ok.all() and cfg.align_with_camera_predictor:
            # anchor poses must be the CURRENT estimates: the query's
            # registered pose + this window's fresh PnP results (the
            # global rows of the new frames are still unset)
            anchor_extr = np.concatenate(
                [extrinsics[q][None], extr_new], axis=0)
            aligned = self._camera_align_window(
                images[frames_w], anchor_extr,
                np.concatenate([[True], ok]), (W, H))
            if aligned is not None:
                fill = aligned[1:]
                camera_aligned = True
        extr_new = np.where(ok[:, None, None], extr_new, fill)
        for i, fidx in enumerate(new_frames):
            extrinsics[fidx] = extr_new[i]
            intrinsics[fidx] = intrinsics[q]
            if extra is not None:
                extra[fidx] = extra[q]
            registered[fidx] = True

        if n_map >= 6:
            # refine new poses against the frozen map
            extr_w, _, _, _ = refine_poses(
                self._t(extrinsics[frames_w]),
                self._t(intrinsics[frames_w]), self._t(X_map),
                self._t(map_tracks), self._t(map_vis, torch.bool),
                (W, H),
                extra_params=(None if extra is None
                              else self._t(extra[frames_w])),
                refine_intrinsics=False)
            extr_w = _np(extr_w)
            for i, fidx in enumerate(frames_w[1:], start=1):
                extrinsics[fidx] = extr_w[i]

        # record observations of map points in the new frames
        for i, fidx in enumerate(new_frames, start=1):
            seen = np.nonzero(map_vis[i])[0]
            reg.add_observations(
                np.full(len(seen), fidx), map_ids[seen],
                map_tracks[i][seen])

        # ---- triangulate fresh tracks over the window
        fresh_tracks = tracks_w[:, budget:]
        fresh_vis = vis_w[:, budget:]
        tn = cam_from_img(self._t(fresh_tracks),
                          self._t(intrinsics[frames_w]),
                          None if extra is None
                          else self._t(extra[frames_w]))
        pts_new, inl_num, inl_mask = triangulate_tracks(
            self._t(extrinsics[frames_w]), tn,
            track_vis=self._t(fresh_vis), max_ransac_iters=32,
            seed=end)
        pts_new = _np(pts_new)
        inl_mask = _np(inl_mask).T  # (Sw, Nf)
        keep = _np(inl_num) >= 2
        pts_new = np.where(keep[:, None], pts_new, 0.0)

        # ---- per-window BA: jointly polish the window's new poses and
        # new points against the tracked observations, with the query
        # pose and all pre-existing map points held constant (parity:
        # video_runner.py:800-836)
        if n_map >= 6 and keep.any():
            with trace.span("video.window_ba"):
                extr_w_ba, pts_new = self._window_ba(
                    extrinsics[frames_w], intrinsics[frames_w],
                    None if extra is None else extra[frames_w],
                    X_map, map_tracks, map_vis, pts_new, fresh_tracks,
                    inl_mask & keep[None], keep)
            for i, fidx in enumerate(frames_w[1:], start=1):
                extrinsics[fidx] = extr_w_ba[i]

        new_ids = reg.add_points(pts_new[keep])
        fr_i, pv_i = np.nonzero(inl_mask[:, keep])
        frame_lookup = np.asarray(frames_w)
        reg.add_observations(frame_lookup[fr_i], new_ids[pv_i],
                             fresh_tracks[:, keep][fr_i, pv_i])

        win.note(frames=[int(frames_w[1]), int(w_end)], query=int(q),
                 attempts=attempts, registered_by_pnp=int(ok.sum()),
                 camera_aligned=camera_aligned)
        return w_end

    def _initial_map(self, images):
        """Bootstrap state: full sparse solve of the initial window.

        Returns (reg, extrinsics, intrinsics, extra | None, registered,
        end). Deterministic for fixed inputs/config — every host of a
        multi-host run computes an identical initial map, which is what
        lets their blocks merge without a broadcast step.
        """
        cfg = self.cfg
        T = images.shape[0]
        radial = cfg.camera_type == "SIMPLE_RADIAL"
        reg = MapRegistry()
        extrinsics = np.zeros((T, 3, 4), np.float32)
        intrinsics = np.zeros((T, 3, 3), np.float32)
        extra = np.zeros((T, 1), np.float32) if radial else None
        registered = np.zeros((T,), bool)

        # ---- initial window: full sparse solve (the sparse runner
        # must use the same camera model for the init window's
        # extra params to exist)
        S0 = min(cfg.init_window_size, T)
        with trace.stage("video.init", self.timings, self.device):
            init = self.r.sparse_reconstruct(images[:S0])
            extrinsics[:S0] = _np(init["extrinsics"])
            intrinsics[:S0] = _np(init["intrinsics"])
            if radial and init.get("extra_params") is not None:
                extra[:S0] = _np(init["extra_params"])
            registered[:S0] = True

            valid = _np(init["valid_tracks"]).astype(bool)
            pts = _np(init["points3d"])[valid]
            obs2d = _np(init["valid_2d_mask"])[:, valid]
            track2d = _np(init["pred_track"])[0][:, valid]
        pids = reg.add_points(pts)
        fr, pv = np.nonzero(obs2d)
        reg.add_observations(fr, pids[pv], track2d[fr, pv])
        return reg, extrinsics, intrinsics, extra, registered, S0

    def run_multihost(self, images: np.ndarray, num_hosts: int,
                      host_id: int, exchange_dir: str,
                      output_dir: str | None = None,
                      image_names: list | None = None,
                      crop_params: np.ndarray | None = None,
                      merge_timeout_s: float = 1800.0):
        """Multi-host incremental reconstruction (frame-window axis):
        every host computes the same initial map, processes a CONTIGUOUS
        block of the remaining frames (per-window BA bounds in-block
        drift; no local joint BA so the shared prefix and gauge stay
        merge-consistent), publishes its partial map to `exchange_dir`,
        and host 0 merges (id offsets + duplicate-track fusion), runs ONE
        global joint BA and exports. The exchange is files: no process
        group.

        Returns predictions on host 0, None on other hosts.
        """
        T, R_img = images.shape[0], images.shape[1]
        (reg, extrinsics, intrinsics, extra, registered,
         S0) = self._initial_map(images)
        shared_points = reg.num_points

        b0, b1 = frame_block(T, S0, num_hosts, host_id)
        if b1 > b0:
            self._process_range(images, reg, extrinsics, intrinsics,
                                extra, registered, b0, b1, 0,
                                joint_ba=False)
        save_partial(exchange_dir, host_id, reg, extrinsics, intrinsics,
                     extra, registered, shared_points, (b0, b1))
        if host_id != 0:
            return None

        partials = wait_for_partials(exchange_dir, num_hosts,
                                     timeout_s=merge_timeout_s)
        reg, extrinsics, intrinsics, extra, registered = \
            merge_partial_maps(partials, MapRegistry)
        fuse_duplicate_points(reg, shared_points,
                              tol=self.cfg.merge_fuse_tol)
        self._joint_ba(extrinsics, intrinsics, reg, registered,
                       extra=extra)

        colors = self._point_colors(images, reg)
        predictions = {
            "extrinsics": extrinsics,
            "intrinsics": intrinsics,
            "extra_params": extra,
            "points3d": reg.xyz,
            "colors": colors,
            "registered": registered,
            "num_points": reg.num_points,
            "num_observations": len(reg.obs_frame),
        }
        if output_dir is not None:
            self._export(predictions, reg, (R_img, R_img), output_dir,
                         image_names=image_names, crop_params=crop_params)
        return predictions

    def run(self, images: np.ndarray, output_dir: str | None = None,
            resume_from: str | None = None,
            checkpoint_path: str | None = None,
            image_names: list | None = None,
            crop_params: np.ndarray | None = None):
        """images: (T, R, R, 3) in [0, 1]. Returns predictions dict
        (numpy arrays).

        `resume_from` restores a prior `checkpoint_path` state and
        continues from its window cursor; `checkpoint_path` saves state
        after every joint BA. `image_names`/`crop_params` flow to the
        COLMAP export (real filenames + original-resolution rescale,
        parity: video_runner.py:198-206 back_to_original_resolution).
        """
        with trace.call("video.run"):
            cfg = self.cfg
            T, R_img = images.shape[0], images.shape[1]
            W = R_img
            H = R_img

            radial = cfg.camera_type == "SIMPLE_RADIAL"
            if resume_from is not None:
                (reg, extrinsics, intrinsics, registered, end,
                 windows_done, extra) = self.load_checkpoint(resume_from)
                if radial and extra is None:
                    extra = np.zeros((T, 1), np.float32)
            else:
                (reg, extrinsics, intrinsics, extra, registered,
                 end) = self._initial_map(images)
                windows_done = 0
            end, windows_done = self._process_range(
                images, reg, extrinsics, intrinsics, extra, registered,
                end, T, windows_done, checkpoint_path=checkpoint_path)

            colors = self._point_colors(images, reg)
            predictions = {
                "extrinsics": extrinsics,
                "intrinsics": intrinsics,
                "extra_params": extra,
                "points3d": reg.xyz,
                "colors": colors,
                "registered": registered,
                "num_points": reg.num_points,
                "num_observations": len(reg.obs_frame),
            }
            if output_dir is not None:
                self._export(predictions, reg, (W, H), output_dir,
                             image_names=image_names, crop_params=crop_params)
            return predictions

    @staticmethod
    def _point_colors(images, reg) -> np.ndarray:
        """Per-point RGB sampled at each point's earliest observation
        (parity: video_runner.py:189-246 `_update_points_color`, which
        re-samples frame pixels at the reconstructed points' projections —
        here the stored observation pixel, the same location post-BA)."""
        images = np.asarray(images)
        P = reg.num_points
        colors = np.zeros((P, 3), np.float32)
        if P == 0 or len(reg.obs_frame) == 0:
            return colors
        first = np.full((P,), -1, np.int64)
        rev = np.arange(len(reg.obs_point))[::-1]
        first[reg.obs_point[rev]] = rev  # earliest observation wins
        have = first >= 0
        f = reg.obs_frame[first[have]]
        xy = np.rint(reg.obs_xy[first[have]]).astype(np.int64)
        H, W = images.shape[1:3]
        x = np.clip(xy[:, 0], 0, W - 1)
        y = np.clip(xy[:, 1], 0, H - 1)
        colors[have] = images[f, y, x]
        return colors

    # ------------------------------------------------------------------

    def _window_ba(self, extr_w, intr_w, extra_w, X_map, map_tracks,
                   map_vis, pts_new, fresh_tracks, fresh_mask, keep):
        """Windowed BA over one window's observations.

        Frees the window's new poses and freshly triangulated points;
        freezes the query pose (row 0), every pre-existing map point, and
        the intrinsics — the reference's exact pyceres configuration
        (video_runner.py:813-831: constant cam pose on frame 0, constant
        old points, refine_focal_length=False, refine_extra_params=False).
        The point axis is the full (map budget + fresh budget) lane set;
        masked lanes carry zero Jacobians.

        Returns (optimized window extrinsics, optimized new points).
        """
        Sw = extr_w.shape[0]
        budget = X_map.shape[0]
        tracks_ba = np.concatenate([map_tracks, fresh_tracks], axis=1)
        mask_ba = np.concatenate([map_vis, fresh_mask], axis=1)
        X_ba = np.concatenate([X_map, pts_new], axis=0)
        point_free = np.concatenate([np.zeros(budget, bool), keep])
        pose_free = np.ones((Sw,), bool)
        pose_free[0] = False
        cfg = BAConfig(max_iterations=10, refine_focal=False,
                       refine_extra=False, robust_loss="cauchy",
                       loss_scale=2.0)
        extr_o, _, _, X_o, _ = bundle_adjust(
            self._t(extr_w), self._t(intr_w), self._t(X_ba),
            self._t(tracks_ba), self._t(mask_ba, torch.bool),
            extra_params=(None if extra_w is None else self._t(extra_w)),
            pose_free=self._t(pose_free, torch.bool),
            point_free=self._t(point_free, torch.bool), cfg=cfg)
        return _np(extr_o), _np(X_o)[budget:]

    def _device_count(self) -> int:
        """The ranks of the default process group (1 without one): in
        torch one process drives one card, so these are the devices the
        joint BA can shard over."""
        return (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)

    def _sparse_ba(self, n_dev, *args, **kw):
        """`bundle_adjust_sparse`'s (extr, intr, extra, X), or with
        n_dev > 1 `distributed_bundle_adjust` over the first n_dev ranks
        (every rank of the group calls it; ranks beyond the mesh take rank
        0's result)."""
        if n_dev <= 1:
            extr, intr, extra_o, X, _ = bundle_adjust_sparse(*args, **kw)
            return extr, intr, extra_o, X
        if self._mesh is None or self._mesh.size != n_dev:
            self._mesh = make_mesh(n_dev, frames_axis=1, device=self.device)
        mesh = self._mesh
        extr0, intr0, X0 = args[:3]
        extra0 = kw.get("extra_params")
        if mesh.rank < mesh.size:
            extr, intr, extra_o, X, _ = distributed_bundle_adjust(
                mesh, *args, extra_params=extra0,
                pose_free=kw.get("pose_free"), cfg=kw["cfg"],
                axis="points")
        else:
            extr, intr, X = (torch.empty_like(t) for t in (extr0, intr0,
                                                             X0))
            extra_o = None if extra0 is None else torch.empty_like(extra0)
        if self._device_count() > mesh.size:
            for t in (extr, intr, X, extra_o):
                if t is not None:
                    dist.broadcast(t, src=0)
        return extr, intr, extra_o, X

    def _normalize(self, extrinsics, reg, registered) -> None:
        """The gauge normalization of the map, in place."""
        extr, pts, _, _ = normalize_reconstruction(
            torch.from_numpy(extrinsics), torch.from_numpy(reg.xyz),
            registered=torch.from_numpy(np.asarray(registered, bool)))
        extrinsics[:] = extr.numpy()
        reg.xyz = pts.numpy()

    def _joint_ba(self, extrinsics, intrinsics, reg: MapRegistry,
                  registered, extra=None):
        """Sparse LM over all registered frames + map points.

        Wrapped in the reference's joint-BA hygiene (video_runner.py
        :494-541): gauge-normalize the reconstruction, solve, cull
        observations by reprojection error / depth / triangulation angle
        (`filter_all_points3D(2.0, 1.5)`), normalize again.
        """
        T = extrinsics.shape[0]
        P = reg.num_points
        if P == 0 or len(reg.obs_frame) == 0:
            return
        n_dev = self.cfg.distributed_ba_devices
        # the JAX rule: shard over n_dev devices where that many are present
        # (here the group's ranks), else the plain solver
        n_dev = n_dev if n_dev > 1 and self._device_count() >= n_dev else 1
        with trace.stage("video.joint_ba", self.timings, self.device):
            self._normalize(extrinsics, reg, registered)
            pose_free = registered & (np.arange(T) != 0)
            # a video sequence is one physical camera: tie the focal step
            # across frames (reference: shared pycolmap camera in joint_BA,
            # video_runner.py:494-541)
            cfg = SparseBAConfig(max_iterations=12,
                                 refine_focal=self.cfg.shared_camera,
                                 refine_extra=(extra is not None
                                               and self.cfg.shared_camera),
                                 shared_intrinsics=self.cfg.shared_camera,
                                 cg_iters=30, robust_loss="cauchy",
                                 loss_scale=4.0)
            n_obs = len(reg.obs_frame)
            extr, intr, extra_o, X = self._sparse_ba(
                n_dev, self._t(extrinsics), self._t(intrinsics),
                self._t(reg.xyz), self._t(reg.obs_frame, torch.long),
                self._t(reg.obs_point, torch.long), self._t(reg.obs_xy),
                torch.ones((n_obs,), dtype=torch.float32,
                           device=self.device),
                extra_params=(None if extra is None else self._t(extra)),
                pose_free=self._t(pose_free, torch.bool), cfg=cfg)
            extrinsics[:] = _np(extr)
            intrinsics[:] = _np(intr)
            if extra is not None and extra_o is not None:
                extra[:] = _np(extra_o)
            reg.xyz = _np(X)
            filter_map_observations(reg, extrinsics, intrinsics, extra,
                                    max_reproj_error=2.0, min_tri_angle=1.5)
            self._normalize(extrinsics, reg, registered)

    def _export(self, predictions, reg, image_size, output_dir,
                image_names=None, crop_params=None):
        """COLMAP export: real filenames, per-point colors, and (with
        crop_params) intrinsics/points2D mapped back to original image
        coordinates — parity with the sparse runner's export and the
        reference's back_to_original_resolution path
        (video_runner.py:198-206, runners/runner.py:1009-1052). Walks
        every observation on the host, as the JAX package does."""
        T = predictions["extrinsics"].shape[0]
        cameras, images_d, points = {}, {}, {}
        per_image: dict = {t: ([], []) for t in range(T)}
        point_tracks: dict = {}
        for o in range(len(reg.obs_frame)):
            f, p = int(reg.obs_frame[o]), int(reg.obs_point[o])
            xs, ps = per_image[f]
            point_tracks.setdefault(p, []).append((f + 1, len(xs)))
            xs.append(reg.obs_xy[o])
            ps.append(p)
        cam_type = self.cfg.camera_type
        extra = predictions.get("extra_params")
        colors = predictions.get("colors")
        rgb255 = (np.zeros((reg.num_points, 3), np.uint8) if colors is None
                  else np.clip(np.asarray(colors) * 255, 0,
                               255).astype(np.uint8))
        shared = self.cfg.shared_camera
        for t in range(T):
            cam_id = 1 if shared else t + 1
            if cam_id not in cameras:
                # one physical camera across the sequence when shared
                # (reference: shared pycolmap camera, video_runner.py)
                cameras[cam_id] = Camera(
                    cam_id, cam_type, image_size[0], image_size[1],
                    _camera_params(cam_type, predictions["intrinsics"][t],
                                   None if extra is None else extra[t]))
            xs, ps = per_image[t]
            name = (image_names[t] if image_names is not None
                    else f"frame_{t:05d}.png")
            images_d[t + 1] = Image(
                t + 1, _matrix_to_quat(predictions["extrinsics"][t, :, :3]),
                predictions["extrinsics"][t, :, 3].copy(), cam_id,
                name,
                np.asarray(xs).reshape(-1, 2),
                np.asarray(ps, np.int64))
        for p, track in point_tracks.items():
            ims = np.asarray([a for a, _ in track], np.int32)
            idxs = np.asarray([b for _, b in track], np.int32)
            points[p] = Point3D(p, reg.xyz[p], rgb255[p], 0.0,
                                ims, idxs)
        rec = Reconstruction(cameras, images_d, points)
        if crop_params is not None:
            rec = rescale_reconstruction_to_original(
                rec, crop_params, self.r.cfg.img_size,
                image_names=image_names,
                shared_camera=self.cfg.shared_camera)
        write_model(rec, os.path.join(output_dir, "sparse"), ext=".bin")
