"""The sharded end-to-end pipeline step over a (frames, points) mesh.
Counterpart of vggsfm_tpu/parallel/sharded.py.

The JAX package writes the step as one jitted program with input
shardings and lets GSPMD insert the collectives. Here every rank of the
mesh (parallel/mesh.py) runs the same stages on its blocks and calls the
collectives itself:

  * Harris query points on the query frame (rank 0's, broadcast);
  * the feature CNN on this rank's block of the frames (`frames` axis),
    then an all-gather of the maps;
  * the coarse predictor (6 iterations, down ratio 2, matching init with
    cycle visibility) on this rank's block of the tracks (`points` axis):
    the virtual tracks' cross-attention over the point tokens combines
    the blocks (`TorchMultiheadAttention(group=...)`), every other part
    is per track;
  * fine refinement on NHWC patch maps (`refine_track(flat_fnet=False)`,
    the channel-first correlation pyramid) with the NCC polish, per track;
  * an all-gather of the tracks; the preliminary two-view cameras on all
    of them, replicated (128 minimal sets from a CPU generator seeded 0,
    `lo_num` 16; rank 0's result broadcast) when no cameras are given;
  * LORANSAC triangulation of this rank's tracks;
  * bundle adjustment (10 iterations, focal refined) with the points
    sharded: the camera system is summed over the `points` axis.

Host-side orchestration of the production runner (the re-query loop,
chunking, the camera-init choice, the refine/BA rounds) stays outside the
step, as in the JAX package. Every rank must call each stage in the same
order: the collectives are matched by order.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.ba import BAConfig, bundle_adjust
from vggsfm_tpu_torch.extractors.corners import detect_harris_keypoints
from vggsfm_tpu_torch.geometry.cameras import cam_from_img
from vggsfm_tpu_torch.models.refine import refine_track
from vggsfm_tpu_torch.ops.triangulation import (
    generate_ransac_pairs,
    triangulate_tracks_chunk,
)
from vggsfm_tpu_torch.twoview import estimate_preliminary_cameras


class ShardedStep:
    """The step's stages on `tracker` (a TrackerPredictor on this rank's
    card) over `mesh`; calling it runs them all. Each stage is a method,
    so that each can be held against the JAX stage on the same inputs."""

    def __init__(self, tracker, mesh):
        self.tracker, self.mesh = tracker, mesh
        self.frames, self.points = mesh["frames"], mesh["points"]
        self.valid_points = None  # (N,) bool after a call
        self.ba_info = None  # the last call's BA costs (`bundle_adjust`)

    def _dev(self, x, dtype=torch.float32):
        return torch.as_tensor(x).to(self.mesh.device, dtype)

    def queries(self, images, max_query_pts: int):
        """Harris query points of frame 0 of (1, S, H, W, 3) images:
        ((1, K, 2) xy, (1, K) valid), rank 0's on every rank."""
        im = images[0, 0]
        gray = 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
        xy, _score, valid = detect_harris_keypoints(gray, max_query_pts)
        xy = self.mesh.broadcast(xy.contiguous())
        valid = self.mesh.broadcast(valid.to(torch.uint8)).bool()
        return xy[None], valid[None]

    def fmaps(self, images):
        """Coarse feature maps (B, S, H', W', C) of every frame: the CNN on
        this rank's block of the frames, gathered over `frames`."""
        S = images.shape[1]
        block = self.frames.block(images, dim=1)
        f = self.tracker.process_images_to_fmaps(block)
        return self.frames.all_gather(f, dim=1, length=S)

    def coarse(self, query_block, fmaps):
        """The coarse predictor on this rank's block of the query points
        (B, N/P, 2): (tracks (B, S, N/P, 2), visibility (B, S, N/P))."""
        preds, vis = self.tracker.coarse_predictor(
            query_block, fmaps, iters=6,
            down_ratio=self.tracker.coarse_down_ratio, matching_init=True,
            matching_vis=True, group=self.points)
        return preds[-1], vis

    def fine(self, images, coarse_block):
        """Fine refinement of this rank's tracks on NHWC 31x31 patch maps,
        NCC-polished: (B, S, N/P, 2)."""
        tr = self.tracker

        def fnet(x):
            return tr.fine_fnet(x, flat_cfirst=False)

        def ftrack(q, f, iters, return_feat, matching_init):
            return tr.fine_predictor(q, f, iters=iters,
                                     return_feat=return_feat,
                                     matching_init=matching_init)

        tracks, _score = refine_track(images, fnet, ftrack, coarse_block,
                                      compute_score=True,
                                      matching_init=True,
                                      subpixel_refine=True, flat_fnet=False)
        return tracks

    def gather(self, x, dim: int):
        """All of the tracks' blocks of `x` along `dim`, in order."""
        return self.points.all_gather(x, dim=dim)

    def preliminary(self, tracks, vis, width: int, height: int,
                    sample_idx=None):
        """The preliminary two-view cameras of all (1, S, N) tracks (128
        minimal sets, `lo_num` 16): rank 0's extrinsics (S, 3, 4),
        intrinsics (S, 3, 3) and epipolar inlier mask (S, N, frame 0
        all True) on every rank."""
        S, N = tracks.shape[1:3]
        pre = estimate_preliminary_cameras(
            tracks, vis, width, height, torch.Generator().manual_seed(0),
            max_ransac_iters=128, lo_num=16, sample_idx=sample_idx)
        extr = self.mesh.broadcast(pre["extrinsics"][0].contiguous())
        intr = self.mesh.broadcast(
            pre["default_intri"].expand(S, 3, 3).contiguous())
        fm = pre["fmat_inlier_mask"][0]
        fmask = torch.cat([torch.ones_like(fm[:1]), fm], dim=0)
        fmask = self.mesh.broadcast(fmask.to(torch.uint8)).bool()
        return extr, intr, fmask

    def triangulate(self, extrinsics, intrinsics, tracks, vis, fmask,
                    pairs):
        """LORANSAC triangulation of this rank's tracks (S, N/P, 2) with
        visibility and epipolar mask (S, N/P): (points (N/P, 3), inlier
        count (N/P,), inlier mask (N/P, S))."""
        tracks_norm = cam_from_img(tracks, intrinsics, None)
        return triangulate_tracks_chunk(
            extrinsics, tracks_norm.transpose(0, 1), pairs,
            track_vis=(vis * fmask).T, lo_num=16, group=self.points)

    def adjust(self, extrinsics, intrinsics, points, tracks, inl_num,
               inl_mask):
        """Bundle adjustment of the cameras and this rank's points (10
        iterations, focal refined): (extrinsics, points (N/P, 3), final
        cost), cameras and cost the same on every rank."""
        S = extrinsics.shape[0]
        valid = inl_num >= 2
        extr_o, _, _, pts_o, info = bundle_adjust(
            extrinsics, intrinsics, points, tracks,
            inl_mask.T & valid[None],
            pose_free=torch.arange(S, device=extrinsics.device) != 0,
            point_free=valid,
            cfg=BAConfig(max_iterations=10, refine_focal=True),
            group=self.points)
        self.ba_info = info
        return extr_o, pts_o, info["final_cost"]

    @torch.inference_mode()
    def __call__(self, images, query_points=None, extrinsics=None,
                 intrinsics=None, max_ransac_iters: int = 8,
                 max_query_pts: int | None = None, sample_idx=None):
        """images (1, S, H, W, 3) in [0, 1] (every rank the same);
        query_points optional (1, N, 2), N a multiple of the `points`
        axis; extrinsics / intrinsics optional (S, 3, 4) / (S, 3, 3), else
        the preliminary cameras; sample_idx optional (128, 7) minimal
        sets of the preliminary fundamental matrices.

        Returns (tracks (1, S, N, 2), visibility (1, S, N), points3d
        (N, 3), extrinsics (S, 3, 4), final BA cost), all on every rank.
        """
        images = self._dev(images)
        B, S, H, W, _ = images.shape
        if query_points is None:
            query_points, _ = self.queries(images, max_query_pts or 64)
        query_points = self._dev(query_points)
        N = query_points.shape[1]
        if N % self.points.size:
            raise ValueError(f"{N} query points do not split over the "
                             f"{self.points.size} ranks of the points "
                             f"axis (the space attention takes no padding)")
        pairs = torch.as_tensor(generate_ransac_pairs(
            S, max_ransac_iters, seed=0), device=self.mesh.device).long()

        fmaps = self.fmaps(images)
        q_block = self.points.block(query_points, dim=1)
        coarse, vis_b = self.coarse(q_block, fmaps)
        tracks_b = self.fine(images, coarse)
        tracks = self.gather(tracks_b, dim=2)
        vis = self.gather(vis_b, dim=2)

        # the epipolar inliers gate the triangulation; the two-view cameras
        # initialize BA where the caller gave none
        extr_pre, intr_pre, fmask = self.preliminary(tracks, vis, W, H,
                                                     sample_idx)
        if extrinsics is None:
            extrinsics, intrinsics = extr_pre, intr_pre
        else:
            extrinsics, intrinsics = self._dev(extrinsics), self._dev(
                intrinsics)
        fmask_b = self.points.block(fmask, dim=1)
        pts_b, inl_num, inl_mask = self.triangulate(
            extrinsics, intrinsics, tracks_b[0], vis_b[0], fmask_b, pairs)
        extr_o, pts_o, cost = self.adjust(extrinsics, intrinsics, pts_b,
                                          tracks_b[0], inl_num, inl_mask)
        # the points BA adjusted (>= 2 inliers), for the caller's gates
        self.valid_points = self.gather(
            (inl_num >= 2).to(torch.uint8), dim=0).bool()
        return tracks, vis, self.gather(pts_o, dim=0), extr_o, cost


def sharded_track_and_reconstruct(tracker, mesh) -> ShardedStep:
    """The multi-device step: images -> query points, tracks, 3D points
    and cameras (from two-view geometry when none are given). Returns the
    callable `ShardedStep`; every rank of `mesh` calls it alike."""
    return ShardedStep(tracker, mesh)


def sharded_pipeline_step(tracker, mesh) -> ShardedStep:
    """Alias with the JAX package's historical name."""
    return sharded_track_and_reconstruct(tracker, mesh)
