"""The comparison that decides `correct`: what the timed path produced,
held against what does not come from the program: the plain reference
(benchmark/reference) run in float32 on the same frames and the same
weights, after the window, and the cameras planted in the scenes.

Each neural check is three functions: what the program produced (`got`),
what the reference computes in a given precision (`want`), and the number
that compares two such outputs. The program's reading compares its `got`
with the float32 `want`; the control's reading compares the `want` of a
lower precision with it. The reference follows the program from the
program's own state in three places, and the stage it skips there is
checked by itself: the camera trunk starts from the program's image
features (checked by `camera_rel`), the coarse tracker from the program's
query points (the extraction is `aliked_rel` and `query_miss`, or
`corner_miss`), and the fine tracker from the program's coarse tracks
(the coarse stage is `coarse_px`). `query_miss` itself selects the
keypoints from the program's score map, whose extraction `aliked_rel`
checks.

The solve is read on every scene of the window: its final cameras
against the planted ones (`pose_err_deg`, the median over the window's
scenes), the observations it keeps against its own last gate
(`reproj_over`), and the tracks it keeps (`valid_tracks`, the fewest in a
scene).

A configuration's `checks` give each number its side and limit.
"""

from __future__ import annotations

import contextlib
import os
import statistics

import torch

from benchmark.harness.auc import relative_pose_errors
from benchmark.harness.record import frame_sums, match_frames
from benchmark.harness.weights import model_seed, seeded_state_dict
from benchmark.reference.precision import TF32, rounded_products


def reference_models(cfg: dict, device, parts) -> dict:
    """The reference's models, float32, with the configuration's weights
    (the program's).
    TF32 is off for every float32 product from here on."""
    from benchmark.reference.aliked import ALIKED
    from benchmark.reference.camera import CameraPredictor
    from benchmark.reference.tracker import TrackerPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    classes = {"tracker": TrackerPredictor, "camera": CameraPredictor,
               "aliked": ALIKED}
    out = {}
    for part in parts:
        with torch.device(device):
            m = classes[part](dtype=torch.float32)
        m.load_state_dict(seeded_state_dict(
            m, model_seed(cfg["weights_seed"], part), device,
            cfg["flow_head_std"]))
        out[part] = m.eval()
    return out


def precision(mode: str):
    """The reference's precision: 'f32', or the control's 'tf32' / 'bf16'
    / 'fp8' products."""
    if mode == "f32":
        return contextlib.nullcontext()
    return rounded_products({"tf32": TF32, "bf16": torch.bfloat16,
                             "fp8": torch.float8_e4m3fn}[mode])


def _median_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm(dim=-1).median())


# ------------------------------------------------------------- camera

def camera_got(sample):
    return sample["camera"]["feat"].float()


@torch.inference_mode()
def camera_want(ref, frames, sample, mode):
    """The per-frame image features (B, S, C) of the sampled camera
    forward (DINOv2 and the predictor's attention blocks; the trunk's
    input): the scene's frames resized to the predictor's input, in the
    forward's orderings."""
    from benchmark.reference.sampling import interpolate_bilinear

    cam = sample["camera"]
    B, S = cam["frame_sums"].shape
    size = ref["camera"].down_size
    x = interpolate_bilinear(frames, (size, size))
    idx = match_frames(cam["frame_sums"].flatten(), frame_sums(x))
    with precision(mode):
        out = ref["camera"](x[idx].view(B, S, size, size, 3),
                            iters=cam["iters"])
    return out["rgb_feat_init"].float()


def camera_rel(got, want) -> float:
    """Relative RMS gap of two tensors."""
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


def trunk_got(sample):
    return tuple(t.float() for t in sample["trunk"])


@torch.inference_mode()
def trunk_want(ref, frames, sample, mode):
    """The first iteration of the camera trunk (its attention blocks and
    the pose branch) on the program's image features of the sampled
    forward, from the zero pose it starts at: the trunk's output and the
    pose branch's (pose, feature) delta. Later iterations are not
    compared: they feed the pose back through 48 harmonics, up to 2^47
    times the pose, so rounding alone decides their output."""
    cam = ref["camera"]
    feat = sample["camera"]["feat"].float()
    seen = []
    h = cam.pose_branch.register_forward_hook(
        lambda m, a, o: seen.append((a[0], o)))
    try:
        with precision(mode):
            cam._trunk_iter(feat, feat.new_zeros(*feat.shape[:2],
                                                 cam.target_dim), feat)
    finally:
        h.remove()
    return tuple(t.float() for t in seen[0])


def trunk_rel(got, want) -> float:
    """The largest relative RMS gap among the trunk's output, the pose
    delta and the feature delta."""
    (xg, dg), (xw, dw) = got, want
    k = dg.shape[-1] - xg.shape[-1]
    return max(camera_rel(xg, xw), camera_rel(dg[..., :k], dw[..., :k]),
               camera_rel(dg[..., k:], dw[..., k:]))


# --------------------------------------------------------- extraction

def _query_frame(sample) -> int:
    return sample["query"][0][sample["call"]]


def aliked_got(sample):
    return sample["aliked"].float()


@torch.inference_mode()
def aliked_want(ref, frames, sample, mode):
    """The ALIKED score map (H, W) of the sampled call's query frame."""
    with precision(mode):
        return ref["aliked"](frames[_query_frame(sample)][None])[0].float()


def aliked_rel(got, want) -> float:
    """Relative RMS gap of two score maps."""
    return camera_rel(got, want)


def query_got(sample):
    _, (qps, valids) = sample["query"]
    q = sample["call"]
    return qps[q][valids[q].bool()].round().long()


@torch.inference_mode()
def query_want(ref, frames, sample, mode, max_pts):
    """The keypoints (K, 2) of the sampled call's query frame: in float32,
    the NMS peaks and top-K of the program's own score map; in a lower
    precision (the control), those of the reference's score map in it."""
    from benchmark.reference.keypoints import keypoints_from_heatmap

    heat = (aliked_got(sample) if mode == "f32"
            else aliked_want(ref, frames, sample, mode))
    xy, _, valid = keypoints_from_heatmap(heat, max_pts, nms_radius=2)
    return xy[valid].long()


def corner_got(sample):
    c = sample["corners"]
    return c["xy"][c["valid"].bool()].round().long()


@torch.inference_mode()
def corner_want(ref, frames, sample, mode):
    """Every candidate of the weights-free extractors ('sift+harris') on
    the sampled query frame, each method's top budget, by the plain
    reference (benchmark/reference/corners)."""
    from benchmark.reference.corners import candidates

    c = sample["corners"]
    # 'auto' is 'sift+harris' unless a trained ALIKED checkpoint is named
    # (VGGSFM_TPU_ALIKED_CKPT), which a weights-free cell never does
    method = c["method"]
    if method == "auto" and not os.environ.get("VGGSFM_TPU_ALIKED_CKPT"):
        method = "sift+harris"
    img = frames[match_frames(c["frame_sum"], frame_sums(frames))[0]]
    with precision(mode):
        return candidates(img, method, c["max_pts"]).round().long()


def query_miss(got, want) -> float:
    """The share of the points in `got` that are not among those of
    `want` (pixels compared exactly)."""
    key = 1 << 20
    hit = torch.isin(got[:, 1] * key + got[:, 0],
                     want[:, 1] * key + want[:, 0])
    return float((~hit).sum()) / max(hit.numel(), 1)


# ------------------------------------------------------------ tracker

def _call_frames(frames: torch.Tensor, sample: dict) -> torch.Tensor:
    """(1, S, H, W, 3): the frames of `frames` in the order the sampled
    coarse call saw them."""
    c = sample["coarse"]
    in_sums, out_sums = c["scene"]
    order = match_frames(c["fmaps_sums"], out_sums)
    scene_idx = match_frames(in_sums, frame_sums(frames))
    return frames[[scene_idx[o] for o in order]][None]


def coarse_got(sample):
    return sample["coarse"]["tracks"][:, 1:].float()


@torch.inference_mode()
def coarse_want(ref, frames, sample, mode):
    """The coarse tracks of the sampled call's frames from the reference's
    own feature maps, the program's query points, and the call's
    iterations and options. The query frame, pinned on both sides, is
    left out."""
    c = sample["coarse"]
    tr = ref["tracker"]
    with precision(mode):
        fmaps = tr.process_images_to_fmaps(_call_frames(frames, sample))
        preds, _ = tr.coarse_predictor(c["query_points"].float(), fmaps,
                                       **c["kwargs"])
    return preds[-1][:, 1:].float()


def coarse_px(got, want) -> float:
    """Median gap (px) of two sets of tracks."""
    return _median_gap(got, want)


def fine_got(sample):
    return torch.cat(sample["fine"], dim=0)[:, 1:].float()


@torch.inference_mode()
def fine_want(ref, frames, sample, mode):
    """The fine tracker's output (patch pixels) on the patches around the
    program's coarse tracks of the sampled call. The query frame is left
    out."""
    from benchmark.reference.refine import refine_track

    c = sample["coarse"]
    tr = ref["tracker"]
    seen = []
    h = tr.fine_predictor.register_forward_hook(
        lambda m, a, o: seen.append(o[0][-1]))
    try:
        with precision(mode):
            refine_track(
                _call_frames(frames, sample),
                lambda x: tr.fine_fnet(x, flat_cfirst=True),
                lambda q, f, iters, return_feat, matching_init,
                fmaps_flat_hw=None: tr.fine_predictor(
                    q, f, iters=iters, return_feat=return_feat,
                    matching_init=matching_init,
                    fmaps_flat_hw=fmaps_flat_hw),
                c["tracks"].float(), compute_score=False,
                matching_init=c["kwargs"].get("matching_init", False),
                subpixel_refine=False, patch_dtype=torch.float32,
                flat_fnet=True)
    finally:
        h.remove()
    return seen[0][:, 1:].float()


def fine_px(got, want) -> float:
    """Median gap (patch px) of two sets of fine patch tracks."""
    return _median_gap(got, want)


# name -> (what the program produced, what the reference computes, the
# number comparing two outputs, the reference model it needs)
NEURAL = {
    "camera_rel": (camera_got, camera_want, camera_rel, "camera"),
    "trunk_rel": (trunk_got, trunk_want, trunk_rel, "camera"),
    "corner_miss": (corner_got, corner_want, query_miss, None),
    "aliked_rel": (aliked_got, aliked_want, aliked_rel, "aliked"),
    "query_miss": (query_got, query_want, query_miss, "aliked"),
    "coarse_px": (coarse_got, coarse_want, coarse_px, "tracker"),
    "fine_px": (fine_got, fine_want, fine_px, "tracker"),
}


def readings(name, ref, frames, sample, modes=("f32",), **kw) -> dict:
    """mode -> the number `name`: under 'f32' the program's output against
    the float32 reference, under a lower precision the reference's own
    output in that precision against it (the control)."""
    got_fn, want_fn, fn, _ = NEURAL[name]
    want = want_fn(ref, frames, sample, "f32", **kw)
    out = {}
    for mode in modes:
        got = (got_fn(sample) if mode == "f32"
               else want_fn(ref, frames, sample, mode, **kw))
        out[mode] = fn(got, want)
    return out


# -------------------------------------------------------------- solve

def pose_err_deg(extr, planted) -> float:
    """The median over the frame pairs of max(rotation error,
    translation-direction error), in degrees, of the relative poses of
    (S, 3, 4) cameras against the planted ones."""
    rot, tr = relative_pose_errors(extr.detach().double().cpu(),
                                   torch.as_tensor(planted).double())
    return float(torch.maximum(rot, tr).median())


def _project(points, extr, intr, extra=None):
    """Pixels of (P, 3) world points in each of (S, 3, 4) cameras with
    (S, 3, 3) pinhole intrinsics and, with `extra` (S, 1), one radial
    coefficient (SIMPLE_RADIAL): (S, P, 2)."""
    cam = torch.einsum("sij,pj->spi", extr[:, :, :3], points) \
        + extr[:, None, :, 3]
    xy = cam[..., :2] / cam[..., 2:3]
    if extra is not None:
        r2 = (xy * xy).sum(-1, keepdim=True)
        xy = xy * (1.0 + extra[:, None, :1] * r2)
    f = torch.stack([intr[:, 0, 0], intr[:, 1, 1]], -1)[:, None]
    return xy * f + intr[:, None, :2, 2]


def reproj_over(points, extr, intr, extra, obs_frame, obs_point, obs_xy,
                gate_px: float) -> float:
    """The share of the kept observations whose reprojection error,
    recomputed in float64 from the final cameras and points, exceeds the
    solve's last gate (`gate_px`); 1 where none are kept."""
    if obs_frame.numel() == 0:
        return 1.0
    d = torch.float64
    uv = _project(points.to(d), extr.to(d), intr.to(d),
                  None if extra is None else extra.to(d))
    err = (uv[obs_frame, obs_point] - obs_xy.to(d)).norm(dim=-1)
    return float((err > gate_px).double().mean())


def over_window(name: str, values: list, side: str) -> float:
    """One reading of a solve number from those of the window's scenes:
    for `pose_err_deg` the median (with the seeded weights the sound
    solve leaves 1 to 3 scenes of a pool 4-57 deg off, the rest under
    0.7 deg), for the others the one nearest the wrong side of its limit:
    the largest for '<=', the fewest for '>='."""
    if name == "pose_err_deg":
        return float(statistics.median(values))
    return max(values) if side == "<=" else min(values)


# what each number reads
READS = {
    "camera_rel": "camera predictor, image features",
    "trunk_rel": "camera trunk, first iteration",
    "corner_miss": "query points: sift+harris candidates",
    "aliked_rel": "ALIKED score map",
    "query_miss": "query points: NMS and top-K of the score map",
    "coarse_px": "coarse tracker, tracks",
    "fine_px": "fine tracker, patch tracks",
    "pose_err_deg": "solve, final cameras against the planted, median scene",
    "reproj_over": "solve, kept observations beyond the last gate",
    "valid_tracks": "solve, triangulated tracks, fewest in a scene",
}


def passes(value: float, side: str, limit: float) -> bool:
    return value <= limit if side == "<=" else value >= limit
