"""The checks of the VGGSfM family (the sparse and the video pipeline):
what the timed path produced, held against the plain float32 reference
(benchmark/reference) on the same frames and the same weights, and the
solve's answers against the cameras planted in the scenes.

Each neural check is three functions: what the program produced (`got`),
what the reference computes in a given precision (`want`), and the number
that compares two such outputs (`checks.readings` in the harness runs
them). The reference follows the program from the program's own state in
three places, and the stage it skips there is checked by itself: the
camera trunk starts from the program's image features (checked by
`camera_rel`), the coarse tracker from the program's query points (the
extraction is `aliked_rel` and `query_miss`, or `corner_miss`), and the
fine tracker from the program's coarse tracks (the coarse stage is
`coarse_px`). `query_miss` itself selects the keypoints from the
program's score map, whose extraction `aliked_rel` checks.

The solve is read on every scene of the window (each pipeline's
`solve_checks`): its final cameras against the planted ones
(`pose_err_deg`, the median over the window's scenes), the observations
it keeps against its own last gate (`reproj_over`), and the tracks it
keeps (`valid_tracks`, the fewest in a scene).
"""

from __future__ import annotations

import os
import statistics

import torch

from benchmark.harness.checks import precision
from benchmark.harness.record import frame_sums, match_frames
from benchmark.harness.weights import model_seed, seeded_state_dict


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


def census_modules(device) -> dict:
    """The float32 reference module of each neural call the recorder's
    census names, for the FLOP count."""
    from benchmark.reference.aliked import ALIKED
    from benchmark.reference.camera import CameraPredictor
    from benchmark.reference.tracker import TrackerPredictor

    with torch.device(device):
        tr = TrackerPredictor(dtype=torch.float32).eval()
        cam = CameraPredictor(dtype=torch.float32).eval()
        aliked = ALIKED(dtype=torch.float32).eval()
    return {"coarse": tr.coarse_predictor, "fine": tr.fine_predictor,
            "coarse_fnet": tr.coarse_fnet, "fine_fnet": tr.fine_fnet,
            "camera": cam, "dino": cam.backbone, "aliked": aliked}


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
# number comparing two outputs, the reference model it needs, what the
# number reads)
NEURAL = {
    "camera_rel": (camera_got, camera_want, camera_rel, "camera",
                   "camera predictor, image features"),
    "trunk_rel": (trunk_got, trunk_want, trunk_rel, "camera",
                  "camera trunk, first iteration"),
    "corner_miss": (corner_got, corner_want, query_miss, None,
                    "query points: sift+harris candidates"),
    "aliked_rel": (aliked_got, aliked_want, aliked_rel, "aliked",
                   "ALIKED score map"),
    "query_miss": (query_got, query_want, query_miss, "aliked",
                   "query points: NMS and top-K of the score map"),
    "coarse_px": (coarse_got, coarse_want, coarse_px, "tracker",
                  "coarse tracker, tracks"),
    "fine_px": (fine_got, fine_want, fine_px, "tracker",
                "fine tracker, patch tracks"),
}

# what each number of the solve (a pipeline's `solve_checks`) reads
SCENE_READS = {
    "pose_err_deg": "solve, final cameras against the planted, median scene",
    "reproj_over": "solve, kept observations beyond the last gate",
    "valid_tracks": "solve, triangulated tracks, fewest in a scene",
}

def want_kwargs(name: str, max_pts: int) -> dict:
    """The keyword arguments of the check `name`'s `want` beyond the
    common ones: `query_miss` selects as many points as the program."""
    return {"max_pts": max_pts} if name == "query_miss" else {}


def max_query_pts(pipe) -> int:
    """The query points per frame the program was asked for."""
    return pipe.opts["max_query_pts"]


def scene_failed(solve: dict) -> bool:
    """A scene of the window whose solve kept no track."""
    return not solve["valid_tracks"]


def check_sample(pipe, sample: dict) -> None:
    """Raise unless the sampled coarse tracker call ran in the mode
    `make_runner` set: visibility from cycle consistency wherever the
    tracks start from matching."""
    want = pipe.opts.get("matching_init", True)
    got = sample["coarse"]["kwargs"].get("matching_vis")
    if got is not want:
        raise RuntimeError(f"the coarse tracker ran with matching_vis="
                           f"{got!r}, not {want!r}: the runner no longer "
                           f"reads `_weights_loaded`")


def over_window(name: str, values: list, side: str) -> float:
    """One reading of a solve number from those of the window's scenes:
    for `pose_err_deg` the median (with the seeded weights the sound
    solve leaves 1 to 3 scenes of a pool 4-57 deg off, the rest under
    0.7 deg), for the others the one nearest the wrong side of its limit:
    the largest for '<=', the fewest for '>='."""
    if name == "pose_err_deg":
        return float(statistics.median(values))
    return max(values) if side == "<=" else min(values)
