"""The checks of the VGGT family: what the timed path produced on the
checked scene, held against the plain float32 reference
(benchmark/reference/vggt.py) on the same frames and the same weights.

The reference follows the program from the program's own state in three
places, and the stage it skips there is checked by itself: the camera head
runs from the program's last tap and the depth head from the program's
taps (the aggregator is `agg_rel`), the points are the reference's
unprojection of the program's depth and cameras (the depth head is
`depth_rel`, the camera head `camhead_rel`).

  * `agg_rel`: the largest relative RMS gap among the four taps' frame and
    global halves, the special tokens (which the camera head reads: 5 of
    a frame's 1374) apart from the patch tokens;
  * `camhead_rel`: the camera head, each iteration's trunk output and
    pose delta (less the pose branch's bias, which would dominate it),
    each relative to its own RMS; the largest;
  * `depth_rel`, `conf_rel`: log-depth and confidence, relative RMS;
  * `points_rel`: the kept points against the reference's unprojection at
    the same pixels, relative RMS;
  * `points_kept`: |kept - min(max_points, pixels with confidence >=
    the threshold)|, on the program's own confidence.

Every scene of the window is read for non-finite outputs (`nonfinite`);
a scene fails where any output is non-finite or no point is kept.
"""

from __future__ import annotations

import torch

from benchmark.harness.checks import precision
from benchmark.harness.weights import seeded_state_dict

# the model seed of a configuration's weights_seed (harness/weights.py
# numbers the VGGSfM family's models 1 to 3)
SEED_SALT = 4


def _rel(got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).square().mean().sqrt() / w.square().mean().sqrt())


def _skeleton(cfg: dict):
    from benchmark.reference.vggt import VGGT

    with torch.device("meta"):
        return VGGT(**cfg.get("model_args", {}))


def state_dict(cfg: dict, device) -> dict:
    """The configuration's weights (from `weights_seed`) on `device`: the
    harness's seeded draw, and the pose branch's last layer N(0,
    `pose_branch_std`) with the bias `pose_branch_bias` (the configuration's
    cut: finite, plausible cameras after the head's iterations)."""
    seed = (cfg["weights_seed"] * 8 + SEED_SALT) % (2 ** 63)
    sd = seeded_state_dict(_skeleton(cfg), seed, device)
    name = "camera_head.pose_branch.fc2"
    w = sd[f"{name}.weight"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    sd[f"{name}.weight"] = cfg["pose_branch_std"] * torch.randn(
        w.shape, generator=gen, device=device)
    sd[f"{name}.bias"] = torch.tensor(cfg["pose_branch_bias"],
                                      device=device)
    return sd


def reference_models(cfg: dict, device, parts) -> dict:
    """The float32 reference with the configuration's weights (TF32 off
    from here on, by the reference itself)."""
    out = {}
    for part in parts:
        m = _skeleton(cfg)
        m.load_state_dict(state_dict(cfg, device), strict=True, assign=True)
        out[part] = m.eval()
    return out


class _OnMeta(torch.nn.Module):
    """A reference module that runs on meta tensors: the FLOP census
    counts its operations from the shapes alone."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, *args):
        def meta(a):
            if torch.is_tensor(a):
                return a.to("meta")
            if isinstance(a, (list, tuple)):
                return type(a)(meta(x) for x in a)
            return a
        return self.module(*meta(args))


def census_modules(device) -> dict:
    """The float32 reference module of each call the recorder's census
    names, at the published widths, run on meta tensors."""
    from benchmark.reference.vggt import VGGT

    with torch.device("meta"):
        m = VGGT().eval()
    return {"aggregator": _OnMeta(m.aggregator),
            "camera_head": _OnMeta(m.camera_head),
            "depth_head": _OnMeta(m.depth_head)}


def _cached(ref: dict, key: tuple, make):
    cache = ref.setdefault("_cache", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


# ---------------------------------------------------------- aggregator

def agg_got(sample):
    return sample["taps"]


@torch.inference_mode()
def agg_want(ref, frames, sample, mode):
    """The reference aggregator's taps on the scene's frames."""
    def run():
        with precision(mode):
            return ref["vggt"].aggregator(frames.float())
    return _cached(ref, ("agg", mode), run)


def agg_rel(got, want) -> float:
    """The largest relative RMS gap among each tap's frame and global
    halves, special and patch tokens apart."""
    special = 5
    out = []
    for g, w in zip(got, want):
        C = w.shape[-1] // 2
        for half in (slice(None, C), slice(C, None)):
            for tok in (slice(None, special), slice(special, None)):
                out.append(_rel(g[:, tok, half], w[:, tok, half]))
    return max(out)


# --------------------------------------------------------- camera head

def camhead_got(sample):
    return sample["trunk"], sample["deltas"]


@torch.inference_mode()
def camhead_want(ref, frames, sample, mode):
    """The reference camera head from the program's last tap: each
    iteration's trunk output and pose delta (less its bias)."""
    head = ref["vggt"].camera_head
    trunk, deltas = [], []
    bias = head.pose_branch.fc2.bias
    hooks = [head.trunk.register_forward_hook(
                 lambda m, a, o: trunk.append(o[0])),
             head.pose_branch.register_forward_hook(
                 lambda m, a, o: deltas.append((o - bias)[0]))]
    try:
        with precision(mode):
            head(sample["camera"]["tokens"].float(),
                 sample["camera"]["iterations"])
    finally:
        for h in hooks:
            h.remove()
    return trunk, deltas


def camhead_rel(got, want) -> float:
    (tg, dg), (tw, dw) = got, want
    return max(_rel(a, b) for a, b in zip(tg + dg, tw + dw))


# ---------------------------------------------------------- depth head

def _depth_want(ref, sample, mode):
    def run():
        with precision(mode):
            return ref["vggt"].depth_head(
                [t.float() for t in sample["taps"]], sample["image_hw"],
                sample["chunk"])
    return _cached(ref, ("depth", mode), run)


def depth_got(sample):
    return sample["depth"].log()


@torch.inference_mode()
def depth_want(ref, frames, sample, mode):
    """The reference depth head's log-depth from the program's taps."""
    return _depth_want(ref, sample, mode)[0].log()


def conf_got(sample):
    return sample["conf"]


@torch.inference_mode()
def conf_want(ref, frames, sample, mode):
    """The reference depth head's confidence from the program's taps."""
    return _depth_want(ref, sample, mode)[1]


# -------------------------------------------------------------- points

def points_got(sample):
    return sample["points"]["points3d"]


@torch.inference_mode()
def points_want(ref, frames, sample, mode):
    """The reference's unprojection of the program's depth and cameras at
    the kept points' pixels."""
    from benchmark.reference.vggt import unproject

    p = sample["points"]
    x, y, f = p["points_xyf"].unbind(-1)
    with precision(mode):
        return unproject(sample["depth"].float(), p["extrinsics"].float(),
                         p["intrinsics"].float(), f, x, y)


def kept_got(sample):
    return sample["points"]["points3d"].shape[0]


def kept_want(ref, frames, sample, mode):
    p = sample["points"]
    cand = int((sample["conf"] >= p["conf_thres"]).sum())
    return min(p["max_points"], cand)


def kept_gap(got, want) -> float:
    return float(abs(got - want))


# name -> (what the program produced, what the reference computes, the
# number comparing two outputs, the reference model it needs, what the
# number reads)
NEURAL = {
    "agg_rel": (agg_got, agg_want, agg_rel, "vggt",
                "aggregator, the taps' frame and global halves"),
    "camhead_rel": (camhead_got, camhead_want, camhead_rel, "vggt",
                    "camera head, trunk outputs and pose deltas"),
    "depth_rel": (depth_got, depth_want, _rel, "vggt",
                  "depth head, log-depth"),
    "conf_rel": (conf_got, conf_want, _rel, "vggt",
                 "depth head, confidence"),
    "points_rel": (points_got, points_want, _rel, None,
                   "kept points, unprojection of depth and cameras"),
    "points_kept": (kept_got, kept_want, kept_gap, None,
                    "kept points, count against min(cap, candidates)"),
}

SCENE_READS = {
    "nonfinite": "every output of a scene, non-finite values, most in a "
                 "scene",
}


def want_kwargs(name: str, max_pts) -> dict:
    return {}


def max_query_pts(pipe):
    """No query points: the family's checks take no budget."""
    return None


def scene_failed(solve: dict) -> bool:
    """A scene with a non-finite output or no point kept."""
    return solve["nonfinite"] > 0 or solve["points"] == 0


def over_window(name: str, values: list, side: str) -> float:
    """The scene nearest the wrong side of the limit."""
    return max(values) if side == "<=" else min(values)


def check_sample(pipe, sample: dict) -> None:
    """Raise unless the sampled scene ran every stage the checks read."""
    want = ("taps", "camera", "trunk", "deltas", "depth", "points")
    missing = [k for k in want if k not in sample]
    iters = pipe.opts["camera_iters"]
    if missing or len(sample["trunk"]) != iters \
            or len(sample["deltas"]) != iters:
        raise RuntimeError(f"the sampled scene did not run as the checks "
                           f"assume: missing {missing}, "
                           f"{len(sample.get('trunk', []))} trunk outputs "
                           f"for {iters} iterations")
