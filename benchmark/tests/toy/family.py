"""The toy family's declarations (benchmark/README.md), made only of
files of its own: one neural check against a float32 reference, one
per-scene check, one kernel kind in a roofline group of its own, one
FLOP census module and one fault."""

import statistics

import torch

from benchmark.harness.checks import precision
from benchmark.harness.work import HBM_BYTES_PER_S, PEAK_FLOPS
from benchmark.tests.toy.reference import ToyRef, toy_weights


def _ref(cfg, device):
    m = cfg["model"]
    with torch.device(device):
        ref = ToyRef(m["c"], m["h"])
    ref.load_state_dict(toy_weights(cfg["weights_seed"], m["c"], m["h"]))
    return ref.eval()


def reference_models(cfg, device, parts):
    return {part: _ref(cfg, device) for part in parts}


def census_modules(device):
    with torch.device(device):
        return {"net": ToyRef(32, 64).eval()}


def feat_got(sample):
    return sample["feat"].float()


@torch.inference_mode()
def feat_want(ref, frames, sample, mode):
    with precision(mode):
        return ref["net"](frames.flatten(0, 1))


def feat_rel(got, want):
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


NEURAL = {"feat_rel": (feat_got, feat_want, feat_rel, "net",
                       "toy net, features")}
SCENE_READS = {"frames_solved": "toy solve, cameras, fewest in a scene"}


def over_window(name, values, side):
    return statistics.median(values) if side == "<=" else min(values)


def scene_failed(solve):
    return not solve["frames_solved"]


def want_kwargs(name, max_pts):
    return {}


def max_query_pts(pipe):
    return None


def check_sample(pipe, sample):
    if "feat" not in sample:
        raise RuntimeError("the sampled call was not seen")


def mm_shapes(args, kwargs):
    x, w = args[:2]
    return {"R": int(x.shape[0]), "C": int(x.shape[1]), "H": int(w.shape[1])}


def mm_bound(s):
    flops = 2 * s["R"] * s["C"] * s["H"]
    nbytes = 2 * (s["R"] * s["C"] + s["C"] * s["H"]) + 4 * s["R"] * s["H"]
    return max(flops / PEAK_FLOPS["torch.bfloat16"],
               nbytes / HBM_BYTES_PER_S)


KERNELS = {"toymm": ("benchmark.tests.toy.program", "scaled_mm", "toy",
                     mm_shapes, mm_bound)}


def feat_scaled(pipe, patch):
    """The net's features 10% off."""
    forward = pipe.net.forward
    patch(pipe.net, "forward", lambda *a, **k: forward(*a, **k) * 1.1)


FAULTS = {"feat_scaled": (feat_scaled, {"toy": "feat_rel"})}
