"""The comparison that decides `correct`: what the timed path produced,
held against what does not come from the program: the plain reference
(benchmark/reference) run in float32 on the same frames and the same
weights, after the window, and the cameras planted in the scenes.

What a configuration compares is its family's (`harness/family.py`): each
neural check is three functions of the family's `NEURAL` (what the program
produced, `got`; what the reference computes in a given precision,
`want`; the number comparing two such outputs), run by `readings`; the
per-scene numbers of the solve come from the pipeline's `solve_checks`,
made one reading by the family's `over_window`. Here are what every family
shares: the reference's precisions, the readings, the solve's geometry and
the comparison with a limit.

A configuration's `checks` give each number its side and limit.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness.auc import relative_pose_errors
from benchmark.reference.precision import TF32, rounded_products


def precision(mode: str):
    """The reference's precision: 'f32', or the control's 'tf32' / 'bf16'
    / 'fp8' products."""
    if mode == "f32":
        return contextlib.nullcontext()
    return rounded_products({"tf32": TF32, "bf16": torch.bfloat16,
                             "fp8": torch.float8_e4m3fn}[mode])


def readings(entry: tuple, ref, frames, sample, modes=("f32",),
             **kw) -> dict:
    """mode -> the number a family's `NEURAL` entry compares: under 'f32'
    the program's output against the float32 reference, under a lower
    precision the reference's own output in that precision against it
    (the control)."""
    got_fn, want_fn, fn = entry[:3]
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


def passes(value: float, side: str, limit: float) -> bool:
    return value <= limit if side == "<=" else value >= limit


# the VGGSfM family's checks, importable from here as before
_MOVED = ("reference_models", "camera_got", "camera_want", "camera_rel",
          "trunk_got", "trunk_want", "trunk_rel", "aliked_got",
          "aliked_want", "aliked_rel", "query_got", "query_want",
          "corner_got", "corner_want", "query_miss", "coarse_got",
          "coarse_want", "coarse_px", "fine_got", "fine_want", "fine_px",
          "NEURAL", "over_window")


def __getattr__(name):
    if name in _MOVED:
        from benchmark.families.vggsfm import checks
        return getattr(checks, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
