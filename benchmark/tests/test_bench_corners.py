"""The plain reference of the weights-free query points ('sift+harris',
benchmark/reference/corners) against the port's extractors on a rendered
frame, and the video cell's `corner_miss` on it: the program reads
nothing, the control (the reference's blurs in TF32 products) and the
port's candidates moved by a pixel read above the limit."""

import numpy as np
import pytest
import torch

from benchmark.harness import checks
from benchmark.harness.cell import load_cell
from benchmark.harness.record import frame_sums
from benchmark.harness.scenes import as_loaded, render_two_plane_scene


@pytest.fixture(scope="module")
def case():
    from vggsfm_tpu_torch.extractors.dispatch import get_query_points

    s = render_two_plane_scene(2, 192, np.random.SeedSequence([144, 0]),
                               torch.device("cpu"), baseline=0.02,
                               fg_half_extent_frac=0.6, z_fg=2.0, z_bg=4.0)
    frames = torch.as_tensor(as_loaded(s["images"]))
    xy, valid = get_query_points(frames[1], torch.Generator().manual_seed(0),
                                 "sift+harris", 256)
    sample = {"corners": dict(frame_sum=frame_sums(frames[1:2]),
                              method="sift+harris", max_pts=256, xy=xy,
                              valid=valid)}
    return frames, sample


def _miss(frames, sample, mode="f32"):
    got = checks.corner_got(sample)
    if mode != "f32":
        got = checks.corner_want(None, frames, sample, mode)
    return checks.query_miss(got, checks.corner_want(None, frames, sample,
                                                     "f32"))


def test_reference_finds_the_ports_points(case):
    frames, sample = case
    assert int(sample["corners"]["valid"].sum()) > 100
    assert _miss(frames, sample) == 0.0


def test_control_and_moved_candidates_fail(case):
    frames, sample = case
    cfg, _ = load_cell("video-144f-512")
    side, limit = cfg["checks"]["corner_miss"]
    assert not checks.passes(_miss(frames, sample, "tf32"), side, limit)
    moved = {"corners": {**sample["corners"],
                         "xy": sample["corners"]["xy"] + 1.0}}
    assert not checks.passes(_miss(frames, moved), side, limit)
