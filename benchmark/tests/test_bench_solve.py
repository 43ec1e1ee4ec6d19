"""`pose_err_deg` on a rendered scene's planted cameras: a sound answer
(the planted poses, nudged by a small rotation) passes the limit, and
one turned 15 or 30 degrees in some frames fails it; and how the window's scenes
make one reading. (At a size a CPU test run holds the port's solve does
not reach the limit, so the full-run fault tests cannot show this
part.)"""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import checks
from benchmark.harness.cell import load_cell
from benchmark.harness.scenes import render_two_plane_scene


def _rot(deg: float) -> torch.Tensor:
    a = math.radians(deg)
    return torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                         [math.sin(a), math.cos(a), 0.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)


@pytest.fixture(scope="module")
def planted():
    s = render_two_plane_scene(8, 64, np.random.SeedSequence([81, 3]),
                               torch.device("cpu"), baseline=0.06,
                               fg_half_extent_frac=0.35, z_fg=2.0, z_bg=4.0)
    return torch.as_tensor(s["extrinsics"]).double()


def _turned(extr, deg):
    """Frame k turned by deg x (k mod 3) degrees."""
    out = extr.clone()
    for k in range(len(extr)):
        out[k, :, :3] = _rot(deg * (k % 3)) @ extr[k, :, :3]
    return out


def test_sound_passes_and_turned_fails(planted):
    cfg, _ = load_cell("sparse-8q-4096")
    side, limit = cfg["checks"]["pose_err_deg"]
    nudged = planted.clone()
    nudged[:, :, :3] = _rot(0.1) @ planted[:, :, :3]
    assert checks.passes(checks.pose_err_deg(nudged, planted), side, limit)
    assert not checks.passes(checks.pose_err_deg(_turned(planted, 15.0),
                                                 planted), side, limit)


@pytest.mark.parametrize("name,side,values,want", [
    ("pose_err_deg", "<=", [0.3, 57.0, 0.4, 0.5, 45.0], 0.5),
    ("reproj_over", "<=", [0.0, 6e-5, 0.0], 6e-5),
    ("valid_tracks", ">=", [18771.0, 5766.0, 8000.0], 5766.0),
])
def test_window_reading(name, side, values, want):
    assert checks.over_window(name, values, side) == want
