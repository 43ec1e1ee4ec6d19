"""The device renderer against the port's numpy original, at small
sizes: the same seed gives the same frames and cameras."""

import numpy as np
import pytest
import torch

from benchmark.harness.scenes import as_loaded, render_two_plane_scene
from vggsfm_tpu_torch.utils.synth import render_two_plane_scene as original


@pytest.mark.parametrize("frames,size,seed,kw", [
    (3, 96, 5, {}),
    (4, 128, 7, {"baseline": 0.02, "fg_half_extent_frac": 0.6}),
])
def test_renderer_matches_the_original(frames, size, seed, kw):
    got = render_two_plane_scene(frames, size, seed, "cpu", **kw)
    want = original(frames, size, seed=seed, **kw)
    assert np.abs(got["images"].numpy() - want["images"]).max() < 1e-5
    np.testing.assert_array_equal(got["extrinsics"], want["extrinsics"])
    np.testing.assert_array_equal(got["intrinsics"], want["intrinsics"])


def test_loaded_form_is_8_bit_levels():
    x = torch.rand(2, 8, 8, 3)
    y = as_loaded(x)
    assert y.dtype == np.float32
    assert np.abs(y * 255 - np.round(y * 255)).max() < 1e-4
