"""The three accepted cells resolve, through their pipeline modules, to
the checks, reference parts, FLOP census modules, kernel kinds, roofline
groups and work formulas the benchmark had before a family could bring
its own: the same names and texts, and the same numbers on fixed shapes.
And the trace's reduction raises on a kernel kind nobody registered."""

import types

import pytest
import torch

from benchmark.harness import family, trace
from benchmark.harness.cell import load_cell
from benchmark.harness.flops import count_calls

CELLS = ["sparse-8q-4096", "video-144f-512", "sparse-3q-4096"]

# check -> (reference part, what it reads), as the harness had them
NEURAL = {
    "camera_rel": ("camera", "camera predictor, image features"),
    "trunk_rel": ("camera", "camera trunk, first iteration"),
    "corner_miss": (None, "query points: sift+harris candidates"),
    "aliked_rel": ("aliked", "ALIKED score map"),
    "query_miss": ("aliked", "query points: NMS and top-K of the score map"),
    "coarse_px": ("tracker", "coarse tracker, tracks"),
    "fine_px": ("tracker", "fine tracker, patch tracks"),
}
SCENE = {
    "pose_err_deg": "solve, final cameras against the planted, median scene",
    "reproj_over": "solve, kept observations beyond the last gate",
    "valid_tracks": "solve, triangulated tracks, fewest in a scene",
}
CENSUS = {"coarse": "BaseTrackerPredictor", "fine": "BaseTrackerPredictor",
          "coarse_fnet": "BasicEncoder", "fine_fnet": "ShallowEncoder",
          "camera": "CameraPredictor", "dino": "DinoVisionTransformer",
          "aliked": "ALIKED"}
KINDS = {
    "block": ("vggsfm_tpu_torch.models.layers", "fused_transformer_block",
              "former"),
    "mlp": ("vggsfm_tpu_torch.models.layers", "fused_ln_mlp", "former"),
    "attn": ("vggsfm_tpu_torch.models.layers", "fused_ln_attn", "former"),
    "corr": ("vggsfm_tpu_torch.models.tracker", "corr_sample_kernel",
             "corr"),
}


@pytest.mark.parametrize("cell", CELLS)
def test_checks_resolve_as_before(cell):
    cfg, _ = load_cell(cell)
    fam = family.of(cfg)
    for name in cfg["checks"]:
        if name in NEURAL:
            assert fam.NEURAL[name][3:] == NEURAL[name]
        else:
            assert fam.entry("SCENE_READS", name) == SCENE[name]
    assert set(fam.NEURAL) == set(NEURAL)
    assert fam.over_window("pose_err_deg", [0.3, 57.0, 0.4], "<=") == 0.4
    assert fam.over_window("valid_tracks", [9.0, 5.0], ">=") == 5.0
    assert fam.scene_failed({"valid_tracks": 0.0})
    assert fam.want_kwargs("query_miss", 4096) == {"max_pts": 4096}
    assert fam.want_kwargs("coarse_px", 4096) == {}


@pytest.mark.parametrize("cell", CELLS)
def test_census_and_kernels_resolve_as_before(cell):
    cfg, _ = load_cell(cell)
    fam = family.of(cfg)
    mods = fam.census_modules(torch.device("meta"))
    assert {k: type(m).__name__ for k, m in mods.items()} == CENSUS
    assert {k: v[:3] for k, v in fam.KERNELS.items()} == KINDS


def _corr_args(out_dtype):
    g = torch.Generator().manual_seed(0)
    coords = torch.rand(2, 5, 2, generator=g) * 9
    levels = [torch.zeros(2, 12, 10, 8, dtype=torch.bfloat16),
              torch.zeros(2, 6, 5, 8, dtype=torch.bfloat16)]
    return (levels, coords, torch.zeros(2, 5, 8), 1), {"out_dtype":
                                                        out_dtype}


def test_kernel_shapes_and_bounds_are_the_frozen_numbers():
    kinds = family.of(load_cell("sparse-8q-4096")[0]).KERNELS

    def shapes(kind, args, kwargs=None):
        return kinds[kind][3](args, kwargs or {})

    x = torch.zeros(6, 4, dtype=torch.bfloat16)
    base = {"R": 6, "C": 4, "tsize": 2, "dtype": "torch.bfloat16"}
    assert shapes("block", (x, 0, 0, 0, 0, torch.zeros(10, 2), 0, 0, 0,
                            3)) == {**base, "M": 10, "L": 3}
    assert shapes("mlp", (x, torch.zeros(10, 2))) == {**base, "M": 10}
    assert shapes("attn", (x, 0, 0, 0, 0, 7)) == {**base, "L": 7}
    corr = {}
    for dtype in (torch.float32, torch.bfloat16):
        s = shapes("corr", *_corr_args(dtype))
        assert {k: v for k, v in s.items() if k != "coords"} == {
            "levels": [(2, 12, 10, 8), (2, 6, 5, 8)], "radius": 1, "C": 8,
            "tsize": 2, "out_dtype": str(dtype)}
        corr[dtype] = s

    def bound(kind, s):
        return kinds[kind][4](s)

    assert bound("block", dict(R=33280, L=8, C=384, M=1536, tsize=2,
                               dtype="torch.bfloat16")) \
        == 0.00011949949540950455
    assert bound("mlp", dict(R=32768, C=384, M=1536, tsize=2,
                             dtype="torch.bfloat16")) == 7.81692733346815e-05
    assert bound("mlp", dict(R=64, C=768, M=3072, tsize=4,
                             dtype="torch.float32")) == 9.01462352238806e-06
    assert bound("attn", dict(R=64, L=8, C=768, tsize=4,
                              dtype="torch.float32")) == 4.530787343283582e-06
    assert bound("corr", corr[torch.float32]) == 1.0077611940298508e-09
    assert bound("corr", corr[torch.bfloat16]) == 9.002985074626866e-10


def test_flop_count_is_the_frozen_number():
    fam = family.of(load_cell("sparse-3q-4096")[0])

    def t(*shape):
        return ("T", shape, "torch.float32")

    census = ([("coarse_fnet", ((t(2, 64, 64, 3),), ()))] * 3
              + [("aliked", ((t(1, 64, 64, 3),), ())),
                 ("fine_fnet", ((t(4, 32, 32, 3),), ()))])
    assert count_calls(torch.device("cpu"), census,
                       fam.census_modules) == 6620790784.0


def test_reduce_raises_on_an_unregistered_kind():
    kinds = family.of(load_cell("sparse-8q-4096")[0]).KERNELS
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [])))
    with pytest.raises(LookupError, match="'flash'"):
        trace.reduce(prof, 1.0, 8, [("flash", {})], kinds)
    assert trace.reduce(prof, 1.0, 8, [("corr", {})], kinds)["kernels"] \
        == {}
