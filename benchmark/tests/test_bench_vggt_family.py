"""The VGGT family (configuration vggt1b-ff-518, cell vggt-ff-48f-518),
brought by files of its own: the cell resolves to its checks, census
modules, kernel kind and work formula; at a size a CPU test run holds (the
configuration's own checks and limits, the model cut to 2 + 2 blocks 64
wide on 3 frames of 56 px) a sound run is correct, each fault makes
`correct` false through the number that reads it, and the control (the
reference in fp8 products in the program's place) fails the cell; the
five readers read a recorded record."""

import copy
import importlib
import time

import pytest
import torch

from benchmark.faults import plant
from benchmark.harness import family
from benchmark.harness.cell import load_cell, neural_readings, run_loaded
from benchmark.harness.checks import passes
from benchmark.harness.flops import count_calls

CELL = "vggt-ff-48f-518"
TINY = dict(img_size=56, embed_dim=64, depth=2, num_heads=4, dino_depth=2,
            dino_heads=4, trunk_depth=1, head_heads=4, dpt_features=16,
            dpt_out_channels=[8, 16, 32, 32], taps=[0, 0, 1, 1])


def tiny_vggt():
    cfg, wl = copy.deepcopy(load_cell(CELL))
    cfg["model_args"] = TINY
    cfg["runner"].update(img_size=56, conf_thres=2.0, max_points=300)
    wl["scene"]["frames"] = 3
    wl["pool"] = 2
    return cfg, wl


def run_tiny(seed: int) -> dict:
    torch.set_num_threads(4)
    cfg, wl = tiny_vggt()
    return run_loaded(cfg, wl, seed, 0.0, False, torch.device("cpu"),
                      time.perf_counter())


def test_cell_resolves_to_its_checks_census_and_kernel():
    from benchmark.families.vggt import kernels

    cfg, wl = load_cell(CELL)
    fam = family.of(cfg)
    assert fam.module.__name__ == "benchmark.families.vggt"
    assert set(cfg["checks"]) == set(fam.NEURAL) | set(fam.SCENE_READS)
    assert {n: e[3] for n, e in fam.NEURAL.items()} == {
        "agg_rel": "vggt", "camhead_rel": "vggt", "depth_rel": "vggt",
        "conf_rel": "vggt", "points_rel": None, "points_kept": None}
    assert cfg["timings"] == {"aggregator": ["vggt.aggregate"],
                              "heads": ["vggt.camera", "vggt.depth",
                                        "vggt.points"]}
    mods = fam.census_modules(torch.device("meta"))
    assert {k: type(m.module).__name__ for k, m in mods.items()} == {
        "aggregator": "Aggregator", "camera_head": "CameraHead",
        "depth_head": "DPTHead"}
    assert {k: v[:3] for k, v in fam.KERNELS.items()} == {
        "flash": ("vggsfm_tpu_torch.ops.attention", "flash_attention",
                  "attn")}
    q = torch.zeros(16, 65952, 64, dtype=torch.bfloat16)
    s = fam.KERNELS["flash"][3]((q, q, q, 1), {})
    assert s == {"BH": 16, "Lq": 65952, "Lk": 65952, "D": 64, "tsize": 2}
    scores = 16 * 65952 ** 2
    # the tensor cores' bound, just above the exponentials' (3.9e12 / s)
    assert fam.KERNELS["flash"][4](s) == 4 * 64 * scores / 989e12
    assert kernels.attn_work(s)[0] / kernels.EXP_PER_S \
        < fam.KERNELS["flash"][4](s)
    assert wl["scene"]["frames"] == 48 and cfg["runner"]["img_size"] == 518


def test_census_counts_the_published_model_on_meta():
    """The census runs the float32 reference at the published widths on
    meta tensors: the aggregator's count is its linear work and its
    attention over 48 frames."""
    fam = family.of(load_cell(CELL)[0])

    def t(*shape):
        return ("T", shape, "torch.float32")

    flops = count_calls(torch.device("cpu"),
                        [("aggregator", ((t(2, 518, 518, 3),), ()))],
                        fam.census_modules)
    P, S, C = 1374, 2, 1024
    attn = 24 * 4 * (S * P) ** 2 * C + 48 * 4 * S * P * P * C
    linear = 72 * 2 * S * P * 12 * C * C
    patch_embed = 2 * S * 37 * 37 * 3 * 14 * 14 * C
    assert flops == pytest.approx(attn + linear + patch_embed, rel=1e-9)


@pytest.fixture(scope="module")
def sound():
    return run_tiny(seed=2 ** 31 + 7)


def test_sound_run_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["failed"] == 0
    checks = {c["name"]: c["value"] for c in sound["checks"]}
    assert checks["points_kept"] == 0.0 and checks["nonfinite"] == 0.0


@pytest.mark.parametrize("fault", ["global_per_frame", "no_global_rope",
                                   "first_slot_everywhere"])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    from benchmark.families.vggt import FAULTS
    from benchmark.pipelines.vggt import Pipeline

    install, reads = FAULTS[fault]
    number = reads["vggt"]
    plant(Pipeline, install, monkeypatch.setattr)
    rec = run_tiny(seed=2 ** 31 + 7)
    cfg, _ = tiny_vggt()
    assert not passes(rec["readings"][number]["f32"],
                      *cfg["checks"][number])
    assert rec["correct"] is False


def test_control_fails_the_cell(sound):
    cfg, _ = tiny_vggt()
    fp8 = neural_readings(cfg, sound["max_pts"], torch.device("cpu"),
                          sound["frames"], sound["sample"], ("fp8",))
    failed = [n for n, r in fp8.items()
              if not passes(r["fp8"], *cfg["checks"][n])]
    assert failed
    for name in ("agg_rel", "camhead_rel", "depth_rel"):
        assert fp8[name]["fp8"] >= 3 * sound["readings"][name]["f32"]


RECORD = {
    "window_s": 20.0,
    "config": {"timings": {"aggregator": ["vggt.aggregate"],
                           "heads": ["vggt.camera", "vggt.depth",
                                     "vggt.points"]}},
    "scenes": [{"frames": 48, "seconds": 2.8,
                "timings": {"vggt.aggregate": 2.5, "vggt.camera": 0.02,
                            "vggt.depth": 0.2, "vggt.points": 0.01}}] * 2,
    "trace": {"kernels": {"attn": {"bound_s": 0.5, "device_s": 2.0,
                                   "calls": 1}},
              "program": {"frames": 48, "layers": {
                  "aggregator": {"idle_s": 0.096}}}},
    "model_flops": 4.0e15,
}


@pytest.mark.parametrize("name,want", [
    ("aggregate_ms_per_frame", 1e3 * 5.0 / 96),
    ("heads_ms_per_frame", 1e3 * 0.46 / 96),
    ("aggregate_idle_ms_per_frame", 2.0),
    ("attn_roofline", 25.0),
    ("vggt_step_mfu", 100 * 4.0e15 / (20.0 * 989e12)),
])
def test_reader(name, want):
    got = importlib.import_module(f"benchmark.metrics.{name}").read(RECORD)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["attn_roofline", "vggt_step_mfu",
                                  "aggregate_idle_ms_per_frame"])
def test_untraced_record_reads_nothing(name):
    rec = {k: v for k, v in RECORD.items()
           if k not in ("trace", "model_flops")}
    assert importlib.import_module(
        f"benchmark.metrics.{name}").read(rec) is None


# ------------------------------------------------------------- the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
def test_short_run_is_correct_on_the_card():
    import json
    import os
    import subprocess
    import sys

    _need_card()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2718281828", "--seconds", "10", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
