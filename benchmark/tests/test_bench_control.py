"""The control at a size a test run holds: the reference itself in fp8
products, put in the program's place, reads each neural number at three
times the program's reading or more, and fails its limit."""

import pytest
import torch

from benchmark.harness.cell import neural_readings
from benchmark.tests._tiny import run_tiny, tiny_sparse


@pytest.fixture(scope="module")
def readings():
    rec = run_tiny(seed=7)
    cfg, _ = tiny_sparse()
    out = rec["readings"]
    for name, r in neural_readings(cfg, rec["max_pts"], torch.device("cpu"),
                                   rec["frames"], rec["sample"],
                                   ("fp8",)).items():
        out[name].update(r)
    return out


@pytest.mark.parametrize("name", ["camera_rel", "trunk_rel", "aliked_rel",
                                  "query_miss", "coarse_px", "fine_px"])
def test_control_reads_three_times_the_program(readings, name):
    r = readings[name]
    assert r["fp8"] >= 3 * r["f32"] and r["fp8"] > 0


def test_control_fails_the_cell(readings):
    from benchmark.harness.checks import passes

    cfg, _ = tiny_sparse()
    failed = [n for n, r in readings.items() if "fp8" in r
              and not passes(r["fp8"], *cfg["checks"][n])]
    assert failed
