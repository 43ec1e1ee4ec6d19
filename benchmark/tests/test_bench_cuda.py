"""On the card: one run of each cell (at the benchmark's own length: the
solve's numbers read the window's scenes) ends with a result line whose
check is correct, and the control at the cell's own size fails it."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["sparse-8q-4096", "video-144f-512", "sparse-3q-4096",
         "imc-bag25"]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    _need_card()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell_on_the_card(cell):
    _need_card()
    from benchmark.harness.cell import load_cell
    from benchmark.harness.checks import passes

    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "31415", "--modes", "fp8,tf32"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    readings = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    cfg, _ = load_cell(cell)
    assert any(not passes(r[m], *cfg["checks"][n])
               for n, r in readings.items() for m in ("fp8", "tf32")
               if m in r)
