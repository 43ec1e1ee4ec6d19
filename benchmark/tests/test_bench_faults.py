"""The run with the timed path broken underneath (the chip's look
skipped, everything else as in a run, at a size a CPU test run holds):
each answer altered where it is produced, and each solve that returns its
state unchanged, makes `correct` false through the number that reads it.
Each fault (benchmark/faults.py) is installed after the warm-up, beneath
the benchmark's own hooks, so what the check reads is what the program
passed on."""

import pytest

from benchmark.faults import FAULTS, plant
from benchmark.harness.checks import passes
from benchmark.pipelines.sparse import Pipeline
from benchmark.tests._tiny import run_tiny, tiny_sparse

SPARSE = [name for name, (_, reads) in FAULTS.items() if "sparse" in reads]


@pytest.mark.parametrize("fault", SPARSE)
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    install, reads = FAULTS[fault]
    number = reads["sparse"]
    plant(Pipeline, install, monkeypatch.setattr)
    rec = run_tiny(seed=7)
    cfg, _ = tiny_sparse()
    value = rec["readings"][number]["f32"]
    assert not passes(value, *cfg["checks"][number])
    assert rec["correct"] is False
