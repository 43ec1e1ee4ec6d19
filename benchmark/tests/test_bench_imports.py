"""What the benchmark's processes load: nothing of the JAX stack or of the
JAX package (top-level names compared whole, since the port's name
begins with the JAX package's), and the reference nothing of the port."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX = {"jax", "jaxlib", "flax", "vggsfm_tpu"}


def loaded_by(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = loaded_by(
        "import benchmark.run, benchmark.control\n"
        "import benchmark.harness.cell, benchmark.harness.flops\n"
        "import benchmark.pipelines.sparse, benchmark.pipelines.video\n"
        "import vggsfm_tpu_torch.runner, vggsfm_tpu_torch.video\n"
        "import glob, importlib, os\n"
        "for f in glob.glob('benchmark/metrics/*.py'):\n"
        "    importlib.import_module('benchmark.metrics.' + "
        "os.path.basename(f)[:-3])\n")
    assert not mods & JAX
    assert "vggsfm_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded_by(
        "import glob, importlib, os\n"
        "for f in sorted(glob.glob('benchmark/reference/*.py')):\n"
        "    importlib.import_module('benchmark.reference.' + "
        "os.path.basename(f)[:-3])\n")
    assert not mods & (JAX | {"vggsfm_tpu_torch"})
