"""Rules of the port package.

* No module of vggsfm_tpu_torch/ (nor chip_smoke.py) imports jax, flax
  or the JAX package.
* Entry points run on the GPU unless asked for the CPU: asking for
  "cuda" where there is none raises.
* ops/_build.py imports without CUDA and builds for sm_90a.
* chip_smoke.py fails without a GPU, and alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vggsfm_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "vggsfm_tpu")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 10
    rel = {os.path.relpath(p, PKG) for p in files}
    assert {"ops/corr.py", "extractors/aliked.py", "extractors/cnn.py",
            "extractors/corners.py", "extractors/dispatch.py",
            "extractors/dog.py", "extractors/superpoint.py"} <= rel
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imports(p)
           if m.split(".")[0] in BANNED]
    assert bad == []


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch.runner import VGGSfMRunner, resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        VGGSfMRunner()  # device defaults to "cuda"
    assert resolve_device("cpu").type == "cpu"


def test_build_module_imports_without_cuda_and_targets_sm90a():
    from vggsfm_tpu_torch.ops import _build

    cmd = _build.nvcc_command("/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == "/x/lib.so"
    assert any(c.endswith("fused_former.cu") for c in cmd)
    assert any(c.endswith("corr_sample.cu") for c in cmd)
    assert os.path.commonpath([_build.BUILD_DIR, PKG]) == PKG
    for name in (_build.CUDA_SOURCES + _build.HEADERS + _build.EMU_SOURCES
                 + _build.EMU_HEADERS):
        assert os.path.exists(os.path.join(_build.CSRC, name)), name


def test_extraction_runs_where_the_image_lies_and_raises_without_gpu():
    """The extractors run on their input's device; the runner's entry
    point puts the frames on the GPU, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch.extractors import get_query_points
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    xy, valid = get_query_points(torch.rand(32, 32, 3), None, "grid", 9)
    assert xy.device.type == "cpu" and xy.shape == (9, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VGGSfMRunner(RunnerConfig(query_method="aliked"))
    with pytest.raises((RuntimeError, AssertionError)):
        get_query_points(torch.rand(32, 32, 3).to("cuda"), None, "grid", 9)


@pytest.mark.parametrize("loader", ["load_aliked", "load_superpoint",
                                    "load_sddh"])
def test_extractor_loaders_raise_without_gpu(loader):
    """Called plainly the cached CNN loaders build on the GPU; the CPU is
    for the caller that names it."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch.extractors import cnn

    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(cnn, loader)()
    assert next(getattr(cnn, loader)("cpu").parameters()).device.type == "cpu"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_gpu(tmp_path):
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    proc = _run_smoke(alone)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
