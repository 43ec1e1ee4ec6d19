"""Rules of the port package.

* No module of vggsfm_tpu_torch/ (nor chip_smoke.py) imports jax, flax
  or the JAX package.
* Entry points run on the GPU unless asked for the CPU: asking for
  "cuda" where there is none raises (the CLIs' --device too, the video
  runner, its CLI and the IMC CLI included).
* ops/_build.py imports without CUDA and builds for sm_90a.
* chip_smoke.py fails without a GPU, and alone in a directory.
* On a GPU (marked `cuda`, skipped elsewhere): the preliminary cameras on
  the card agree with the CPU on the same injected RANSAC samples, and
  so does the SfM solve on the same PnP draws.
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
            "extractors/dog.py", "extractors/superpoint.py",
            "utils/precision.py", "geometry/rotations.py",
            "geometry/distortion.py", "geometry/cameras.py",
            "geometry/metrics.py", "ops/eigh.py", "ops/svd3.py",
            "ops/polynomial.py", "ops/triangulation.py", "twoview/utils.py",
            "twoview/fundamental.py", "twoview/essential.py",
            "twoview/preliminary.py", "utils/synth.py", "runner.py",
            "twoview/pnp.py", "ba/lm.py", "sfm/refine.py",
            "sfm/triangulator.py", "sfm/normalize.py", "io/__init__.py",
            "io/colmap.py", "io/bridge.py", "io/glb.py",
            "datasets/__init__.py", "datasets/demo_loader.py",
            "demo.py", "models/dpt.py", "models/dinov2.py",
            "models/convert.py", "utils/depth.py", "utils/visualizer.py",
            "io/ply.py", "ba/sparse_lm.py", "geometry/alignment.py",
            "parallel/merge.py", "video/__init__.py", "video/runner.py",
            "video_demo.py", "datasets/camera_transform.py",
            "datasets/imc.py", "datasets/imc_submission.py", "imc_eval.py",
            "twoview/homography.py", "twoview/five_point.py",
            "twoview/epnp.py"} <= rel
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


def test_dense_entry_point_raises_without_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    """The dense depth stage runs where the runner runs: asked for the GPU
    where there is none, the runner raises before any model is built; with
    device="cpu" it builds its depth model there (seeded; a tiny one here)
    and `dense_reconstruct` runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import functools

    import numpy as np

    from vggsfm_tpu_torch import runner as trun
    from vggsfm_tpu_torch.models.dpt import DepthAnything

    cfg = trun.RunnerConfig(dense_depth=True, depth_input_size=28,
                            precision="f32", img_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.VGGSfMRunner(cfg)
    monkeypatch.setattr(trun, "DepthAnything", functools.partial(
        DepthAnything, tap_layers=(0, 1, 2, 3), features=16,
        out_channels=(8, 16, 24, 32), embed_dim=32, depth=4, num_heads=4))
    runner = trun.VGGSfMRunner(cfg, device="cpu")
    assert next(runner._load_depth_model().parameters()).device.type == "cpu"
    rng = np.random.default_rng(0)
    S, N = 2, 20
    pred = runner.dense_reconstruct(
        rng.uniform(size=(1, S, 32, 32, 3)).astype(np.float32), {
            "extrinsics": np.tile(np.eye(3, 4, dtype=np.float32), (S, 1, 1)),
            "points3d": (rng.normal(size=(N, 3)) + [0, 0, 4]).astype(
                np.float32),
            "pred_track": rng.uniform(2, 30, size=(1, S, N, 2)).astype(
                np.float32),
            "valid_2d_mask": np.ones((S, N), bool),
            "valid_tracks": np.ones(N, bool)})
    assert pred["depth_maps"].device.type == "cpu"
    assert pred["depth_maps"].shape == (S, 32, 32)


def test_demo_cli_raises_without_gpu_unless_asked_for_the_cpu(tmp_path):
    """`python -m vggsfm_tpu_torch.demo` runs on the GPU by default and
    raises before it reads the scene where there is none; with
    `--device cpu` it goes on to the scene (here an empty folder)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch import demo

    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main([str(tmp_path / "missing")])
    with pytest.raises(FileNotFoundError, match="no images"):
        demo.main([str(tmp_path), "--device", "cpu"])


def test_video_entry_points_raise_without_gpu_unless_asked_for_the_cpu(
        tmp_path):
    """The video runner runs where its sparse runner runs, the GPU unless
    the CPU is named: building it for "cuda" where there is none raises,
    and so does `python -m vggsfm_tpu_torch.video_demo` before it reads
    the frames; with `--device cpu` the CLI goes on to the frames (here an
    empty folder)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch import video_demo
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
    from vggsfm_tpu_torch.video import VideoConfig, VideoRunner

    cfg = RunnerConfig(img_size=64, query_frame_num=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoRunner(VGGSfMRunner(cfg), VideoConfig())
    assert VideoRunner(VGGSfMRunner(cfg, device="cpu"),
                       VideoConfig()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video_demo.main([str(tmp_path / "missing")])
    with pytest.raises(FileNotFoundError, match="no images"):
        video_demo.main([str(tmp_path), "--device", "cpu"])


def test_imc_cli_raises_without_gpu_unless_asked_for_the_cpu(tmp_path):
    """`python -m vggsfm_tpu_torch.imc_eval` runs on the GPU by default and
    raises before it reads the IMC tree where there is none; with
    `--device cpu` it goes on to the tree (here an empty folder: no bags,
    exit code 1, as the JAX CLI)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from vggsfm_tpu_torch import imc_eval

    with pytest.raises(RuntimeError, match="device='cpu'"):
        imc_eval.main(["--imc-dir", str(tmp_path / "missing")])
    assert imc_eval.main(["--imc-dir", str(tmp_path), "--device",
                          "cpu"]) == 1


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


def _two_view_tracks(S=4, N=1024, outliers=0.2, seed=0):
    """Tracks of N points 4-8 in front of S planted cameras (focal 640,
    640 x 480 px), 0.5 px noise, the first `outliers` share of each
    non-query frame's tracks uniform pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], size=(N, 3))
    tracks = np.zeros((1, S, N, 2))
    for s in range(S):
        a = 0.04 * s
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cam = X @ R.T + np.array([0.3 * s, 0.02 * s, 0.0])
        tracks[0, s] = 640 * cam[:, :2] / cam[:, 2:] + [320, 240]
    tracks += rng.normal(scale=0.5, size=tracks.shape)
    n_out = int(outliers * N)
    tracks[0, 1:, :n_out] = rng.uniform([0, 0], [640, 480],
                                        size=(S - 1, n_out, 2))
    return torch.as_tensor(tracks, dtype=torch.float32)


@pytest.mark.cuda
def test_preliminary_cameras_gpu_match_cpu():
    """`estimate_preliminary_cameras` on the card and on the CPU with the
    same injected samples, TF32 allowed outside the stage: extrinsics
    within 1e-3, inlier masks equal on 99% of the tracks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vggsfm_tpu_torch.twoview.preliminary import (
        estimate_preliminary_cameras,
    )
    from vggsfm_tpu_torch.twoview.utils import generate_samples

    tracks = _two_view_tracks()
    vis = torch.ones(tracks.shape[:3])
    idx, _ = generate_samples(torch.Generator().manual_seed(1),
                              tracks.shape[2], 256, 7)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = {dev: estimate_preliminary_cameras(
            tracks.to(dev), vis.to(dev), 640, 480, max_error=4.0,
            lo_num=32, max_ransac_iters=256, sample_idx=idx)
            for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    assert torch.backends.cuda.matmul.allow_tf32 == flags
    g, c = out["cuda"], out["cpu"]
    assert float((g["extrinsics"].cpu() - c["extrinsics"]).abs().max()) \
        <= 1e-3
    same = (g["fmat_inlier_mask"].cpu() == c["fmat_inlier_mask"])
    assert float(same.float().mean()) >= 0.99


@pytest.mark.cuda
def test_run_sfm_gpu_matches_cpu():
    """`run_sfm` on the card and on the CPU from the same initial cameras
    and PnP draws (CPU generators), TF32 allowed outside the solve:
    relative rotations within 0.1 deg, translation directions within
    1 deg, the masks equal on 99%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vggsfm_tpu_torch.geometry.metrics import relative_pose_errors
    from vggsfm_tpu_torch.sfm import SfmConfig, run_sfm

    S = 4
    tracks = _two_view_tracks(S=S, N=512)[0]
    K = torch.tensor([[640.0, 0, 320], [0, 640, 240], [0, 0, 1]])
    extr = torch.zeros(S, 3, 4)
    extr[:, :, :3] = torch.eye(3)
    extr[:, 0, 3] = 0.3 * torch.arange(S)
    vis = torch.ones(tracks.shape[:2])
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = {dev: run_sfm(extr.to(dev), K.expand(S, 3, 3).to(dev),
                            tracks.to(dev), vis.to(dev), (640, 480),
                            cfg=SfmConfig(ba_max_iterations=10))
               for dev in ("cuda", "cpu")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    g, c = out["cuda"], out["cpu"]
    r_err, t_err, m = relative_pose_errors(g["extrinsics"].cpu(),
                                           c["extrinsics"])
    assert float(r_err[m].max()) <= 0.1
    assert float(t_err[m].max()) <= 1.0
    for k in ("valid_tracks", "valid_2d_mask", "valid_frame_mask"):
        assert float((g[k].cpu() == c[k]).float().mean()) >= 0.99, k
