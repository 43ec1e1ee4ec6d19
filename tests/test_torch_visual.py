"""The port's visual and profiling outputs and its PLY writer against the
JAX package's, on the CPU.

* The visualizers on the same arrays: every PNG's pixels, every GIF
  frame and, where OpenCV is installed, every decoded mp4 frame equal the
  JAX visualizer's (codec bytes vary by version, decoded frames of the
  same input do not).
* `io/ply.py`: the files equal the JAX package's byte for byte.
* The CLI on a rendered 4 x 128 px scene with --dense-depth,
  --visual-tracks, --reproj-frames, --visual-query-points and
  --profile-dir (a --config YAML sets depth_input_size 28): the depth maps
  at each image's original resolution, the visuals and a trace that names
  the stages; a call that raises leaves no profiler running.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from test_torch_runner_export import _fast_seeded_init
from vggsfm_tpu.io import ply as jply
from vggsfm_tpu.utils import visualizer as jvis
from vggsfm_tpu_torch import demo as tdemo
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch.io import ply as tply
from vggsfm_tpu_torch.models.camera import CameraPredictor
from vggsfm_tpu_torch.models.dpt import DepthAnything
from vggsfm_tpu_torch.utils import depth as tdepth
from vggsfm_tpu_torch.utils import synth as tsynth
from vggsfm_tpu_torch.utils import visualizer as tvis


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small ops: intra-op threads gain them nothing under several test
    workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def _scene_arrays(S=3, H=40, W=56, N=300, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(S, H, W, 3)).astype(np.float32)
    tracks = rng.uniform(-3, W + 3, size=(S, N, 2)).astype(np.float32)
    tracks[..., 1] *= H / W
    vis = rng.uniform(size=(S, N)).astype(np.float32)
    return rng, images, tracks, vis


def test_draw_points_and_query_points_match_jax(tmp_path):
    """`draw_points` (with a validity mask, points off the image and on
    its border) and `visualize_query_points` (float and uint8 frames)
    give the JAX visualizer's pixels."""
    rng, images, tracks, vis = _scene_arrays()
    colors = jvis._colormap(300)
    np.testing.assert_array_equal(tvis._colormap(300), colors)
    u8 = (images[0] * 255).astype(np.uint8)
    valid = vis[0] > 0.3
    np.testing.assert_array_equal(
        tvis.draw_points(u8, tracks[0], colors, radius=3, valid=valid),
        jvis.draw_points(u8, tracks[0], colors, radius=3, valid=valid))
    for img in (images[1], u8):
        a = tvis.visualize_query_points(img, tracks[1],
                                        str(tmp_path / "t" / "q.png"),
                                        valid=valid)
        b = jvis.visualize_query_points(img, tracks[1],
                                        str(tmp_path / "j" / "q.png"),
                                        valid=valid)
        np.testing.assert_array_equal(_pixels(a), _pixels(b))


def test_visualize_tracks_and_reprojections_match_jax(tmp_path):
    """`visualize_tracks` (PNGs and the GIF's frames decoded, 300 tracks
    capped at 256) and `visualize_reprojections` with SIMPLE_RADIAL
    `extra_params` give the JAX visualizer's pixels, under the same file
    names."""
    rng, images, tracks, vis = _scene_arrays()
    S, H, W = images.shape[:3]
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    a = tvis.visualize_tracks(images, tracks, vis, tdir)
    b = jvis.visualize_tracks(images, tracks, vis, jdir)
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for pa, pb in zip(a, b):
        if pa.endswith(".png"):
            np.testing.assert_array_equal(_pixels(pa), _pixels(pb))
        elif pa.endswith(".gif"):
            fa, fb = _gif_frames(pa), _gif_frames(pb)
            assert len(fa) == len(fb) == S
            for x, y in zip(fa, fb):
                np.testing.assert_array_equal(x, y)

    points = (rng.normal(size=(300, 3)) + [0, 0, 5]).astype(np.float32)
    extr = np.zeros((S, 3, 4), np.float32)
    extr[:, :, :3] = np.eye(3)
    extr[:, 0, 3] = 0.1 * np.arange(S)
    intr = np.broadcast_to(np.array([[40, 0, W / 2], [0, 40, H / 2],
                                     [0, 0, 1]], np.float32), (S, 3, 3))
    extra = np.array([[0.05], [-0.1], [0.02]], np.float32)
    valid = vis[0] > 0.2
    a = tvis.visualize_reprojections(images, tracks, points, extr, intr,
                                     valid, tdir, extra_params=extra)
    b = jvis.visualize_reprojections(images, tracks, points, extr, intr,
                                     valid, jdir, extra_params=extra)
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for pa, pb in zip(a, b):
        if pa.endswith(".png"):
            np.testing.assert_array_equal(_pixels(pa), _pixels(pb))


def test_mp4_frames_match_jax_after_decoding(tmp_path):
    """`write_video` through OpenCV: the port's mp4 decodes to the JAX
    visualizer's frames (skipped only where OpenCV is not installed)."""
    cv2 = pytest.importorskip("cv2")
    _, images, _, _ = _scene_arrays(S=4, H=48, W=64)
    frames = [(im * 255).astype(np.uint8) for im in images]
    a = tvis.write_video(frames, str(tmp_path / "port.mp4"))
    b = jvis.write_video(frames, str(tmp_path / "jax.mp4"))
    assert a is not None and b is not None
    assert os.path.splitext(a)[1] == os.path.splitext(b)[1]

    def decode(path):
        cap = cv2.VideoCapture(path)
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f)
        cap.release()
        return out

    da, db = decode(a), decode(b)
    assert len(da) == len(db) == 4
    for x, y in zip(da, db):
        np.testing.assert_array_equal(x, y)
    assert tvis.write_video([], str(tmp_path / "none.mp4")) is None


@pytest.mark.parametrize("with_colors", [False, True])
def test_ply_files_are_byte_identical(tmp_path, with_colors):
    """`export_scene_ply` (points with and without colors, the camera
    frusta as a wireframe) writes the JAX package's bytes."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, size=(50, 3)).astype(np.uint8) \
        if with_colors else None
    extr = np.zeros((3, 3, 4), np.float32)
    extr[:, :, :3] = np.eye(3)
    extr[:, :, 3] = rng.normal(size=(3, 3))
    intr = np.broadcast_to(np.array([[50, 0, 32], [0, 50, 24], [0, 0, 1]],
                                    np.float32), (3, 3, 3))
    tply.export_scene_ply(str(tmp_path / "t"), pts, extr, intr, (64, 48),
                          colors)
    jply.export_scene_ply(str(tmp_path / "j"), pts, extr, intr, (64, 48),
                          colors)
    for suffix in ("_points.ply", "_cameras.ply"):
        with open(str(tmp_path / "t") + suffix, "rb") as a, \
                open(str(tmp_path / "j") + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.fixture
def tiny_models(monkeypatch):
    """The runner's camera predictor and depth model at a tiny size."""
    monkeypatch.setattr(trun, "CameraPredictor", functools.partial(
        CameraPredictor, hidden_size=64, num_heads=4, down_size=28,
        att_depth=2, trunk_depth=2))
    monkeypatch.setattr(trun, "init_camera_", _fast_seeded_init)
    monkeypatch.setattr(trun, "DepthAnything", functools.partial(
        DepthAnything, tap_layers=(0, 1, 2, 3), features=16,
        out_channels=(8, 16, 24, 32), embed_dim=32, depth=4, num_heads=4))
    monkeypatch.setattr(trun.VGGSfMRunner, "select_query_frames",
                        lambda self, images: [2])


def test_demo_cli_writes_depths_visuals_and_trace(tmp_path, tiny_models,
                                                  capsys):
    """The CLI as a user runs it with --dense-depth, --visual-tracks,
    --reproj-frames, --visual-query-points and --profile-dir on a rendered
    scene (4 frames at 128 px, written as PNGs of 160 x 120 so the model's
    square crop is rescaled), depth_input_size 28 from a --config YAML:
    OUT/depths holds one map per image at its original resolution, finite
    and > 0; OUT/visuals the query-point, track and reprojection files;
    the trace is a Chrome trace whose events name the stages and spans
    (`vggsfm.<name>`); the summary
    has the dense_depth and visuals stages."""
    scene_dir = str(tmp_path / "scene")
    scene = tsynth.render_two_plane_scene(4, 128, seed=3)
    names = tsynth.write_scene_folder(scene, scene_dir)
    for n in names:  # the loader crops and rescales to 128 again
        p = os.path.join(scene_dir, "images", n)
        Image.open(p).resize((160, 120)).save(p)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write("precision: f32\nmin_vis_points: 1\ndepth_input_size: 28\n")
    out_dir, prof_dir = str(tmp_path / "out"), str(tmp_path / "prof")
    pred = tdemo.main([
        scene_dir, "--output", out_dir, "--device", "cpu", "--config",
        cfg_path, "--img-size", "128", "--query-frame-num", "1",
        "--max-query-pts", "64", "--query-method", "sift+harris",
        "--dense-depth", "--visual-tracks", "--reproj-frames",
        "--visual-query-points", "--profile-dir", prof_dir])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"dense_depth", "export", "export.depths",
            "visuals"} <= set(summary["timings"])
    assert pred["depth_maps"].shape == (4, 128, 128)
    assert pred["depth_align_coeffs"].shape == (4, 2)
    assert pred["depth_inlier_frac"].shape == (4,)

    for n in names:
        d = tdepth.read_colmap_array(os.path.join(
            out_dir, "depths", os.path.splitext(n)[0] + ".bin"))
        assert d.shape == (120, 160)
        assert np.isfinite(d).all() and d.min() > 0
    vis = set(os.listdir(os.path.join(out_dir, "visuals")))
    assert "query_points_00_f0002.png" in vis
    assert {f"tracks_{s:04d}.png" for s in range(4)} <= vis
    assert {f"reproj_{s:04d}.png" for s in range(4)} <= vis
    assert "tracks.gif" in vis
    with Image.open(os.path.join(out_dir, "visuals",
                                 "tracks_0000.png")) as im:
        assert im.size == (128, 128)

    traces = os.listdir(prof_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    named = {e.get("name") for e in events}
    # (the query ranking is fixed above, so it opens no stage); the
    # tracer's ranges, the stages and the spans below them
    assert {"vggsfm." + n for n in (
        "sparse_reconstruct", "camera_init", "fmaps", "tracking",
        "preliminary", "sfm", "dense_depth", "export", "visuals",
        "preliminary.sample", "ba.dense", "ba.iter")} <= named
    assert not torch._C._autograd._profiler_enabled()


def test_a_raising_profiled_call_leaves_no_profiler_running(tmp_path,
                                                           tiny_models,
                                                           monkeypatch):
    """--profile-dir with a stage that raises: the error reaches the
    caller, no profiler is left running, and the next profiler starts."""
    scene_dir = str(tmp_path / "scene")
    tsynth.write_scene_folder(tsynth.render_two_plane_scene(3, 64, seed=1),
                              scene_dir)

    def fail(self, *a, **k):
        raise RuntimeError("camera failed")

    monkeypatch.setattr(trun.VGGSfMRunner, "camera_init", fail)
    with pytest.raises(RuntimeError, match="camera failed"):
        tdemo.main([scene_dir, "--output", str(tmp_path / "out"),
                    "--device", "cpu", "--img-size", "64",
                    "--profile-dir", str(tmp_path / "prof")])
    assert not torch._C._autograd._profiler_enabled()
    with torch.profiler.profile() as prof:
        torch.ones(2).sum()
    assert prof.key_averages() is not None
