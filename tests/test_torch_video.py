"""The port's video pipeline (vggsfm_tpu_torch/video, video_demo.py)
against the JAX package's, on the CPU.

The oracle scene of tests/torch_video_cases.py (tests/video_cases.py's
projection-oracle tracker and oracle initial map, its noise fixed per
(frame, point)) drives the runner. The JAX package's random draws come
from `jax.random`, which torch cannot reproduce: the port is handed the
draws the JAX calls made (the fresh query points of each window attempt,
the PnP minimal sets) through `VideoRunner._fresh_queries` and
`_pnp_samples`. The window triangulation's pair schedule is numpy, seeded
alike in both.

Tolerances, each stated where it is used: exact for the host bookkeeping
(registry, checkpoint, map selection, oracle tracks); 1e-3 for one PnP
attempt (f32 undistortion, DLT and Jacobi eigh summed in other orders);
5e-3 for the
poses of a whole run, whose solves (PnP, pose refinement, window and joint
BA) each add their f32 rounding.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_video_cases as cases
from vggsfm_tpu_torch import runner as trunner
from vggsfm_tpu_torch import video as tvideo
from vggsfm_tpu_torch.geometry.metrics import pose_auc30
from vggsfm_tpu_torch.video.runner import MapRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_parallel_codegen_split_count=1")
    env["JAX_PLATFORMS"] = "cpu"
    return env


_SPARSE = {}


def _port_runner(sc, **vkw):
    """A VideoRunner on the oracle. The oracle replaces every use of the
    sparse runner's models, so one seeded runner serves every test."""
    scfg, vcfg = cases.configs((trunner, tvideo))
    for k, v in vkw.items():
        setattr(vcfg, k, v)
    if "r" not in _SPARSE:
        _SPARSE["r"] = trunner.VGGSfMRunner(scfg, device="cpu")
    runner = tvideo.VideoRunner(_SPARSE["r"], vcfg)
    cases.install_oracle(runner, sc)
    return runner


def _inject(runner, draws):
    """Hand the port the JAX run's draws, keyed as the JAX keys were."""
    seed = runner.cfg.seed

    def fresh(image, start, pts_mult, budget):
        n = seed + 17 * start + pts_mult
        return draws[f"q_{n}"], draws[f"qv_{n}"]

    def pnp(start, budget):
        return torch.from_numpy(np.array(draws[f"p_{seed + start}_{budget}"])
                                ).long()

    runner._fresh_queries = fresh
    runner._pnp_samples = pnp


def _auc(extr, gt):
    return float(pose_auc30(torch.as_tensor(extr),
                            torch.as_tensor(gt, dtype=torch.float32)))


# ---------------------------------------------------------------- registry


def test_registry_and_checkpoint_roundtrip_in_the_jax_format(tmp_path):
    """MapRegistry and the checkpoint round-trip exactly, with the JAX
    package's keys: its `load_checkpoint` reads the port's files."""
    from vggsfm_tpu.video.runner import VideoRunner as JVideoRunner

    rng = np.random.default_rng(0)
    reg = MapRegistry()
    ids = reg.add_points(rng.normal(size=(20, 3)))
    assert ids.tolist() == list(range(20))
    reg.add_observations(np.arange(5), np.arange(5), rng.normal(size=(5, 2)))
    reg.save(str(tmp_path / "map.npz"))
    reg2 = MapRegistry.load(str(tmp_path / "map.npz"))
    for key in ("xyz", "obs_frame", "obs_point", "obs_xy"):
        np.testing.assert_array_equal(getattr(reg2, key), getattr(reg, key))

    T = 6
    extr = rng.normal(size=(T, 3, 4)).astype(np.float32)
    intr = rng.normal(size=(T, 3, 3)).astype(np.float32)
    extra = rng.normal(size=(T, 1)).astype(np.float32)
    registered = np.arange(T) < 4
    path = str(tmp_path / "ckpt")
    tvideo.VideoRunner.save_checkpoint(None, path, reg, extr, intr,
                                       registered, 4, 2, extra=extra)
    for load in (tvideo.VideoRunner.load_checkpoint,
                 JVideoRunner.load_checkpoint):
        r, e, i, regd, end, done, x = load(path)
        np.testing.assert_array_equal(r.xyz, reg.xyz)
        np.testing.assert_array_equal(e, extr)
        np.testing.assert_array_equal(i, intr)
        np.testing.assert_array_equal(regd, registered)
        np.testing.assert_array_equal(x, extra)
        assert (end, done) == (4, 2)


def test_resume_from_a_mid_run_checkpoint_reaches_the_same_state(tmp_path):
    """A run that saves a checkpoint after every joint BA, and a second
    run resumed from the first of them, end in the same state, exactly
    (the CPU is deterministic and every draw is seeded by the window)."""
    sc = cases.make_scene()
    runner = _port_runner(sc)
    saved = []
    save = runner.save_checkpoint

    def keep_first(path, *a, **kw):
        save(path, *a, **kw)
        if not saved:
            save(str(tmp_path / "first"), *a, **kw)
        saved.append(a[4])  # the window cursor

    runner.save_checkpoint = keep_first
    full = runner.run(sc["video"], checkpoint_path=str(tmp_path / "ckpt"))
    assert saved == [10, 12]
    resumed = _port_runner(sc).run(sc["video"],
                                   resume_from=str(tmp_path / "first"))
    assert resumed["registered"].all()
    for key in ("extrinsics", "intrinsics", "points3d"):
        np.testing.assert_array_equal(resumed[key], full[key])


# ------------------------------------------------------------------ window


def test_attempt_window_matches_jax():
    """One `_attempt_window` of each package on the same map, with a radial
    term (PnP on undistorted pixels), the oracle tracker and the JAX draws:
    the map selection and tracks exactly, the ok flags equal, the PnP poses
    within 1e-3 (25 f32 Newton steps of the undistortion, then the DLT's
    Jacobi eigh, each summed in other orders: ~4e-4 measured)."""
    from vggsfm_tpu import runner as jrunner
    from vggsfm_tpu import video as jvideo
    from vggsfm_tpu.twoview.utils import generate_samples
    from vggsfm_tpu.video import runner as jvr

    sc = cases.make_scene()
    T = sc["video"].shape[0]
    extr = np.zeros((T, 3, 4), np.float32)
    extr[:4] = sc["extr_gt"][:4]
    intr = np.tile(sc["K"], (T, 1, 1)).astype(np.float32)
    extra = np.full((T, 1), -0.02, np.float32)

    outs, draws = [], {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            scfg, vcfg = cases.configs((jrunner, jvideo))
            runner = jvideo.VideoRunner(jrunner.VGGSfMRunner(scfg), vcfg)
            reg = jvr.MapRegistry()
        else:
            runner = _port_runner(sc)
            reg = MapRegistry()
        cases.install_oracle(runner, sc)
        reg.add_points(sc["X"].astype(np.float32))
        if pkg == "jax":
            gqp = jvr.get_query_points
            pnp = jvr.absolute_pose_ransac

            def rec_gqp(image, key, method, budget):
                xy, valid = gqp(image, key, method, budget)
                draws["xy"], draws["valid"] = np.asarray(xy), np.asarray(
                    valid)
                return xy, valid

            def rec_pnp(points3D, points2D, intrinsics, key, **kw):
                draws["pnp"] = np.asarray(generate_samples(
                    key, points3D.shape[1], kw["max_ransac_iters"], 6)[0])
                return pnp(points3D, points2D, intrinsics, key, **kw)

            jvr.get_query_points, jvr.absolute_pose_ransac = rec_gqp, rec_pnp
            try:
                outs.append(runner._attempt_window(
                    sc["video"], reg, extr, intr, 3, 4, 7, 1, pad_frames=4,
                    extra=extra))
            finally:
                jvr.get_query_points, jvr.absolute_pose_ransac = gqp, pnp
        else:
            runner._fresh_queries = (
                lambda image, start, mult, budget: (draws["xy"],
                                                    draws["valid"]))
            runner._pnp_samples = (
                lambda start, budget: torch.from_numpy(
                    draws["pnp"].copy()).long())
            outs.append(runner._attempt_window(
                sc["video"], reg, extr, intr, 3, 4, 7, 1, pad_frames=4,
                extra=extra))
    j, t = outs
    assert t["n_map"] == j["n_map"] == 256 and t["frames_w"] == j["frames_w"]
    for key in ("map_ids", "tracks", "vis", "map_tracks", "map_vis"):
        np.testing.assert_array_equal(t[key], np.asarray(j[key]))
    np.testing.assert_array_equal(t["ok"], j["ok"])
    assert t["ok"].all()
    np.testing.assert_allclose(t["extr_new"], np.asarray(j["extr_new"]),
                               atol=1e-3)
    assert np.asarray(j["extr_new"]).shape == (3, 3, 4)


def test_camera_align_window_uses_fresh_anchors():
    """tests/test_video.py's regression on the port: the camera
    predictor's (similarity-moved) window poses, aligned on the anchor
    frames' poses, put the other frames on their true poses (1e-3)."""
    from vggsfm_tpu_torch.geometry.cameras import (
        extri_intri_to_pose_encoding,
    )

    Sw, R_img = 5, 64
    f = float(R_img)
    K = np.tile(np.array([[f, 0, R_img / 2], [0, f, R_img / 2],
                          [0, 0, 1.0]], np.float32), (Sw, 1, 1))
    true = np.zeros((Sw, 3, 4), np.float32)
    for s in range(Sw):
        a = 0.05 * s
        true[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        true[s, :, 3] = [0.3 * s, 0.02 * s, 0.1 * s + 1.0]
    b, scale = 0.4, 1.7
    Rg = np.array([[np.cos(b), -np.sin(b), 0], [np.sin(b), np.cos(b), 0],
                   [0, 0, 1]], np.float32)
    pred = true.copy()
    pred[:, :, :3] = true[:, :, :3] @ Rg.T
    pred[:, :, 3] = true[:, :, 3] * scale
    runner = tvideo.VideoRunner.__new__(tvideo.VideoRunner)
    runner.device = torch.device("cpu")
    enc = extri_intri_to_pose_encoding(torch.as_tensor(pred),
                                       torch.as_tensor(K), (R_img, R_img))
    runner.r = type("R", (), {"camera_forward": staticmethod(
        lambda im: {"pred_pose_enc": enc[None]})})()
    anchors = np.array([True, True, False, True, False])
    aligned = runner._camera_align_window(
        np.zeros((Sw, R_img, R_img, 3), np.float32), true, anchors,
        (R_img, R_img))
    np.testing.assert_allclose(aligned[2], true[2], atol=1e-3)
    np.testing.assert_allclose(aligned[4], true[4], atol=1e-3)
    assert runner._camera_align_window(None, true, np.zeros(Sw, bool),
                                       (R_img, R_img)) is None


def test_step_back_retry_registers_every_frame():
    """Tracking from frame 6 yields nothing: the retry schedule (2x the
    query points, a shrunk window, the query stepped back) still
    registers every frame, AUC@30 > 0.85 (tests/video_cases.py's
    step-back case on the port)."""
    sc = cases.make_scene(T=14, seed=3)
    runner = _port_runner(sc, align_with_camera_predictor=False)
    track = runner._track_window

    def bad_query(images_w, query_xy, frames_w=None):
        if frames_w[0] == 6:
            n = len(query_xy)
            return (np.zeros((len(frames_w), n, 2), np.float32),
                    np.zeros((len(frames_w), n), np.float32))
        return track(images_w, query_xy, frames_w=frames_w)

    runner._track_window = bad_query
    preds = runner.run(sc["video"])
    assert preds["registered"].all()
    attempts = [w["attempts"] for w in runner.windows]
    assert max(attempts) > 1 and any(w["query"] < w["frames"][0] - 1
                                     for w in runner.windows)
    assert _auc(preds["extrinsics"], sc["extr_gt"]) > 0.85


def test_distributed_ba_plain_below_its_device_count_raises_at_it():
    """--distributed-ba N: with fewer than N devices the plain sparse
    solver runs (the JAX rule); with N devices the port raises, naming
    the roadmap item, where the JAX package would shard."""
    sc = cases.make_scene(T=5)
    runner = _port_runner(sc, distributed_ba_devices=2, init_window_size=5)
    reg, extr, intr, extra, registered, _ = runner._initial_map(sc["video"])
    runner._joint_ba(extr, intr, reg, registered)
    assert "video.joint_ba" in runner.timings
    runner._device_count = lambda: 2
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        runner._joint_ba(extr, intr, reg, registered)


# ------------------------------------------------------------ whole slice


def test_video_run_matches_jax(tmp_path):
    """`VideoRunner.run` of both packages on the oracle scene (12 frames
    at 128 px, 4-frame initial window, 3-frame windows, joint BA every 2
    windows and at the end), the JAX run in a fresh subprocess, the port
    handed its draws: the same registered frames, points and
    observations; poses within 5e-3 in the normalized gauge (extent 5);
    AUC@30 > 0.85 for both. The camera-predictor fill is off: every window
    registers by PnP here, and the two packages' seeded camera weights
    differ (jax.random against torch)."""
    out = str(tmp_path / "jax.npz")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_video_cases.py"),
         "jax_oracle", out], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    j = np.load(out)
    sc = cases.make_scene()
    runner = _port_runner(sc)
    _inject(runner, j)
    t = runner.run(sc["video"], output_dir=str(tmp_path))
    np.testing.assert_array_equal(t["registered"], j["registered"])
    assert t["registered"].all()
    assert [w["attempts"] for w in runner.windows] == [1, 1, 1]
    assert t["num_points"] == len(j["points3d"])
    assert t["num_observations"] == int(j["num_observations"])
    np.testing.assert_allclose(t["extrinsics"], j["extrinsics"], atol=5e-3)
    np.testing.assert_allclose(t["intrinsics"], j["intrinsics"], rtol=1e-3)
    assert _auc(t["extrinsics"], sc["extr_gt"]) > 0.85
    assert _auc(j["extrinsics"], sc["extr_gt"]) > 0.85

    from vggsfm_tpu_torch.io import read_model

    rec = read_model(str(tmp_path / "sparse"))
    assert len(rec.images) == 12 and len(rec.points3D) > 0
    assert rec.images[1].name == "frame_00000.png"


def test_two_process_multihost_on_the_cpu(tmp_path):
    """`run_multihost` in two processes with a shared exchange folder: both
    hosts compute the same initial map (their partials' shared prefixes
    equal, exactly), host 0 merges, joint-BAs and exports; every frame
    registers, AUC@30 > 0.85."""
    ex = str(tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_video_cases.py"),
         "port_multihost_worker", ex, str(h), "2"], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in (1, 0)]
    for h, p in zip((1, 0), procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        assert f"HOST{h}_OK" in out
    p0 = np.load(os.path.join(ex, "partial_000.npz"))
    p1 = np.load(os.path.join(ex, "partial_001.npz"))
    P0 = int(p0["shared_points"])
    assert P0 == int(p1["shared_points"]) > 0
    np.testing.assert_array_equal(p0["xyz"][:P0], p1["xyz"][:P0])
    assert tuple(p0["block"]) == (4, 10) and tuple(p1["block"]) == (10, 16)
    merged = np.load(os.path.join(ex, "merged.npz"))
    assert merged["registered"].all()
    sc = cases.make_scene(T=16, seed=21, step=0.6)
    assert _auc(merged["extrinsics"], sc["extr_gt"]) > 0.85
    assert os.path.exists(os.path.join(ex, "sparse", "points3D.bin"))


_process_range = tvideo.VideoRunner._process_range


def _spy_process_range(self, seen, *a, **kw):
    seen.append((self.cfg.window_size, self.cfg.min_inlier_per_frame,
                 self.cfg.max_step_back))
    return _process_range(self, *a, **kw)


def test_video_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`python -m vggsfm_tpu_torch.video_demo FRAMES --device cpu` on a
    rendered 6-frame 128 px folder with the seeded tracker (SIMPLE_RADIAL,
    midpoint ranking, fine tracking: the CLI's defaults), windows cut to
    4 + 2, a tiny camera predictor injected (its full-size DINOv2
    backbone costs tens of seconds on one CPU thread) and the initial
    window's re-query rounds off (64 query points never reach the 500
    visible ones they ask for, so each round adds full-width tracker
    calls on the CPU; tests/test_torch_extractors.py covers the rounds):
    every frame registered, the summary line, the model read back with
    the port's reader under the folder's image names."""
    import functools

    from tests.test_torch_runner_export import _fast_seeded_init
    from vggsfm_tpu_torch import video_demo
    from vggsfm_tpu_torch.models.camera import CameraPredictor

    monkeypatch.setattr(trunner, "CameraPredictor", functools.partial(
        CameraPredictor, hidden_size=64, num_heads=4, down_size=28,
        att_depth=2, trunk_depth=2))
    monkeypatch.setattr(trunner, "init_camera_", _fast_seeded_init)
    monkeypatch.setattr(trunner, "RunnerConfig", functools.partial(
        trunner.RunnerConfig, comple_nonvis=False))
    from vggsfm_tpu_torch.io import read_model
    from vggsfm_tpu_torch.utils.synth import (
        render_two_plane_scene,
        write_scene_folder,
    )

    scene_dir = str(tmp_path / "frames")
    names = write_scene_folder(render_two_plane_scene(6, 128, baseline=0.1),
                               scene_dir)
    # a YAML below the typed flags: its window size loses to --window, its
    # PnP inlier floor (8 of the 64 map slots) and retry depth (no step
    # back: 3 attempts of a window) stand. A YAML run takes VideoConfig's
    # defaults for the flags not typed, as the JAX CLI does: SIMPLE_PINHOLE
    # unless the file names the camera
    cfg_path = str(tmp_path / "video.yaml")
    with open(cfg_path, "w") as f:
        f.write("window_size: 5\nmin_inlier_per_frame: 8\n"
                "max_step_back: 0\ncamera_type: SIMPLE_RADIAL\n")
    seen = []
    monkeypatch.setattr(tvideo.VideoRunner, "_process_range",
                        functools.partialmethod(_spy_process_range, seen))
    out = str(tmp_path / "out")
    video_demo.main([scene_dir, "--output", out, "--device", "cpu",
                     "--img-size", "128", "--init-window", "4", "--window",
                     "2", "--max-query-pts", "64", "--query-method",
                     "harris", "--config", cfg_path])
    assert seen == [(2, 8, 0)]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 6 and summary["registered"] == 6
    assert summary["output"] == out
    rec = read_model(os.path.join(out, "sparse"))
    assert sorted(im.name for im in rec.images.values()) == names
    assert rec.cameras[1].model == "SIMPLE_RADIAL"
    assert len(rec.points3D) == summary["points"]
