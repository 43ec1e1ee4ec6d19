"""The runner's last stage against the JAX runner's, on the CPU: the track
colors (step 7), `triangulate_extra_points`, and the whole slice through
the port's CLI (`python -m vggsfm_tpu_torch.demo`) with the files it
writes held byte for byte to the JAX package's writers on the same
predictions.

Tolerances: colors 1e-6 (bilinear weights in f32, summed in another
order); extra points 1e-4 relative (the same LORANSAC on the same tracks,
f32 sums in another order).
"""

import functools
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu import runner as jrun
from vggsfm_tpu.io import glb as jglb
from vggsfm_tpu.models.sampling import sample_features4d as jsample
from vggsfm_tpu_torch import demo as tdemo
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch.datasets import DemoLoader
from vggsfm_tpu_torch.io import read_model
from vggsfm_tpu_torch.models.camera import CameraPredictor
from vggsfm_tpu_torch.utils import synth as tsynth


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small ops: intra-op threads gain them nothing under several test
    workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_track_colors_match_jax():
    """Step 7's colors: `sample_features4d` of the frames at the tracks,
    averaged over the observations in the mask (0 where there are none),
    against the JAX package's sampler and weighting on the same inputs:
    within 1e-6."""
    rng = np.random.default_rng(0)
    S, H, W, P = 3, 24, 20, 50
    images = rng.uniform(size=(S, H, W, 3)).astype(np.float32)
    tracks = rng.uniform(-3, 26, size=(S, P, 2)).astype(np.float32)
    mask = rng.uniform(size=(S, P)) < 0.6
    mask[:, 0] = False
    rgb = jsample(jnp.asarray(images), jnp.asarray(tracks))
    w = jnp.asarray(mask).astype(jnp.float32)[..., None]
    want = np.asarray(jnp.sum(rgb * w, axis=0)
                      / jnp.maximum(jnp.sum(w, axis=0), 1))
    got = trun.track_colors(torch.from_numpy(images),
                            torch.from_numpy(tracks), torch.from_numpy(mask))
    assert got.shape == (P, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got[0].abs().max()) == 0.0


def _orbit_cameras(S, R):
    """S cameras 10 degrees apart on a circle of radius 4 around the
    origin, all looking at it: focal R, principal point at the center.
    Wide enough that every pair triangulates a point to f32 rounding (on
    the two-plane scene's narrow baseline the LORANSAC candidates of a
    track differ by more than that, and f32 ties pick among them)."""
    extr = np.zeros((S, 3, 4), np.float32)
    for s in range(S):
        a = np.deg2rad(10.0 * (s - (S - 1) / 2))
        extr[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        extr[s, 2, 3] = 4.0
    intr = np.broadcast_to(np.array([[R, 0, R / 2], [0, R, R / 2],
                                     [0, 0, 1]], np.float32), (S, 3, 3))
    return {"extrinsics": extr, "intrinsics": intr.copy()}


def _fake_coarse(scene, fmaps, qp):
    """A deterministic stand-in for the coarse tracker: the frames of the
    window are read from `fmaps` (frame ids in [0, :, 0, 0, 0]); each
    query pixel of the window's first frame is lifted to a depth that
    varies over the image and projected into every frame of the window
    through the given cameras. Every 5th track is moved 15 px in one of
    the other frames (an outlier), and every 7th has visibility 0.01 in
    all of them."""
    frames = np.asarray(fmaps)[0, :, 0, 0, 0].astype(int)
    extr, intr = scene["extrinsics"], scene["intrinsics"]
    xy = np.asarray(qp, np.float64)[0]
    n = np.arange(len(xy))
    q = frames[0]
    depth = 3.0 + 0.5 * np.sin(xy[:, 0] / 17.0) + 0.3 * np.cos(xy[:, 1] / 13)
    ray = (xy - intr[q, :2, 2]) / intr[q, [0, 1], [0, 1]]
    Xc = np.concatenate([ray * depth[:, None], depth[:, None]], axis=1)
    Xw = (Xc - extr[q, :, 3]) @ extr[q, :, :3]
    tracks, vis = [], []
    for i, s in enumerate(frames):
        uvw = (Xw @ extr[s, :, :3].T + extr[s, :, 3]) @ intr[s].T
        uv = uvw[:, :2] / uvw[:, 2:]
        v = np.full(len(xy), 0.9)
        if i:
            uv[(n % 5 == 1) & (n % (len(frames) - 1) == i - 1)] += 15.0
            v[n % 7 == 3] = 0.01
        tracks.append(uv)
        vis.append(v)
    return (np.stack(tracks)[None].astype(np.float32),
            np.stack(vis)[None].astype(np.float32))


@pytest.mark.parametrize("by_neighbor,radial", [(-1, False), (2, True)])
def test_triangulate_extra_points_matches_jax(by_neighbor, radial):
    """`triangulate_extra_points` of both runners with `_coarse_track`
    replaced by the same deterministic function: 4 frames at 128 px, 289
    grid points tracked in two chunks (max_points_num 512), all frames or
    a window of 2, without and with distortion parameters. Points within
    1e-4 relative; `valid` and `query_frame` equal; colors within 1e-6;
    as many coarse calls as frames x chunks, each over the window."""
    S, R, num = 4, 128, 300
    scene = {**tsynth.render_two_plane_scene(S, R, seed=2),
             **_orbit_cameras(S, R)}
    fmaps = np.arange(S, dtype=np.float32).reshape(1, S, 1, 1, 1)
    extra = (np.full((S, 1), -0.02, np.float32) if radial else None)
    calls = {"jax": [], "port": []}

    def jfake(fm, qp):
        calls["jax"].append(np.asarray(fm)[0, :, 0, 0, 0].tolist())
        return tuple(jnp.asarray(x) for x in _fake_coarse(scene, fm, qp))

    def tfake(fm, qp, stage=None):
        assert stage == "extra_points.coarse"
        calls["port"].append(fm[0, :, 0, 0, 0].tolist())
        return tuple(torch.from_numpy(x)
                     for x in _fake_coarse(scene, fm.numpy(), qp.numpy()))

    extr, intr = scene["extrinsics"], scene["intrinsics"]
    jself = types.SimpleNamespace(cfg=jrun.RunnerConfig(max_points_num=512),
                                  _coarse_track=jfake)
    want = jrun.VGGSfMRunner.triangulate_extra_points(
        jself, jnp.asarray(scene["images"][None]), jnp.asarray(fmaps), extr,
        intr, num_extra=num, by_neighbor=by_neighbor, extra_params=extra)
    runner = object.__new__(trun.VGGSfMRunner)  # no tracker needed
    runner.cfg = trun.RunnerConfig(max_points_num=512)
    runner.device = torch.device("cpu")
    runner._coarse_track = tfake
    got = runner.triangulate_extra_points(
        torch.from_numpy(scene["images"][None]), torch.from_numpy(fmaps),
        torch.from_numpy(extr), torch.from_numpy(intr), num_extra=num,
        by_neighbor=by_neighbor,
        extra_params=None if extra is None else torch.from_numpy(extra))

    L = S if by_neighbor <= 0 else 2
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2 * S
    assert all(len(c) == L for c in calls["port"])
    N = 17 * 17
    assert set(got) == set(want)
    assert got["points3d"].shape == (S * N, 3)
    np.testing.assert_array_equal(got["query_frame"].numpy(),
                                  want["query_frame"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    v = want["valid"]
    assert 0.3 < v.mean() < 1.0
    ref = want["points3d"][v]
    np.testing.assert_allclose(got["points3d"].numpy()[v], ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got["colors"].numpy(), want["colors"],
                               rtol=0, atol=1e-6)


def _fast_seeded_init(module, generator):
    """Seeded weights for the tiny camera at a fraction of the cost of
    `init_camera_` (its DINOv2 backbone is full-size)."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


def _solve_order(pred):
    """The per-frame outputs of a swapped-back run put back into the
    solve's frame order (the swap is its own inverse), as numpy."""
    host = trun.to_host({k: pred.get(k) for k in trun.EXPORT_KEYS})
    perm = pred["center_perm"]
    for k in ("extrinsics", "intrinsics", "valid_frame_mask",
              "valid_2d_mask"):
        host[k] = host[k][perm]
    host["pred_track"] = host["pred_track"][:, perm]
    return host


def test_demo_cli_writes_the_jax_packages_model(tmp_path, monkeypatch,
                                                capsys):
    """The slice through the CLI, on the CPU: a rendered scene folder (4
    frames at 128 px, the GT model under sparse/0), a tiny camera
    predictor injected and the query ranking fixed to put frame 2 first,
    f32 and one visible point per frame enough (--config), with --load-gt,
    --center-order, --glb and 16 extra points per frame appended to the
    model. The files it writes equal byte for byte what the JAX package's
    `save_reconstruction` and `reconstruction_to_glb` write from the same
    predictions (the npz: the same arrays; its zip entries carry the write
    time); image id 1 is the top-ranked frame under its own name; the
    summary line has the JAX CLI's keys."""
    scene_dir = str(tmp_path / "scene")
    scene = tsynth.render_two_plane_scene(4, 128, seed=3)
    names = tsynth.write_scene_folder(scene, scene_dir)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write("precision: f32\nmin_vis_points: 1\nmax_query_pts: 999\n")
    monkeypatch.setattr(trun, "CameraPredictor", functools.partial(
        CameraPredictor, hidden_size=64, num_heads=4, down_size=28,
        att_depth=2, trunk_depth=2))
    monkeypatch.setattr(trun, "init_camera_", _fast_seeded_init)
    monkeypatch.setattr(trun.VGGSfMRunner, "select_query_frames",
                        lambda self, images: [2])
    out_dir = str(tmp_path / "out")
    pred = tdemo.main([
        f"SCENE_DIR={scene_dir}", "--output", out_dir, "--device", "cpu",
        "--config", cfg_path, "--img-size", "128", "--query-frame-num", "1",
        "--max-query-pts", "64", "--query-method", "sift+harris",
        "--load-gt", "--center-order", "--glb",
        "--extra-pt-pixel-interval", "32", "--concat-extra-points"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"frames", "valid_tracks", "valid_frames",
                            "total_time_s", "timings", "output", "gt_auc30"}
    assert summary["frames"] == 4 and summary["output"] == out_dir
    assert summary["valid_tracks"] == int(pred["valid_tracks"].sum()) > 0
    assert pred["gt_frames_matched"] == 4
    assert {"extra_points", "export", "export.build",
            "export.write"} <= set(summary["timings"])
    assert list(pred["center_perm"]) == [2, 1, 0, 3]
    assert pred["colors"].shape == (pred["points3d"].shape[0], 3)
    extra = pred["additional_points"]
    assert extra["points3d"].shape == (4 * 16, 3)

    # the JAX package's writers on the same predictions, in the solve's
    # frame order, with the loader's names and crop parameters permuted
    host = _solve_order(pred)
    data = DemoLoader(scene_dir, img_size=128).load()
    perm = pred["center_perm"]
    jcfg = jrun.RunnerConfig(img_size=128, concat_extra_points=True)
    jdir = str(tmp_path / "jax")
    jrun.VGGSfMRunner.save_reconstruction(
        types.SimpleNamespace(cfg=jcfg), host, (128, 128),
        [data["image_names"][i] for i in perm], jdir,
        crop_params=data["crop_params"][perm])
    jglb.reconstruction_to_glb(host, os.path.join(jdir, "scene.glb"),
                               image_size=(128, 128))
    for f in ("sparse/cameras.bin", "sparse/images.bin",
              "sparse/points3D.bin", "scene.glb"):
        with open(os.path.join(out_dir, f), "rb") as a, \
                open(os.path.join(jdir, f), "rb") as b:
            assert a.read() == b.read(), f
    with np.load(os.path.join(out_dir, "additional_points.npz")) as a, \
            np.load(os.path.join(jdir, "additional_points.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
        assert int(a["additional_points_num"]) == int(extra["valid"].sum())

    rec = read_model(os.path.join(out_dir, "sparse"))
    assert rec.images[1].name == names[2] == "frame_0002.png"
    assert [rec.images[i].name for i in sorted(rec.images)] == \
        [names[i] for i in perm if pred["valid_frame_mask"][i]]
    trackless = [p for p in rec.points3D.values() if len(p.image_ids) == 0]
    assert len(trackless) == int(extra["valid"].sum())
