"""The port's IMC evaluation against the JAX package's, on the CPU:
datasets/camera_transform.py, datasets/imc.py (the bag discovery, the
loader, the h5/npz files, `evaluate_bag`), datasets/imc_submission.py and
the CLI `python -m vggsfm_tpu_torch.imc_eval` in a child process on a
synthetic IMC tree (no IMC data is in the repository). Mirrors
tests/test_camera_transform.py, test_imc.py and test_imc_submission.py.

Tolerances: camera_transform 1e-6 with both packages in f64 (the JAX one
under `jax.enable_x64`); the loader's images equal, its GT extrinsics and
intrinsics within 1e-6 relative (the JAX package computes them in f32, the
port in f64, both rounded to f32); `evaluate_bag` the same AUC@30 within
1e-6 and errors within 1e-3 degrees (f32 arccos of the same relative
poses); the submission files equal in content.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_camera_transform import look_at_extrinsics
from tests.test_imc_submission import NAMES, _fake_predictions
from vggsfm_tpu.datasets import camera_transform as jct
from vggsfm_tpu.datasets import imc as jimc
from vggsfm_tpu.datasets import imc_submission as jsub
from vggsfm_tpu.datasets.demo_loader import crop_parameters
from vggsfm_tpu_torch.datasets import camera_transform as tct
from vggsfm_tpu_torch.datasets import imc as timc
from vggsfm_tpu_torch.datasets import imc_submission as tsub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAG = "5bag_000_grand_place_brussels"


def make_imc_tree(root, n_images=4, london_bridge=True):
    """The synthetic IMC tree of tests/test_imc.py (4 random 80 x 60 JPEGs
    of grand_place_brussels, cameras turning 0.1 rad a frame, one bag
    list), each calibration as .npz and .h5, and a london_bridge location
    with one portrait image for `exclude_london_bridge`."""
    import h5py
    from PIL import Image

    rng = np.random.default_rng(0)
    locations = [("grand_place_brussels", n_images, (60, 80))]
    if london_bridge:
        locations.append(("london_bridge", 2, (90, 50)))
    for loc, n, hw in locations:
        base = root / loc / "set_100"
        for d in ("sub_set", "images", "calibration"):
            (base / d).mkdir(parents=True)
        names = []
        for i in range(n):
            name = f"img_{i:03d}"
            arr = (rng.uniform(size=hw + (3,)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(base / "images" / f"{name}.jpg")
            a = 0.1 * i
            calib = {
                "R": np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                               [-np.sin(a), 0, np.cos(a)]]),
                "T": np.array([0.2 * i, 0.0, 0.1]),
                "K": np.array([[100.0, 0, hw[1] / 2], [0, 100.0, hw[0] / 2],
                               [0, 0, 1]])}
            stem = base / "calibration" / f"calibration_{name}"
            np.savez(f"{stem}.npz", **calib)
            with h5py.File(f"{stem}.h5", "w") as f:
                for k, v in calib.items():
                    f[k] = v
            names.append(f"images/{name}.jpg")
        with open(base / "sub_set" / "5bag_000.txt", "w") as f:
            f.write("\n".join(names))
    return str(root)


@pytest.fixture(scope="module")
def imc_tree(tmp_path_factory):
    return make_imc_tree(tmp_path_factory.mktemp("imc"))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, imc_tree):
    """`python -m vggsfm_tpu_torch.imc_eval` on the tree's bag in a child
    process at the smallest size the runner takes (64 px, 1 query frame,
    32 Harris points, no fine tracking), the CPU asked for; started when
    the first test of the file asks for it, awaited by the CLI test."""
    out = tmp_path_factory.mktemp("imc_cli")
    cmd = [sys.executable, "-m", "vggsfm_tpu_torch.imc_eval",
           "--imc-dir", imc_tree, "--bags", BAG, "--img-size", "64",
           "--query-frame-num", "1", "--max-query-pts", "32",
           "--query-method", "harris", "--no-fine-tracking",
           "--calib-ext", ".npz", "--device", "cpu",
           "--submission-dir", str(out / "sub"),
           "--pack-submission", str(out / "pack"),
           "--out", str(out / "results.json")]
    # one intra-op thread: the other test workers hold the cores, and
    # OpenMP threads that spin at their barriers beside them slow the
    # child many times over; its output goes to files (a pipe left unread
    # until the end could fill and stop it)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=so,
                                stderr=se)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(autouse=True)
def _start_the_cli_first(cli_run):
    """The child runs while the other tests of the file do."""


# ------------------------------------------------------- camera_transform

def _extrinsics(rng, S=5):
    centers = rng.uniform([-1.5, -0.5, -0.3], [1.5, 0.5, 0.3], size=(S, 3))
    extr = look_at_extrinsics(centers, np.array([0.2, -0.1, 5.0]))
    return extr.astype(np.float64)


CT_CASES = ["to_crop", "to_scale", "from_crop_params", "optical_axis",
            "first_camera", "normalize"]


@pytest.mark.parametrize("case", CT_CASES)
def test_camera_transform_matches_jax(case):
    """Each of camera_transform's six functions on batched f64 inputs, the
    JAX one in f64: within 1e-6 (normalize_cameras under each of its
    options)."""
    rng = np.random.default_rng(CT_CASES.index(case))
    K = np.tile(np.array([[500.0, 0, 320], [0, 480, 250], [0, 0, 1]]),
                (4, 1, 1)) + rng.normal(size=(4, 3, 3)) * [[1, 0, 1],
                                                           [0, 1, 1],
                                                           [0, 0, 0]]
    extr = _extrinsics(rng)
    pts = rng.normal(size=(30, 3)) + [0, 0, 5]
    with jax.enable_x64(True):
        if case == "to_crop":
            bbox = rng.uniform(-50, 100, size=(4, 4))
            pairs = [(tct.adjust_intrinsics_to_crop(K, bbox),
                      jct.adjust_intrinsics_to_crop(K, bbox))]
        elif case == "to_scale":
            wh, new = np.array([640.0, 480.0]), rng.uniform(200, 1200, 2)
            pairs = [(tct.adjust_intrinsics_to_scale(K, wh, new),
                      jct.adjust_intrinsics_to_scale(K, wh, new))]
        elif case == "from_crop_params":
            params = np.stack([crop_parameters(
                w, h, np.array([0, -(max(w, h) - h) // 2,
                                max(w, h), h - (max(w, h) - h) // 2]),
                max(w, h), 256) for w, h in
                ((640, 480), (480, 640), (512, 512), (1024, 768))])
            pairs = [(tct.adjust_intrinsics_from_crop_params(K, params, 256),
                      jct.adjust_intrinsics_from_crop_params(K, params,
                                                             256))]
        elif case == "optical_axis":
            pairs = list(zip(tct.optical_axis_intersection(extr),
                             jct.optical_axis_intersection(
                                 jnp.asarray(extr))))
        elif case == "first_camera":
            pairs = list(zip(tct.first_camera_transform(extr, pts),
                             jct.first_camera_transform(
                                 jnp.asarray(extr), jnp.asarray(pts))))
        else:
            pairs = []
            for kw in ({}, {"max_norm": True, "scale": 2.0},
                       {"compute_optical": False},
                       {"first_camera": False, "normalize_trans": False}):
                pairs += list(zip(
                    tct.normalize_cameras(extr, pts, **kw),
                    jct.normalize_cameras(jnp.asarray(extr),
                                          jnp.asarray(pts), **kw)))
        for got, want in pairs:
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    # f32 in, f32 out
    assert tct.adjust_intrinsics_to_crop(
        K.astype(np.float32), np.zeros(4)).dtype == torch.float32


# ---------------------------------------------------------------- imc.py

@pytest.mark.parametrize("calib_ext", [".npz", ".h5"])
def test_imc_dataset_and_load_bag(imc_tree, calib_ext):
    """Bag discovery (names, london_bridge excluded or kept) and
    `load_bag` against the JAX package's: the images equal, the GT
    extrinsics (frame 0 at [I | 0]) and both intrinsics within 1e-6; the
    resized intrinsics move a point as the loader moves its pixel."""
    for excl in (False, True):
        t = timc.IMCDataset(imc_tree, img_size=64, calib_ext=calib_ext,
                            exclude_london_bridge=excl)
        j = jimc.IMCDataset(imc_tree, img_size=64, calib_ext=calib_ext,
                            exclude_london_bridge=excl)
        assert t.sequence_names() == j.sequence_names()
        assert len(t.sequence_names()) == (1 if excl else 2)
    for name in t.sequence_names():
        tb, jb = t.load_bag(name), j.load_bag(name)
        assert sorted(tb) == sorted(jb)
        assert tb["image_names"] == jb["image_names"]
        for k in ("images", "crop_params"):
            np.testing.assert_array_equal(tb[k], jb[k])
        for k in ("gt_extrinsics", "gt_intrinsics", "gt_intrinsics_resized"):
            assert tb[k].dtype == np.float32
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb["gt_extrinsics"][0], np.eye(3, 4),
                                   atol=1e-6)
    # grand_place: 80 x 60 -> a square of 80, 10 px padded above -> 64 px
    tb = t.load_bag(BAG)
    X = np.array([0.1, 0.05, 2.0])
    K, K2 = (tb[k][0].astype(np.float64) for k in ("gt_intrinsics",
                                                    "gt_intrinsics_resized"))
    uv, uv2 = (K @ X)[:2] / X[2], (K2 @ X)[:2] / X[2]
    np.testing.assert_allclose(uv2, (uv - [0, -10]) * (64 / 80), atol=1e-3)


def test_evaluate_bag_matches_jax():
    """`evaluate_bag` on the same arrays as the JAX one: predictions the
    GT turned by 0-20 degrees (S = 6), perfect, and device tensors."""
    rng = np.random.default_rng(3)
    gt = _extrinsics(rng, 6).astype(np.float32)
    for scale in (0.0, 0.05, 0.2):
        pred = gt.copy()
        pred[:, :, :3] += rng.normal(scale=scale, size=(6, 3, 3))
        U, _, Vt = np.linalg.svd(pred[:, :, :3])
        pred[:, :, :3] = U @ Vt
        pred[:, :, 3] += rng.normal(scale=scale, size=(6, 3))
        t = timc.evaluate_bag(torch.from_numpy(pred), gt)
        j = jimc.evaluate_bag(pred, gt)
        assert sorted(t) == sorted(j)
        assert abs(t["auc30"] - j["auc30"]) <= 1e-6
        np.testing.assert_array_equal(t["pair_mask"], j["pair_mask"])
        m = j["pair_mask"]
        for k in ("rot_err_deg", "trans_err_deg"):
            np.testing.assert_allclose(t[k][m], j[k][m], atol=1e-3)
    assert timc.evaluate_bag(gt, gt)["auc30"] > 0.95


@pytest.fixture(params=["h5", "npz"])
def h5_or_npz(request, monkeypatch):
    """With h5py, and with h5py hidden from both packages."""
    if request.param == "npz":
        monkeypatch.setattr(jimc, "h5py", None)
        monkeypatch.setattr(timc, "h5py", None)
    return request.param


def _same_files(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pose_submission_files_equal_jax(tmp_path, h5_or_npz):
    """`save_pose_submission` and `save_h5`/`load_h5` write what the JAX
    package writes (.h5, or .npz without h5py), a '/' in a key escaped."""
    rng = np.random.default_rng(4)
    extr = rng.normal(size=(4, 3, 4)).astype(np.float32)
    names = ["a/img_1.jpg", "img_2.jpg", "x.y.png", "img_4.JPG"]
    pt = timc.save_pose_submission(str(tmp_path / "t"), BAG, names,
                                   torch.from_numpy(extr))
    pj = jimc.save_pose_submission(str(tmp_path / "j"), BAG, names, extr)
    assert pt.endswith("." + h5_or_npz)
    assert os.path.basename(pt) == os.path.basename(pj)
    _same_files(timc.load_h5(pt), jimc.load_h5(pj))
    assert sorted(timc.load_h5(pt)) == ["pose_img_1", "pose_img_2",
                                        "pose_img_4", "pose_x.y"]
    payload = {"a/b": extr[0], "c": np.arange(3)}
    for ext in (".npz", ".h5") if h5_or_npz == "h5" else (".npz",):
        timc.save_h5(payload, str(tmp_path / f"t{ext}"))
        jimc.save_h5(payload, str(tmp_path / f"j{ext}"))
        _same_files(timc.load_h5(str(tmp_path / f"t{ext}")),
                    jimc.load_h5(str(tmp_path / f"j{ext}")))


def test_pack_scene_submission_equals_jax(tmp_path, h5_or_npz):
    """`pack_scene_submission` from device-free tensors (the port) and
    numpy (JAX) on the same fake predictions: the keypoints, scores,
    descriptors and matches files equal in content, the COLMAP model byte
    for byte, and each side reads back through its
    `load_scene_submission`."""
    preds = _fake_predictions(rng=np.random.default_rng(5))
    tpreds = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in preds.items()}
    desc = {n: np.random.default_rng(6).normal(size=(20, 8)) for n in NAMES}
    pt = tsub.pack_scene_submission(str(tmp_path / "t"), "imc", BAG,
                                    "vggsfm_tpu", NAMES, tpreds, (512, 512),
                                    descriptors=desc)
    pj = jsub.pack_scene_submission(str(tmp_path / "j"), "imc", BAG,
                                    "vggsfm_tpu", NAMES, preds, (512, 512),
                                    descriptors=desc)
    assert pt == tsub.submission_paths(str(tmp_path / "t"), "imc", BAG,
                                       "vggsfm_tpu")
    bt = tsub.load_scene_submission(str(tmp_path / "t"), "imc", BAG,
                                    "vggsfm_tpu")
    bj = jsub.load_scene_submission(str(tmp_path / "j"), "imc", BAG,
                                    "vggsfm_tpu")
    for k in ("keypoints", "scores", "descriptors", "matches"):
        assert bt[k], k
        _same_files(bt[k], bj[k])
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(pt["model"], f), "rb") as a, \
                open(os.path.join(pj["model"], f), "rb") as b:
            assert a.read() == b.read(), f
    assert len(bt["model"].images) == 4 and len(bt["model"].points3D) > 0
    ext = ".npz" if h5_or_npz == "npz" else ""
    assert os.path.exists(pt["keypoints"] + ext)
    # the helpers on the same tracks
    vis = preds["valid_2d_mask"]
    assert tsub.pair_key("z.png", "dir/a.jpg") == "a-z"
    _same_files(tsub.matches_from_tracks(NAMES, torch.from_numpy(vis), 3),
                jsub.matches_from_tracks(NAMES, vis, 3))
    for a, b in zip(tsub.features_from_tracks(NAMES, preds["pred_track"][0],
                                              vis),
                    jsub.features_from_tracks(NAMES, preds["pred_track"][0],
                                              vis)):
        _same_files(a, b)


# -------------------------------------------------------------------- CLI

def test_imc_cli_in_a_child_process(cli_run, imc_tree):
    """The CLI on the CPU: exit 0; the JSON table (printed and written)
    has the JAX table's keys; its AUC@30 is the JAX `evaluate_bag` of the
    port's own predicted poses (read back from the submission file)
    against the JAX loader's GT; the stderr line is the JAX CLI's; the
    packed scene reads back with the poses' frames."""
    proc, out = cli_run
    proc.wait(timeout=600)
    stdout, stderr = ((out / f).read_text() for f in ("stdout", "stderr"))
    assert proc.returncode == 0, stderr[-3000:]
    results = json.loads(stdout[stdout.index("{"):])
    assert results == json.load(open(out / "results.json"))
    assert set(results) == {"bags", "config", "mean_auc30"}
    assert set(results["config"]) == {"img_size", "query_frame_num",
                                      "max_query_pts", "query_method",
                                      "checkpoint"}
    row = results["bags"][BAG]
    assert set(row) == {"num_frames", "auc30", "rot_err_med_deg",
                        "trans_err_med_deg", "valid_tracks", "wall_s",
                        "stage_s"}
    assert row["num_frames"] == 4 and row["valid_tracks"] > 0
    assert {"camera_init", "tracking", "preliminary", "sfm"} <= set(
        row["stage_s"])
    assert re.search(rf"^{BAG}: AUC@30={row['auc30']:.4f} frames=4 "
                     rf"tracks={row['valid_tracks']} wall=\d+\.\ds$",
                     stderr, re.M)

    poses = timc.load_h5(str(out / "sub" / f"{BAG}.h5"))
    gt = jimc.IMCDataset(imc_tree, img_size=64, calib_ext=".npz").load_bag(
        BAG)
    pred = np.stack([poses[f"pose_{os.path.splitext(n)[0]}"]
                     for n in gt["image_names"]]).astype(np.float32)
    want = jimc.evaluate_bag(pred, gt["gt_extrinsics"])
    assert abs(row["auc30"] - want["auc30"]) <= 1e-6
    assert results["mean_auc30"] == row["auc30"]
    packed = tsub.load_scene_submission(str(out / "pack"), "imc", BAG,
                                        "vggsfm_tpu")
    assert sorted(packed["keypoints"]) == [f"img_{i:03d}" for i in range(4)]
    for im in packed["model"].images.values():
        np.testing.assert_allclose(
            im.tvec, poses[f"pose_{os.path.splitext(im.name)[0]}"][:, 3],
            atol=1e-6)
