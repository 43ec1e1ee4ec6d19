"""The port's export and loading modules against the JAX package's, on
the same seeded inputs, on the CPU: io/colmap.py, io/bridge.py, io/glb.py,
datasets/demo_loader.py, and the runner's checkpoint by path.

All of these are numpy on both sides, so the comparisons are exact: the
written files byte for byte, the Reconstructions field by field (values,
dtypes, and the order of the ids), the loaded arrays equal.
"""

import os

import numpy as np
import pytest
import torch

from vggsfm_tpu.datasets import demo_loader as jload
from vggsfm_tpu.io import bridge as jbridge
from vggsfm_tpu.io import colmap as jcolmap
from vggsfm_tpu.io import glb as jglb
from vggsfm_tpu_torch.datasets import demo_loader as tload
from vggsfm_tpu_torch.io import bridge as tbridge
from vggsfm_tpu_torch.io import colmap as tcolmap
from vggsfm_tpu_torch.io import glb as tglb


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small ops: intra-op threads gain them nothing under several test
    workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def same_reconstruction(a, b):
    """Two Reconstructions (of either package) hold the same fields, the
    same dtypes and the same id order."""
    assert list(a.cameras) == list(b.cameras)
    for k, ca in a.cameras.items():
        cb = b.cameras[k]
        assert (ca.id, ca.model, ca.width, ca.height) == \
            (cb.id, cb.model, cb.width, cb.height)
        _same_array(ca.params, cb.params)
    assert list(a.images) == list(b.images)
    for k, ia in a.images.items():
        ib = b.images[k]
        assert (ia.id, ia.camera_id, ia.name) == (ib.id, ib.camera_id,
                                                  ib.name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            _same_array(getattr(ia, f), getattr(ib, f))
    assert list(a.points3D) == list(b.points3D)
    for k, pa in a.points3D.items():
        pb = b.points3D[k]
        assert pa.id == pb.id and pa.error == pb.error
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            _same_array(getattr(pa, f), getattr(pb, f))


def _seeded_model(mod, camera_type, seed=0):
    """A Reconstruction of `mod` (either package's colmap module) from a
    seed: 3 cameras, 4 images (one with no observations, unmatched
    observations among the rest), 6 points (one trackless)."""
    rng = np.random.default_rng(seed)
    n = tcolmap.CAMERA_MODEL_NUM_PARAMS[camera_type]
    cams = {c: mod.Camera(c, camera_type, 640 + c, 480 - c,
                          rng.normal(size=n) * 100) for c in (1, 2, 3)}
    images = {}
    for i in (1, 2, 3, 5):
        m = 0 if i == 3 else int(rng.integers(1, 7))
        pids = rng.integers(-1, 6, size=m).astype(np.int64)
        q = rng.normal(size=4)
        images[i] = mod.Image(i, q / np.linalg.norm(q), rng.normal(size=3),
                              1 + i % 3, f"im_{i}.jpg",
                              rng.uniform(0, 640, size=(m, 2)), pids)
    points = {}
    for p in range(6):
        ln = 0 if p == 4 else int(rng.integers(2, 5))
        points[p] = mod.Point3D(
            p, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
            float(rng.uniform()),
            rng.integers(1, 6, size=ln).astype(np.int32),
            rng.integers(0, 7, size=ln).astype(np.int32))
    return mod.Reconstruction(cams, images, points)


@pytest.mark.parametrize("camera_type", ["SIMPLE_PINHOLE", "SIMPLE_RADIAL"])
@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_write_model_byte_identical(tmp_path, camera_type, ext):
    """`write_model` of the same seeded model: the port's files equal the
    JAX package's byte for byte; each reader decodes the other's binary
    files to equal fields."""
    dirs = {}
    for name, mod in (("jax", jcolmap), ("port", tcolmap)):
        dirs[name] = str(tmp_path / name)
        mod.write_model(_seeded_model(mod, camera_type), dirs[name], ext=ext)
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["port"])) and len(files) == 3
    for f in files:
        assert _bytes(os.path.join(dirs["jax"], f)) == \
            _bytes(os.path.join(dirs["port"], f)), f
    if ext == ".bin":
        want = _seeded_model(tcolmap, camera_type)
        same_reconstruction(tcolmap.read_model(dirs["jax"]),
                            jcolmap.read_model(dirs["port"]))
        same_reconstruction(tcolmap.read_model(dirs["jax"]),
                            tcolmap.read_model(dirs["port"]))
        got = tcolmap.read_model(dirs["jax"])
        for k, im in want.images.items():
            np.testing.assert_array_equal(got.images[k].xys.reshape(-1, 2),
                                          im.xys.reshape(-1, 2))


def _batch(S=5, P=40, K=1, seed=1):
    rng = np.random.default_rng(seed)
    extr = np.zeros((S, 3, 4), np.float32)
    for s in range(S):
        q = rng.normal(size=4)
        extr[s, :, :3] = jbridge._quat_to_matrix(q)
        extr[s, :, 3] = rng.normal(size=3)
    # one rotation of each branch of the quaternion extraction
    for s, d in zip(range(1, S), ([1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
                                  [-1.0, -1.0, 1.0])):
        extr[s, :, :3] = np.diag(d)
    f = rng.uniform(100, 200, size=S)
    intr = np.zeros((S, 3, 3), np.float32)
    intr[:, 0, 0], intr[:, 1, 1] = f, f
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 2, 2] = 64, 60, 1
    masks = rng.uniform(size=(S, P)) < 0.5
    masks[:, :3] = False  # never seen
    masks[0, 3] = True  # seen once
    masks[1:, 3] = False
    return dict(
        points3d=rng.normal(size=(P, 3)).astype(np.float32),
        extrinsics=extr, intrinsics=intr,
        tracks=rng.uniform(0, 128, size=(S, P, 2)).astype(np.float32),
        masks=masks, image_size=(128, 120),
        extra_params=rng.normal(size=(S, K)).astype(np.float32) * 0.01,
        colors=rng.integers(0, 256, (P, 3)).astype(np.uint8),
        reproj_errors=rng.uniform(size=P).astype(np.float32),
        image_names=[f"f{s}.png" for s in range(S)])


@pytest.mark.parametrize("camera_type,shared", [
    ("SIMPLE_PINHOLE", False), ("SIMPLE_RADIAL", False),
    ("SIMPLE_PINHOLE", True), ("SIMPLE_RADIAL", True)])
def test_bridge_matches_jax(camera_type, shared):
    """arrays_to_reconstruction (vectorized in the port),
    rescale_reconstruction_to_original with a hole where a frame was
    deregistered (a landscape and a portrait original, shared camera or
    not) and reconstruction_to_arrays: equal fields."""
    b = _batch()
    kw = dict(extra_params=b["extra_params"], shared_camera=shared,
              camera_type=camera_type, image_names=b["image_names"],
              colors=b["colors"], reproj_errors=b["reproj_errors"])
    args = (b["points3d"], b["extrinsics"], b["intrinsics"], b["tracks"],
            b["masks"], b["image_size"])
    recs = {"jax": jbridge.arrays_to_reconstruction(*args, **kw),
            "port": tbridge.arrays_to_reconstruction(*args, **kw)}
    same_reconstruction(recs["jax"], recs["port"])
    assert len(recs["port"].points3D) > 5
    assert 3 not in recs["port"].points3D  # seen once
    # defaults: no names, colors or errors
    same_reconstruction(jbridge.arrays_to_reconstruction(*args),
                        tbridge.arrays_to_reconstruction(*args))

    crop = np.array([[400, 300, 1, 1, 0, 16, 128, 112],
                     [300, 400, 1, 1, 16, 0, 112, 128]] * 3,
                    np.float32)[:5]
    names = [f"orig_{s}.jpg" for s in range(5)]
    for name, mod in (("jax", jbridge), ("port", tbridge)):
        recs[name].images.pop(3)  # a deregistered frame
        recs[name] = mod.rescale_reconstruction_to_original(
            recs[name], crop, 128, image_names=names, shared_camera=shared)
    same_reconstruction(recs["jax"], recs["port"])
    assert recs["port"].images[5].name == "orig_4.jpg"

    for num_points in (None, 30):
        ja = jbridge.reconstruction_to_arrays(recs["jax"], num_points)
        ta = tbridge.reconstruction_to_arrays(recs["port"], num_points)
        for x, y in zip(ja, ta):
            if x is None:
                assert y is None
            else:
                _same_array(x, y)


@pytest.mark.parametrize("colors", ["float", "uint8", "none"])
def test_glb_byte_identical(tmp_path, colors):
    """write_glb_scene (with and without cameras) and
    reconstruction_to_glb: identical bytes."""
    rng = np.random.default_rng(2)
    b = _batch(seed=2)
    cols = {"float": rng.uniform(-0.1, 1.1, (40, 3)).astype(np.float32),
            "uint8": b["colors"], "none": None}[colors]
    for name, mod in (("jax", jglb), ("port", tglb)):
        mod.write_glb_scene(str(tmp_path / f"{name}_pts.glb"),
                            b["points3d"], colors=cols)
        mod.write_glb_scene(str(tmp_path / f"{name}_cams.glb"),
                            b["points3d"], colors=cols,
                            extrinsics=b["extrinsics"],
                            intrinsics=b["intrinsics"],
                            image_size=b["image_size"])
        preds = {"valid_tracks": b["masks"][0], "points3d": b["points3d"],
                 "colors": cols, "extrinsics": b["extrinsics"],
                 "intrinsics": b["intrinsics"]}
        mod.reconstruction_to_glb(preds, str(tmp_path / f"{name}_rec.glb"),
                                  image_size=b["image_size"])
    for kind in ("pts", "cams", "rec"):
        assert _bytes(tmp_path / f"jax_{kind}.glb") == \
            _bytes(tmp_path / f"port_{kind}.glb"), kind


def test_demo_loader_matches_jax(tmp_path):
    """DemoLoader on a scene of seeded PNGs (a landscape and a portrait
    image, masks, a GT model under sparse/0): equal images, masks, crop
    parameters, names and GT arrays, at a size that crops, pads and
    resizes."""
    from PIL import Image

    rng = np.random.default_rng(4)
    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    (scene / "masks").mkdir()
    for name, (h, w) in (("a.png", (30, 44)), ("b.png", (46, 28))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(scene / "images" / name)
        Image.fromarray(((rng.uniform(size=(h, w)) > 0.7) * 255).astype(
            np.uint8)).save(scene / "masks" / name)
    b = _batch(S=2, P=10, seed=4)
    gt = tbridge.arrays_to_reconstruction(
        b["points3d"], b["extrinsics"], b["intrinsics"], b["tracks"],
        np.ones((2, 10), bool), (44, 46), image_names=["a.png", "b.png"])
    tcolmap.write_model(gt, str(scene / "sparse" / "0"))

    out = {name: mod.DemoLoader(str(scene), img_size=32, load_gt=True).load()
           for name, mod in (("jax", jload), ("port", tload))}
    j, t = out["jax"], out["port"]
    assert t["image_names"] == j["image_names"] == ["a.png", "b.png"]
    assert t["scene_dir"] == j["scene_dir"]
    for k in ("images", "masks", "crop_params"):
        _same_array(t[k], j[k])
    assert t["images"].shape == (2, 32, 32, 3)
    assert set(t["original_images"]) == set(j["original_images"])
    for k, v in j["original_images"].items():
        _same_array(t["original_images"][k], v)
    assert t["gt"]["image_names"] == j["gt"]["image_names"]
    for k in ("extrinsics", "intrinsics", "points", "extra_params"):
        if j["gt"][k] is None:
            assert t["gt"][k] is None
        else:
            _same_array(t["gt"][k], j["gt"][k])
    for mod in (jload, tload):
        assert mod.DemoLoader(str(scene), 32).load().get("gt") is None


def test_checkpoint_by_path(tmp_path):
    """`RunnerConfig.checkpoint`: a reference-layout state_dict saved to a
    file (the port's seeded tracker under ``track_predictor.``, a camera
    part under ``camera_predictor.``) loads into the port's tracker
    exactly, routes the camera entries to the lazily built camera and
    counts as loaded weights; the JAX package's converter of the same file
    maps back to the same tensors; a path that does not exist leaves the
    seeded weights."""
    from vggsfm_tpu.models.convert import convert_tracker
    from vggsfm_tpu_torch.models.convert import tracker_state_dict_from_jax
    from vggsfm_tpu_torch.models.tracker import (
        TrackerPredictor,
        init_tracker_,
    )
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    g = torch.Generator().manual_seed(5)
    sd = {f"track_predictor.{k}": torch.randn(v.shape, generator=g)
          for k, v in TrackerPredictor().state_dict().items()}
    cam = {"camera_predictor.pose_token": torch.randn(1, 1, 1, 768),
           "camera_predictor.backbone.cls_token": torch.randn(1, 1, 768)}
    path = str(tmp_path / "vggsfm_v2_0_0.bin")
    torch.save({**sd, **cam}, path)

    runner = VGGSfMRunner(RunnerConfig(checkpoint=path, seed=1),
                          device="cpu")
    assert runner._weights_loaded
    got = runner.tracker.state_dict()
    assert set(got) == {k[len("track_predictor."):] for k in sd}
    for k, v in sd.items():
        assert torch.equal(got[k[len("track_predictor."):]], v), k
    assert {k: v.shape for k, v in runner._camera_state_dict.items()} == \
        {"pose_token": (1, 1, 1, 768), "backbone.cls_token": (1, 1, 768)}

    # the JAX converter reads the same file into the same tensors
    loaded = torch.load(path, map_location="cpu")
    back = tracker_state_dict_from_jax(convert_tracker(loaded))
    assert set(back) == set(got)
    for k, v in back.items():
        assert torch.equal(torch.as_tensor(np.asarray(v)), got[k]), k

    seeded = VGGSfMRunner(RunnerConfig(checkpoint=str(tmp_path / "none"),
                                       seed=1), device="cpu")
    ref = TrackerPredictor()
    init_tracker_(ref, torch.Generator().manual_seed(1))
    assert not seeded._weights_loaded and seeded._camera_state_dict is None
    for k, v in ref.state_dict().items():
        assert torch.equal(seeded.tracker.state_dict()[k], v), k
