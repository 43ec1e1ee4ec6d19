"""The port's tracker and camera weights: state_dict layout and the JAX
converters.

* `TrackerPredictor().state_dict()` has exactly the reference
  checkpoint's ``track_predictor.*`` keys and shapes (prefix stripped),
  per tests/fixtures/vggsfm_v2_keys.json — so a reference checkpoint loads
  with `load_state_dict`.
* Round trip: JAX random init -> `tracker_state_dict_from_jax` -> the JAX
  package's own `convert_tracker` gives back the identical pytree.
* The port's seeded random init keeps the JAX init's conventions.
* The same for `CameraPredictor` (the manifest's 363 ``camera_predictor.*``
  keys, `camera_state_dict_from_jax` against `convert_camera_predictor`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.models import TrackerPredictor as JTracker
from vggsfm_tpu.models.camera import CameraPredictor as JCamera
from vggsfm_tpu.models.convert import (
    convert_camera_predictor,
    convert_tracker,
)
from vggsfm_tpu_torch.models import (
    CameraPredictor,
    TrackerPredictor,
    init_camera_,
    init_tracker_,
)
from vggsfm_tpu_torch.models.convert import (
    camera_state_dict_from_jax,
    tracker_state_dict_from_jax,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "vggsfm_v2_keys.json")
PREFIX = "track_predictor."


@pytest.fixture(scope="module")
def jax_params():
    jm = JTracker()
    params = jax.jit(lambda k, i, q: jm.init(k, i, q, method="init_all"))(
        jax.random.PRNGKey(3), jnp.zeros((1, 2, 64, 64, 3), jnp.float32),
        jnp.full((1, 4, 2), 20.0, jnp.float32))
    return jax.tree.map(np.asarray, params)


def _manifest(prefix):
    with open(FIXTURE) as f:
        manifest = json.load(f)["keys"]
    return {k[len(prefix):]: list(v) for k, v in manifest.items()
            if k.startswith(prefix)}


def test_state_dict_matches_reference_manifest():
    want = _manifest(PREFIX)
    have = {k: list(v.shape) for k, v in
            TrackerPredictor().state_dict().items()}
    assert len(want) == 327
    assert sorted(set(have) ^ set(want)) == []
    assert have == want


def test_round_trip_through_jax_converter(jax_params):
    sd = tracker_state_dict_from_jax(jax_params)
    back = convert_tracker({PREFIX + k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(jax_params["params"])[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_converted_weights_load_strictly(jax_params):
    model = TrackerPredictor()
    model.load_state_dict(tracker_state_dict_from_jax(jax_params),
                          strict=True)
    w = jax_params["params"]["coarse_fnet"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        model.coarse_fnet.conv1.weight.detach().numpy(),
        np.transpose(w, (3, 2, 0, 1)))


def test_seeded_init_conventions():
    a = init_tracker_(TrackerPredictor(), torch.Generator().manual_seed(0))
    b = init_tracker_(TrackerPredictor(), torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    uf = a.coarse_predictor.updateformer
    assert torch.count_nonzero(uf.flow_head.weight) == 0
    assert abs(uf.virual_tracks.std().item() - 1.0) < 0.1
    assert torch.all(a.coarse_predictor.norm.weight == 1)
    blk = uf.time_blocks[0]
    assert torch.count_nonzero(blk.attn.in_proj_bias) == 0
    # LeCun normal: std ~ 1/sqrt(fan_in)
    assert abs(blk.mlp.fc1.weight.std().item() * 384 ** 0.5 - 1.0) < 0.05


def test_runner_with_loaded_weights_leaves_weights_free_mode(jax_params):
    """Given weights, the runner keeps the matching init but drops the
    weights-free extras (cycle visibility, NCC polish), as the JAX runner
    does with a checkpoint: visibility then comes from the vis head."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    sd = tracker_state_dict_from_jax(jax_params)
    cfg = RunnerConfig(precision="f32", coarse_iters=1, fine_tracking=False)
    loaded = VGGSfMRunner(cfg, device="cpu", state_dict=sd)
    fresh = VGGSfMRunner(cfg, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(1, 2, 64, 64, 3)).astype(np.float32)
    qp = rng.uniform(8, 56, size=(64, 2)).astype(np.float32)
    _, vis_l, _ = loaded.predict_tracks(images, loaded.fmaps(images), [0],
                                        [qp])
    _, vis_f, _ = fresh.predict_tracks(images, fresh.fmaps(images), [0],
                                       [qp])
    model = TrackerPredictor().eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        _, vis_head = model(torch.from_numpy(images),
                            torch.from_numpy(qp)[None], coarse_iters=1,
                            matching_init=True, matching_vis=False)
    torch.testing.assert_close(vis_l, vis_head, atol=1e-5, rtol=0)
    assert not torch.allclose(vis_f, vis_head)


# ------------------------------------------------------------------ camera

CAM_PREFIX = "camera_predictor."
CAM_SMALL = dict(hidden_size=64, num_heads=4, z_dim=96, att_depth=2,
                 trunk_depth=2)


def test_camera_state_dict_matches_reference_manifest():
    want = _manifest(CAM_PREFIX)
    have = {k: list(v.shape) for k, v in
            CameraPredictor().state_dict().items()}
    assert len(want) == 363
    assert sorted(set(have) ^ set(want)) == []
    assert have == want


@pytest.fixture(scope="module")
def jax_camera_params():
    """A camera predictor of the full backbone and a narrow former."""
    jm = JCamera(**CAM_SMALL, down_size=28)
    params = jax.jit(lambda k, i: jm.init(k, i, iters=1))(
        jax.random.PRNGKey(5), jnp.zeros((1, 2, 28, 28, 3), jnp.float32))
    return jax.tree.map(np.asarray, params)


def test_camera_round_trip_through_jax_converter(jax_camera_params):
    sd = camera_state_dict_from_jax(jax_camera_params)
    back = convert_camera_predictor(
        {CAM_PREFIX + k: v.numpy() for k, v in sd.items()}, att_depth=2,
        trunk_depth=2)
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(
        jax_camera_params["params"])[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    model = CameraPredictor(**CAM_SMALL, down_size=28)
    model.load_state_dict(sd, strict=True)
    assert torch.count_nonzero(model.backbone.mask_token) == 0


def test_camera_seeded_init_conventions():
    a = init_camera_(CameraPredictor(**CAM_SMALL),
                     torch.Generator().manual_seed(0))
    b = init_camera_(CameraPredictor(**CAM_SMALL),
                     torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    bb = a.backbone
    assert abs(bb.pos_embed.std().item() - 0.02) < 0.002
    assert torch.count_nonzero(bb.cls_token) == 0
    assert torch.all(bb.blocks[0].ls1.gamma == 1)
    assert torch.all(bb.blocks[0].norm1.weight == 1)
    assert torch.all(a.cross_att[0].norm_context.weight == 1)
    assert 0 < a.pose_token.abs().max().item() < 1e-5
    w = bb.blocks[0].mlp.fc1.weight
    assert abs(w.std().item() * 768 ** 0.5 - 1.0) < 0.05
