"""The port's dense-depth slice against the JAX package's, on the CPU, at a
tiny size (DINOv2 32 wide, 4 blocks, 4 heads; DPT features 16, out
channels (8, 16, 24, 32)) on the same numpy inputs and weights.

The weights: the port's seeded init with numpy noise on every tensor (so
no bias or LayerNorm hides a wrong mapping), carried to JAX by the JAX
package's own `convert_depth_anything` (the public DepthAnythingV2 key
layout) and back by the port's `depth_anything_state_dict_from_jax`.

The JAX converter reads ``scratch.refinenet{1,2,3,4}`` into its fusion
blocks 3, 2, 1, 0 (vggsfm_tpu/models/convert.py:254), where the public
DPT head runs refinenet4 on the coarsest level and refinenet1 on the
finest, as that converter's own comment says (:251-253). Its test
(tests/test_convert.py, `TestDPTHeadConversion`) compares outputs that
the head's final ReLU makes all zero, so it cannot see the order. The port
follows the public head (held here against that test's torch replica of
it, with weights that give non-zero disparities); the JAX converter is
given the checkpoint with the refinenets renamed to its order
(`_jax_refinenet_order`), and the test shows that without the renaming
its forward differs.

Tolerances: DINOv2 taps 1e-5 absolute (f32 sums in another order through
4 blocks, O(1) tokens); the disparity 1e-4 relative to its largest value
(the same through the head's convs); alignment coefficients 1e-5
relative, masks equal (the same draws, f32 elementwise); depth maps 1e-4
relative (they carry the disparity's difference).
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu import runner as jrun
from vggsfm_tpu.models import convert as jconv
from vggsfm_tpu.models.dinov2 import DinoVisionTransformer as JDino
from vggsfm_tpu.models.dpt import DepthAnything as JDepth
from vggsfm_tpu.utils import depth as jdepth
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch.models.convert import depth_anything_state_dict_from_jax
from vggsfm_tpu_torch.models.dpt import DepthAnything, init_depth_anything_
from vggsfm_tpu_torch.utils import depth as tdepth

TINY = dict(tap_layers=(0, 1, 2, 3), features=16,
            out_channels=(8, 16, 24, 32), embed_dim=32, depth=4,
            num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small ops: intra-op threads gain them nothing under several test
    workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_port_model(seed=0, **kw):
    model = DepthAnything(**{**TINY, **kw}).eval()
    init_depth_anything_(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(
                scale=0.05, size=tuple(p.shape)).astype(np.float32)))
    return model


def _jax_refinenet_order(sd):
    """A public-layout state_dict with ``refinenet{k}`` renamed
    ``refinenet{5 - k}``: the order the JAX converter reads them in."""
    def name(k):
        for i in range(1, 5):
            old = f".scratch.refinenet{i}."
            if old in k:
                return k.replace(old, f".scratch.refinenet{5 - i}.")
        return k

    return {name(k): v for k, v in sd.items()}


@pytest.fixture(scope="module")
def tiny():
    """(port model, JAX module, JAX params of the same weights through the
    JAX package's converter, the jitted JAX forward)."""
    port = _seeded_port_model()
    params = jax.tree.map(jnp.asarray, jconv.convert_depth_anything(
        _jax_refinenet_order(port.state_dict())))
    jm = JDepth(**TINY)
    return port, jm, params, jax.jit(jm.apply)


def _images(shape, seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_dinov2_taps_match_jax(tiny):
    """`return_layers` taps: each tapped block's patch tokens with the
    final LayerNorm, class and register tokens stripped, within 1e-5 of
    the JAX module's; the final tokens of a tapped call are bit for bit
    those of an untapped one."""
    port, _, params, _ = tiny
    x = _images((2, 42, 56, 3))
    jb = JDino(embed_dim=32, depth=4, num_heads=4)
    want_out, want_taps = jax.jit(
        functools.partial(jb.apply, return_layers=(0, 2, 3)))(
        {"params": params["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        out, taps = port.pretrained(torch.from_numpy(x),
                                    return_layers=(0, 2, 3))
        plain = port.pretrained(torch.from_numpy(x))
    assert torch.equal(out, plain)
    assert len(taps) == 3
    for got, want in zip([out, *taps], [want_out, *want_taps]):
        assert got.shape == (2, 12, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(56, 70), (60, 75)])
def test_depth_anything_matches_jax(tiny, hw):
    """The port's DepthAnything with the JAX params through
    `depth_anything_state_dict_from_jax` (strict load) against the JAX
    forward: a size of patch multiples and one that is edge-padded and
    cropped. Within 1e-4 of the largest disparity; disparity >= 0. The
    port model the params came from gives the same."""
    port, _, params, japply = tiny
    x = _images((1, *hw, 3), seed=hw[0])
    want = np.asarray(japply(params, jnp.asarray(x)))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(depth_anything_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, *hw) and got.dtype == np.float32
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0.1
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                                   rtol=0, atol=1e-4 * np.abs(want).max())


def test_dpt_head_matches_the_public_torch_head(tiny):
    """The port's DPTHead against the torch replica of DepthAnythingV2's
    head in tests/test_convert.py (public key layout, refinenet4 on the
    coarsest level, torch's ConvTranspose2d), loaded with the port's head
    weights: within 1e-5 of the largest disparity, which is not 0."""
    import test_convert

    port = tiny[0]
    head = test_convert.TestDPTHeadConversion()._torch_head(32, 16,
                                                            (8, 16, 24, 32))
    head.load_state_dict(port.depth_head.state_dict(), strict=True)
    rng = np.random.default_rng(3)
    taps = [torch.from_numpy(rng.normal(size=(1, 20, 32)).astype(
        np.float32)) for _ in range(4)]
    with torch.no_grad():
        want = head(taps, 4, 5, (56, 70))[:, 0].numpy()
        got = port.depth_head(taps, (4, 5), (56, 70)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_conv_transpose_orientation_on_an_asymmetric_kernel():
    """flax's ConvTranspose against torch's ConvTranspose2d with the
    converted kernel, x4 and x2 with kernel = stride as in the DPT's
    resize layers: equal. The kernel's taps all differ, so an unflipped
    conversion would fail (checked: it does)."""
    import flax.linen as nn

    from vggsfm_tpu_torch.models import convert as tconv

    rng = np.random.default_rng(2)
    for k in (4, 2):
        x = rng.normal(size=(1, 3, 5, 2)).astype(np.float32)
        kernel = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
        bias = rng.normal(size=(3,)).astype(np.float32)
        layer = nn.ConvTranspose(3, (k, k), strides=(k, k), padding="VALID")
        want = np.asarray(layer.apply(
            {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
        sd = {}
        tconv._deconv(sd, "d", {"kernel": kernel, "bias": bias})
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = torch.nn.functional.conv_transpose2d(
            xt, sd["d.weight"], sd["d.bias"], stride=k).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        unflipped = torch.from_numpy(np.ascontiguousarray(
            np.transpose(kernel, (2, 3, 0, 1))))
        bad = torch.nn.functional.conv_transpose2d(
            xt, unflipped, sd["d.bias"], stride=k).permute(0, 2, 3, 1)
        assert np.abs(bad.numpy() - want).max() > 0.1


def test_public_key_layout_reads_back_in_jax_and_the_runner(tiny, tmp_path,
                                                            monkeypatch):
    """The port's state_dict saved with torch.save is a DepthAnythingV2
    checkpoint: its keys are the public layout's, a fresh port model loads
    it strictly, the JAX package's `convert_depth_anything` reads it, and
    with the refinenets in that converter's order its forward is the
    port's (in the order as saved, it is not: the converter's fault, see
    the module docstring); the port runner's `depth_checkpoint` path
    builds that model from it."""
    port, _, _, japply = tiny
    path = str(tmp_path / "depth_anything_v2_tiny.pth")
    torch.save(port.state_dict(), path)
    sd = torch.load(path, map_location="cpu")
    head = {k for k in sd if k.startswith("depth_head.")}
    want_head = {f"depth_head.{k}" for k in (
        *(f"projects.{i}.{w}" for i in range(4) for w in ("weight", "bias")),
        *(f"resize_layers.{i}.{w}" for i in (0, 1, 3)
          for w in ("weight", "bias")),
        *(f"scratch.layer{i}_rn.weight" for i in range(1, 5)),
        *(f"scratch.refinenet{i}.{u}.{c}.{w}" for i in range(1, 5)
          for u in ("resConfUnit1", "resConfUnit2") for c in ("conv1", "conv2")
          for w in ("weight", "bias")),
        *(f"scratch.refinenet{i}.out_conv.{w}" for i in range(1, 5)
          for w in ("weight", "bias")),
        *(f"scratch.output_conv{k}.{w}" for k in ("1", "2.0", "2.2")
          for w in ("weight", "bias")))}
    assert head == want_head
    assert {k.split(".")[1] for k in sd if k.startswith("pretrained.")} == {
        "cls_token", "mask_token", "register_tokens", "pos_embed",
        "patch_embed", "blocks", "norm"}

    DepthAnything(**TINY).load_state_dict(sd, strict=True)

    x = _images((1, 56, 70, 3), seed=5)

    def jax_forward(state_dict):
        return np.asarray(japply(jax.tree.map(
            jnp.asarray, jconv.convert_depth_anything(state_dict)),
            jnp.asarray(x)))

    want = jax_forward(_jax_refinenet_order(sd))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(jax_forward(sd) - got).max() > 0.1 * np.abs(got).max()

    monkeypatch.setattr(trun, "DepthAnything",
                        functools.partial(DepthAnything, **TINY))
    runner = types.SimpleNamespace(
        cfg=trun.RunnerConfig(depth_checkpoint=path, precision="f32"),
        dtype=torch.float32, device=torch.device("cpu"), _depth=None)
    loaded = trun.VGGSfMRunner._load_depth_model(runner)
    with torch.no_grad():
        assert torch.equal(loaded(torch.from_numpy(x)),
                           port(torch.from_numpy(x)))


def test_vitl_without_registers_loads_the_public_layout():
    """`DepthAnything.vitl()` is DepthAnythingV2-Large: 24 blocks, 1024
    wide, no ``register_tokens`` entry; its taps and head widths."""
    with torch.device("meta"):
        model = DepthAnything.vitl()
    sd = model.state_dict()
    assert "pretrained.register_tokens" not in sd
    assert 1 + max(int(k.split(".")[2]) for k in sd
                   if k.startswith("pretrained.blocks.")) == 24
    assert sd["pretrained.cls_token"].shape == (1, 1, 1024)
    assert sd["depth_head.scratch.layer1_rn.weight"].shape == (256, 256,
                                                                3, 3)
    assert sd["depth_head.resize_layers.0.weight"].shape == (256, 256, 4, 4)
    assert model.tap_layers == (4, 11, 17, 23)


def _jax_draws(seed, S, N, trials=256):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return np.stack([np.asarray(jax.random.randint(k, (trials, 2), 0, N))
                     for k in keys])


def _planted_alignment(S=3, H=24, W=32, N=300, seed=0):
    """Disparity maps of a planted depth field with 20% corrupted SfM
    depths, identity cameras: the inputs of `align_depth_maps_to_sfm`."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    field = 2.0 + 0.03 * gx + 0.05 * gy
    disp = np.stack([((1.0 / field) - 0.02 * (s + 1)) / (0.8 + 0.1 * s)
                     for s in range(S)]).astype(np.float32)
    xs = rng.uniform(1, W - 2, N).astype(np.float32)
    ys = rng.uniform(1, H - 2, N).astype(np.float32)
    z = 2.0 + 0.03 * xs + 0.05 * ys
    z[rng.choice(N, N // 5, replace=False)] *= 3.0
    f = 30.0
    X = np.stack([(xs - W / 2) / f * z, (ys - H / 2) / f * z, z],
                 -1).astype(np.float32)
    extr = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (S, 3, 4)).copy()
    tracks = np.broadcast_to(np.stack([xs, ys], -1), (S, N, 2)).copy()
    tracks += rng.normal(scale=0.3, size=tracks.shape).astype(np.float32)
    obs = rng.uniform(size=(S, N)) < 0.9
    return disp, extr, X, tracks.astype(np.float32), obs


def test_alignment_matches_jax_with_its_draws():
    """`align_disparity_to_depth` on one frame and
    `align_depth_maps_to_sfm` over frames, the JAX draws injected: the
    inlier masks equal, a, b and the inlier fractions within 1e-5
    relative, the depth maps within 1e-5 relative."""
    disp, extr, X, tracks, obs = _planted_alignment()
    S, N = obs.shape
    draws = _jax_draws(7, S, N)

    d1 = disp[0, 5, :N % 32 + 20].repeat(10)[:N]
    z1 = 1.0 / (0.7 * d1 + 0.05)
    z1[::4] *= 2.5
    v1 = obs[0]
    key = jax.random.PRNGKey(3)
    want = jdepth.align_disparity_to_depth(
        jnp.asarray(d1), jnp.asarray(z1), jnp.asarray(v1), key)
    idx = np.asarray(jax.random.randint(key, (256, 2), 0, N))
    got = tdepth.align_disparity_to_depth(
        torch.from_numpy(d1), torch.from_numpy(z1.astype(np.float32)),
        torch.from_numpy(v1), torch.from_numpy(np.array(idx)).long())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)

    jm, ja, jb, jf = jax.jit(jdepth.align_depth_maps_to_sfm)(
        jnp.asarray(disp), jnp.asarray(extr), jnp.asarray(X),
        jnp.asarray(tracks), jnp.asarray(obs), jax.random.PRNGKey(7))
    tm, ta, tb, tf = tdepth.align_depth_maps_to_sfm(
        torch.from_numpy(disp), torch.from_numpy(extr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(obs), sample_idx=draws)
    for g, w in ((ta, ja), (tb, jb), (tf, jf), (tm, jm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=0)
    assert float(tf.min()) > 0.6
    # the port's own draws: a CPU generator, (S, 256, 2) in [0, N)
    g1 = tdepth.align_depth_maps_to_sfm(
        torch.from_numpy(disp), torch.from_numpy(extr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(obs),
        torch.Generator().manual_seed(7))
    assert torch.equal(g1[0], tdepth.align_depth_maps_to_sfm(
        torch.from_numpy(disp), torch.from_numpy(extr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(obs),
        torch.Generator().manual_seed(7))[0])


def test_colmap_array_bytes_match_jax(tmp_path):
    """`write_colmap_array` writes the JAX package's bytes (one and three
    channels); `read_colmap_array` reads them back."""
    rng = np.random.default_rng(4)
    for shape in ((7, 9), (5, 6, 3)):
        arr = rng.normal(size=shape).astype(np.float32)
        a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
        tdepth.write_colmap_array(a, arr)
        jdepth.write_colmap_array(b, arr)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(tdepth.read_colmap_array(a), arr)


def test_dense_reconstruct_and_save_match_jax(tiny, tmp_path):
    """`dense_reconstruct` and `save_dense_depth_maps` in both runners on
    the same tiny model (JAX: ``runner._depth = (model, params)``), at
    `depth_input_size` 28, the JAX draws injected into the port's; then
    the maps written at each image's original resolution through crop
    parameters (a landscape and a portrait image padded to the square):
    the files' shapes equal, the values within 1e-4 relative."""
    from vggsfm_tpu.datasets.demo_loader import pad_and_resize_image

    port, jm, params, _ = tiny
    S, R, N = 2, 32, 60
    rng = np.random.default_rng(6)
    images = rng.uniform(size=(1, S, R, R, 3)).astype(np.float32)
    pred = {
        "extrinsics": np.broadcast_to(np.eye(3, 4, dtype=np.float32),
                                      (S, 3, 4)).copy(),
        "points3d": (rng.normal(size=(N, 3)) + [0, 0, 4]).astype(np.float32),
        "pred_track": rng.uniform(2, R - 2, size=(1, S, N, 2)).astype(
            np.float32),
        "valid_2d_mask": rng.uniform(size=(S, N)) < 0.9,
        "valid_tracks": np.ones(N, bool),
    }
    jr = jrun.VGGSfMRunner(jrun.RunnerConfig(
        img_size=R, depth_input_size=28, dense_depth=True, precision="f32"))
    jr._depth = (jm, params)
    want = jr.dense_reconstruct(jnp.asarray(images), dict(pred))

    tr = types.SimpleNamespace(
        cfg=trun.RunnerConfig(img_size=R, depth_input_size=28,
                              dense_depth=True, precision="f32"),
        device=torch.device("cpu"), _depth=port)
    tr._to_device = functools.partial(trun.VGGSfMRunner._to_device, tr)
    tr._disparity = functools.partial(trun.VGGSfMRunner._disparity, tr)
    tr._load_depth_model = lambda: port
    got = trun.VGGSfMRunner.dense_reconstruct(
        tr, images, dict(pred), sample_idx=_jax_draws(7, S, N))
    np.testing.assert_allclose(got["depth_inlier_frac"].numpy(),
                               want["depth_inlier_frac"], rtol=1e-5)
    np.testing.assert_allclose(got["depth_align_coeffs"].numpy(),
                               want["depth_align_coeffs"], rtol=1e-4)
    dmax = np.abs(want["depth_maps"]).max()
    np.testing.assert_allclose(got["depth_maps"].numpy(), want["depth_maps"],
                               rtol=0, atol=1e-4 * dmax)

    crops = []
    for w, h in ((48, 36), (30, 44)):
        _, _, crop = pad_and_resize_image(
            np.zeros((h, w, 3), np.uint8), R)
        crops.append(np.asarray(crop))
    names = ["a.png", "b.jpg"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jr.save_dense_depth_maps(want["depth_maps"], names, jdir,
                             crop_params=crops)
    trun.VGGSfMRunner.save_dense_depth_maps(
        tr, got["depth_maps"], names, tdir, crop_params=crops)
    for stem, (w, h) in zip(("a", "b"), ((48, 36), (30, 44))):
        a = tdepth.read_colmap_array(os.path.join(tdir, "depths",
                                                  stem + ".bin"))
        b = jdepth.read_colmap_array(os.path.join(jdir, "depths",
                                                  stem + ".bin"))
        assert a.shape == b.shape == (h, w)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * dmax)
