"""VGGT-1B's feed-forward reconstruction (models/vggt.py, vggt/runner.py,
ops/attention.py) against the plain float32 reference
(tests/vggt_reference.py) on seeded weights, at a tiny size on the CPU:
aggregator 2 + 2 blocks 64 wide with 4 heads, DINOv2 2 blocks, 3 frames
of 56 x 56, a camera trunk of 1 block, a DPT of 16 features.

Tolerances: on the CPU the port runs in float32 here, as the reference
does, so the two differ only by the order of sums (blocked online softmax
against one softmax, the DPT's matrix-product resizes against
F.interpolate): relative RMS 1e-4 of each output, against ~1e-7 per
rounding. The same reference in bf16 misses that by about two orders of
magnitude (`test_bf16_reference_fails_the_tolerance`).

Tests marked `cuda` hold the attention kernel to its plain route on the
card (python -m pytest --noconftest tests/test_torch_vggt.py -q -m cuda):
bf16 inputs, the kernel's output within 2 bf16 ulps of the plain route's
terms (`_ulps`: the plain route rounds the probabilities at the same
points, and the two sum in other orders), and within `KERNEL_RMS` of it
in relative RMS, a bound that scales with the output itself (at L =
65,952 an output's terms are as large as its own RMS).
"""

import ctypes
import filecmp
import functools
import json
import math
import os

import numpy as np
import pytest
import torch
import vggt_reference as ref  # tests/, on the path pytest gives this file

from vggsfm_tpu_torch.geometry.cameras import fov_pose_to_extri_intri
from vggsfm_tpu_torch.models.vggt import (
    POSE_BIAS,
    VGGT,
    RotaryPositionEmbedding2D,
    init_vggt_,
)
from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.ops.attention import attention_plain, flash_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=56, embed_dim=64, depth=2, num_heads=4,
            dino_depth=2, dino_heads=4, trunk_depth=1, head_heads=4,
            dpt_features=16, dpt_out_channels=(8, 16, 32, 32),
            taps=(0, 0, 1, 1))
TOL = 1e-4  # relative RMS: float32 on both sides, sums in other orders
# kernel against plain route, relative RMS: both round the probabilities to
# bf16 in the same blocks of 128 keys and the output to bf16 (~2e-3 apart at
# most); a kernel that dropped 1% of the keys would read ~0.1
KERNEL_RMS = 1e-2


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def unbiased(pose, i):
    """The pose encoding of iteration `i` less the seeded pose branch's
    biases it summed (0.25 (i + 1) on w and the FoVs, which would dominate
    a relative gap)."""
    return pose - (i + 1) * torch.tensor(POSE_BIAS)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    port = VGGT(**TINY, dtype=torch.float32)
    init_vggt_(port, torch.Generator().manual_seed(3))
    port.eval()
    reference = ref.VGGT(**TINY).eval()
    reference.load_state_dict(port.state_dict(), strict=True)
    images = torch.rand(3, 56, 56, 3, generator=torch.Generator()
                        .manual_seed(4))
    return port, reference, images


def test_port_matches_the_reference(models):
    port, reference, images = models
    with torch.no_grad():
        got, want = port(images), reference(images)
        taps_got = port.aggregator(images)
        taps_want = reference.aggregator(images)
    for g, w in zip(taps_got, taps_want):
        assert rel(g, w) < TOL
    assert len(got["pose_enc_list"]) == 4
    for i, (g, w) in enumerate(zip(got["pose_enc_list"],
                                   want["pose_enc_list"])):
        assert rel(unbiased(g, i), unbiased(w, i)) < TOL
    assert rel(got["depth"].log(), want["depth"].log()) < TOL
    assert rel(got["depth_conf"], want["depth_conf"]) < TOL
    e_got, k_got = fov_pose_to_extri_intri(got["pose_enc_list"][-1],
                                           (56, 56))
    e_want, k_want = ref.pose_to_cameras(want["pose_enc_list"][-1], (56, 56))
    assert rel(e_got, e_want) < TOL and rel(k_got, k_want) < TOL
    # the seeded pose branch leaves plausible cameras: w ~ 1, FoV ~ 1 rad
    pose = got["pose_enc_list"][-1]
    assert torch.isfinite(k_got).all()
    assert float((pose[:, 7:] - 1.0).abs().max()) < 0.2


class Bf16Products(torch.overrides.TorchFunctionMode):
    """Every matrix product and convolution with its operands rounded to
    bf16 (sums in f32): the reference one precision step down."""

    OPS = {torch.nn.functional.linear, torch.matmul, torch.Tensor.__matmul__,
           torch.nn.functional.conv2d, torch.nn.functional.conv_transpose2d}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = tuple(a.bfloat16().float() if i < 2 and torch.is_tensor(a)
                         else a for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


def test_bf16_reference_fails_the_tolerance(models):
    _, reference, images = models
    with torch.no_grad():
        want = reference(images)
        with Bf16Products():
            got = reference(images)
    assert rel(got["depth"].log(), want["depth"].log()) > 10 * TOL
    assert rel(unbiased(got["pose_enc_list"][0], 0),
               unbiased(want["pose_enc_list"][0], 0)) > 10 * TOL


def test_runner_points_match_the_reference_unprojection(models,
                                                        monkeypatch):
    from vggsfm_tpu_torch.vggt import VGGTConfig, VGGTRunner

    port, reference, images = models
    monkeypatch.setattr(VGGTRunner, "dtype", torch.float32)
    cfg = VGGTConfig(img_size=56, conf_thres=2.0, max_points=500,
                     model=TINY)
    runner = VGGTRunner(cfg, device="cpu", state_dict=port.state_dict())
    out = runner.reconstruct(images.numpy())
    with torch.no_grad():
        want = reference(images)
    cand = int((want["depth_conf"] >= 2.0).sum())
    assert out["points3d"].shape[0] == min(500, cand) > 0
    extr, K = ref.pose_to_cameras(want["pose_enc_list"][-1], (56, 56))
    x, y, f = out["points_xyf"].unbind(-1)
    assert bool((want["depth_conf"][f, y, x] >= 2.0).all())
    pts = ref.unproject(want["depth"], extr, K, f, x, y)
    assert rel(out["points3d"], pts) < TOL
    assert torch.equal(out["colors"],
                       (images[f, y, x] * 255).to(torch.uint8))


@pytest.mark.parametrize("L", [1, 5, 130, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_matches_naive_softmax(L, dtype):
    g = torch.Generator().manual_seed(L)
    B, H = 2, 3
    q, k, v = (torch.randn(B * H, L, 64, generator=g).to(dtype)
               for _ in range(3))
    s = (q.float() @ k.float().transpose(1, 2)) / 8.0
    want = (torch.softmax(s, -1) @ v.float()).view(B, H, L, 64)
    want = want.transpose(1, 2).reshape(B, L, H * 64)
    got = attention_plain(q, k, v, B)
    assert got.dtype == dtype and got.shape == (B, L, H * 64)
    # f32: sums in another order; bf16: the output's rounding and the
    # probabilities' (2^-8 of each) under a sum of at most one
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want).abs().max()) < tol
    assert torch.equal(flash_attention(q, k, v, B), got)  # CPU: plain


def _ulps(q, k, v, B, want):
    """Two bf16 ulps of the terms of each output: of the output itself (its
    rounding) and of sum_j p_j |v_j| / sum_j p_j (a probability whose
    score, summed in another order, rounds to the neighbouring bf16)."""
    mag = attention_plain(q, k, v.abs(), B).float()
    return 2.0 ** -7 * (want.abs() + mag) + 1e-6


@pytest.mark.parametrize("L", [1, 5, 127, 129, 130, 257, 641])
def test_emulated_kernel_matches_plain_route(L):
    """The CUDA source's device code, built for the CPU against
    csrc/host_emu.h, on ragged lengths, against the plain route: both
    round the probabilities to bf16 against the same running max, in
    blocks of 128 keys; the scores and row sums are summed in other
    orders (`_ulps`). The lengths straddle the kernel's 128-row query and
    128-key tiles; 641 takes six key tiles through the four-stage ring,
    so its stages are handed back and refilled."""
    lib = _build.load_host_emulation()
    g = torch.Generator().manual_seed(L)
    B, H = 2, 2
    q, k, v = (torch.randn(B * H, L, 64, generator=g).bfloat16()
               for _ in range(3))
    out = torch.empty(B, L, H * 64, dtype=torch.bfloat16)
    assert lib.vf_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B * H, L, H, 64,
                             ctypes.c_float(math.log2(math.e) / 8)) == 0
    want = attention_plain(q, k, v, B).float()
    assert bool(((out.float() - want).abs() <= _ulps(q, k, v, B, want))
                .all())
    assert rel(out, want) <= KERNEL_RMS


def test_attention_ablation_variants_apply():
    """Each variant of vggsfm_tpu_torch/tools/ablate_attn.py (the attention
    kernel with one part changed, timed on the card) finds its text in
    flash_attn.cuh exactly once, and changes it."""
    from vggsfm_tpu_torch.tools import ablate_attn

    with open(os.path.join(_build.CSRC, "flash_attn.cuh")) as f:
        base = f.read()
    for name, subs in ablate_attn.VARIANTS.items():
        assert (ablate_attn.variant_source(base, subs) == base) == (not subs)


def test_rope2d_is_the_explicit_rotation():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 7, 64, generator=g)
    pos = torch.randint(0, 38, (1, 7, 2), generator=g)
    got = RotaryPositionEmbedding2D(100.0)(x, pos)
    want = x.clone()
    for h in range(2):  # first half: the row; second half: the column
        for kk in range(16):
            a = pos[0, :, h].double() * 100.0 ** (-2 * kk / 32)
            i, j = 32 * h + kk, 32 * h + 16 + kk
            xi, xj = x[..., i].double(), x[..., j].double()
            want[..., i] = (xi * a.cos() - xj * a.sin()).float()
            want[..., j] = (xj * a.cos() + xi * a.sin()).float()
    assert float((got - want).abs().max()) < 1e-5
    assert torch.allclose(ref.rope_2d(x, pos), got, atol=1e-5)


def test_global_blocks_mix_frames_and_frame_blocks_do_not(models):
    port, _, images = models
    agg = port.aggregator
    agg.taps = (0,)
    try:
        moved = images.clone()
        moved[2] = 1.0 - moved[2]
        with torch.no_grad():
            a, b = agg(images)[0], agg(moved)[0]
    finally:
        agg.taps = TINY["taps"]
    C = a.shape[-1] // 2
    assert torch.equal(a[0, :, :C], b[0, :, :C])  # frame block: frame 0
    assert float((a[0, :, C:] - b[0, :, C:]).abs().max()) > 1e-3


def test_state_dicts_match_and_load_both_ways(models):
    port, reference, _ = models
    assert set(port.state_dict()) == set(reference.state_dict())
    fresh = VGGT(**TINY, dtype=torch.float32)
    fresh.load_state_dict(reference.state_dict(), strict=True)
    ref.VGGT(**TINY).load_state_dict(port.state_dict(), strict=True)
    keys = set(port.state_dict())
    assert "aggregator.frame_blocks.1.attn.q_norm.weight" in keys
    assert "camera_head.poseLN_modulation.1.weight" in keys
    assert "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight" \
        not in keys
    assert not any(k.startswith(("point_head", "track_head")) for k in keys)


def test_benchmark_copy_of_the_reference_is_identical():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "vggt_reference.py"),
                       os.path.join(ROOT, "benchmark", "reference",
                                    "vggt.py"), shallow=False)


def test_cli_writes_a_colmap_model(tmp_path, capsys, monkeypatch):
    from PIL import Image

    from vggsfm_tpu_torch import vggt, vggt_demo
    from vggsfm_tpu_torch.io.colmap import read_model

    # the tiny model in place of the published one the CLI builds
    monkeypatch.setattr(vggt, "VGGTConfig", functools.partial(
        vggt.VGGTConfig, img_size=56, model=TINY))

    scene = tmp_path / "scene" / "images"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (56, 70, 3), np.uint8)).save(
            scene / f"f{i}.png")
    out = tmp_path / "out"
    preds = vggt_demo.main([str(scene.parent), "--output", str(out),
                            "--device", "cpu", "--conf-thres", "1.5"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = read_model(str(out / "sparse"))
    assert summary["frames"] == 3 and len(rec.images) == 3
    assert summary["points"] == len(rec.points3D) > 0
    assert {c.model for c in rec.cameras.values()} == {"PINHOLE"}
    assert {c.width for c in rec.cameras.values()} == {70}
    assert sorted(im.name for im in rec.images.values()) == \
        ["f0.png", "f1.png", "f2.png"]
    n_obs = sum(len(im.point3D_ids) for im in rec.images.values())
    assert n_obs == summary["points"]
    p = rec.points3D[0]
    assert np.allclose(p.xyz, preds["points3d"][0].double().numpy())


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L", [(2, 16, 1374), (1, 1, 65952),
                                   (1, 16, 65952), (1, 2, 1), (3, 1, 63),
                                   (1, 3, 65), (2, 2, 1000), (1, 2, 127),
                                   (1, 2, 129), (2, 3, 257)])
def test_kernel_matches_plain_route(cuda, B, H, L):
    g = torch.Generator(device=cuda).manual_seed(L)
    q, k, v = (torch.randn(B * H, L, 64, generator=g, device=cuda)
               .bfloat16() for _ in range(3))
    got = flash_attention(q, k, v, B)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, B)
    assert got.shape == (B, L, H * 64) and got.dtype == torch.bfloat16
    want = want.float()
    assert bool(((got.float() - want).abs() <= _ulps(q, k, v, B, want))
                .all())
    assert rel(got, want) <= KERNEL_RMS
