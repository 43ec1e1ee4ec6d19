"""The port's fused former ops against the JAX package's Pallas kernels.

* The plain PyTorch versions (`fused_transformer_block_ref`,
  `fused_ln_mlp_ref`; `fused_ln_attn_ref` in test_torch_camera.py) against `vggsfm_tpu.ops.fused_mlp`'s kernels run in
  interpret mode on the CPU, on the same numpy inputs (weights transposed
  to torch's (out, in) layout). f32 tolerance 5e-5 absolute: the two sides
  sum in different orders and the Pallas kernel's rational erf is within
  1.5e-7 of erf; activations are O(1) after the LayerNorms.
* The CUDA source's device code, built for the CPU against
  csrc/host_emu.h, against the plain versions: the same arithmetic,
  indexing and barriers as on the card. f32 within 2e-5 (summation
  order); bf16 within one bf16 ulp of the O(1-4) outputs (0.03125), as a
  different summation order may round the other way. The block kernel
  and ln_mlp at C <= 384 run the ring path (cp.async weight ring,
  ldmatrix, mma.sync), ln_mlp above C = 384 the wide path (LayerNorm
  pass, two mma.sync GEMMs on a cp.async ring), both in bf16 with the
  head width and hidden size multiples of 16; ln_mlp in f32 the LayerNorm
  pass and two CUDA-core GEMMs. The block kernel rejects f32, both reject
  the shapes the tiles do not divide, and the layers run those on the
  attention half's kernels or plain. fused_ln_attn runs its four kernels
  (LayerNorm pass, two CUDA-core GEMMs on a cp.async ring, attention
  core) in f32 and bf16; host_emu.h emulates the warp-level PTX lane by
  lane; one warp of it is also checked against a numpy product.
* The wrappers' device rule: CPU tensors take the plain version and
  count no launch. The kernels themselves on the card:
  tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from vggsfm_tpu.ops import fused_mlp as jfm
from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.ops import fused_mlp as tfm


def _mk(rng, *shape, scale=0.05):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _block_params(rng, C, M):
    """JAX-layout (in, out) weights."""
    return [_mk(rng, C, 3 * C), _mk(rng, 3 * C), _mk(rng, C, C),
            _mk(rng, C), _mk(rng, C, M), _mk(rng, M), _mk(rng, M, C),
            _mk(rng, C)]


def _torch_layout(params):
    return [torch.from_numpy(np.ascontiguousarray(p.T if p.ndim == 2 else p))
            for p in params]


@pytest.mark.parametrize("L,tracks,C,H", [(8, 24, 128, 8), (9, 13, 128, 8),
                                          (64, 3, 128, 4), (25, 4, 256, 8)])
def test_block_plain_matches_pallas(rng, L, tracks, C, H):
    M = 4 * C
    x = _mk(rng, tracks * L, C) * 20
    params = _block_params(rng, C, M)
    ref = jfm.fused_transformer_block(x, *params, L, H, interpret=True)
    out = tfm.fused_transformer_block_ref(torch.from_numpy(x),
                                          *_torch_layout(params), L, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("R,C,M", [(1000, 384, 1536), (37, 128, 512),
                                   (40, 768, 3072)])
def test_ln_mlp_plain_matches_pallas(rng, R, C, M):
    """(40, 768, 3072): the camera's cross-attention tail width."""
    x = _mk(rng, R, C) * 20  # ragged R -> the kernel's padding path
    w1, b1, w2, b2 = _mk(rng, C, M), _mk(rng, M), _mk(rng, M, C), _mk(rng, C)
    ref = jfm.fused_ln_mlp(x, w1, b1, w2, b2, interpret=True)
    out = tfm.fused_ln_mlp_ref(torch.from_numpy(x),
                               *_torch_layout([w1, b1, w2, b2]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


def test_wrappers_take_plain_version_on_cpu(rng):
    tfm.reset_launch_counts()
    C, M, L = 64, 256, 8
    x = torch.from_numpy(_mk(rng, 4 * L, C) * 20)
    params = _torch_layout(_block_params(rng, C, M))
    out = tfm.fused_transformer_block(x, *params, L, 4)
    ref = tfm.fused_transformer_block_ref(x, *params, L, 4)
    assert torch.equal(out, ref)
    mlp = params[4:]
    assert torch.equal(tfm.fused_ln_mlp(x, *mlp),
                       tfm.fused_ln_mlp_ref(x, *mlp))
    w_in, b_in, w_out, b_out = params[:4]
    assert torch.equal(tfm.fused_ln_attn(x, w_in, b_in, w_out, b_out, L, 4),
                       tfm.fused_ln_attn_ref(x, w_in, b_in, w_out, b_out, L,
                                             4))
    assert set(tfm.launch_counts) >= {"fused_transformer_block",
                                      "fused_ln_mlp", "fused_ln_attn"}
    assert not any(tfm.launch_counts.values())


# ------------------------------------------------ the CUDA source on the CPU

_DT = {torch.float32: 0, torch.bfloat16: 1}


@pytest.fixture(scope="module")
def emu():
    try:
        return _build.load_host_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))


def _emu_block(lib, x, params, L, H):
    out = torch.empty_like(x)
    R, C = x.shape
    rc = lib.vf_fused_block(_DT[x.dtype], x.data_ptr(),
                            *[p.data_ptr() for p in params], out.data_ptr(),
                            R, C, params[4].shape[0], L, H)
    assert rc == 0
    return out


@pytest.mark.parametrize("L,tracks,C,H", [(8, 17, 64, 4), (9, 7, 48, 3),
                                          (64, 2, 64, 2), (1, 70, 32, 2)])
def test_emulated_block_kernel_matches_plain(rng, emu, L, tracks, C, H):
    """bf16 on the ring path: head widths 16 and 32, one- to eight-track
    blocks (L = 64 down to 8), 63-row blocks (L = 9), L = 1."""
    bf = torch.bfloat16
    x = torch.from_numpy(_mk(rng, tracks * L, C) * 20).to(bf)
    params = [p.to(bf) for p in _torch_layout(_block_params(rng, C, 4 * C))]
    out = _emu_block(emu, x, params, L, H)
    ref = tfm.fused_transformer_block_ref(x, *params, L, H)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=0.03125)


def _emu_ln_mlp(lib, x, w1, b1, w2, b2):
    """The kernels' ln_mlp with the three-kernel path's scratch where it
    takes it (as the wrapper allocates it)."""
    R, C = x.shape
    M = w1.shape[0]
    out = torch.empty_like(x)
    nbytes = lib.vf_ln_mlp_scratch_bytes(_DT[x.dtype], R, C, M)
    scratch = torch.empty(nbytes, dtype=torch.uint8)
    rc = lib.vf_fused_ln_mlp(_DT[x.dtype], x.data_ptr(), w1.data_ptr(),
                             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                             out.data_ptr(),
                             scratch.data_ptr() if nbytes else None, R, C, M)
    assert rc == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,M", [(130, 64, 256), (40, 768, 64),
                                   (3, 400, 96), (130, 768, 256)])
def test_emulated_ln_mlp_kernel_matches_plain(rng, emu, dtype, R, C, M):
    """bf16: at C = 64 the ring path (a 2-row last tile), above C = 384
    the wide path: at (130, 768, 256) two 128-row tiles (the second 2
    rows), two fc1 column tiles, 24 slabs of fc1 and 8 of fc2 through the
    4-stage ring, at (3, 400, 96) a 16-deep last slab and ragged
    columns. f32: the LayerNorm pass and two CUDA-core GEMMs at every
    width, with a last slab shorter than 64 values at M = 96."""
    x = torch.from_numpy(_mk(rng, R, C) * 20).to(dtype)
    w1, b1, w2, b2 = [torch.from_numpy(a).to(dtype) for a in (
        _mk(rng, M, C), _mk(rng, M), _mk(rng, C, M), _mk(rng, C))]
    out = _emu_ln_mlp(emu, x, w1, b1, w2, b2)
    ref = tfm.fused_ln_mlp_ref(x, w1, b1, w2, b2)
    tol = 2e-5 if dtype == torch.float32 else 0.03125
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=tol)


# (kind, dtype, shape): what the block and ln_mlp kernels reject: the
# block in f32 at any shape, either with a head width (8) or a hidden size
# (100) that the 16-wide tiles do not divide; shapes are (L, tracks, C, H)
# for the block, (R, C, M) for ln_mlp
_PLAIN = [("block", torch.float32, s) for s in (
    (8, 17, 64, 4), (9, 7, 48, 3), (64, 2, 64, 2), (1, 70, 32, 2),
    (8, 5, 48, 6))] + [("block", torch.bfloat16, (8, 5, 48, 6))] + [
    ("mlp", dt, (5, 48, 100)) for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("kind,dtype,shape", _PLAIN, ids=[
    f"{k}-{str(d)[6:]}-" + "-".join(map(str, s)) for k, d, s in _PLAIN])
def test_kernels_reject_what_runs_plain(rng, emu, kind, dtype, shape):
    """The emulated C entry returns its reject code (-8: tiles that do not
    divide, checked with the shape; else -100: not bf16), the route
    predicate says no, and on the CPU the layer gives the plain function:
    AttnBlock its two halves' plain versions, Mlp's tail
    `fused_ln_mlp_ref`."""
    from vggsfm_tpu_torch.models import layers as tlay

    if kind == "block":
        L, tracks, C, H = shape
        M = 4 * C
        code = -8 if (C // H) % 16 else -100
        x = torch.from_numpy(_mk(rng, tracks * L, C) * 20).to(dtype)
        params = [p.to(dtype) for p in _torch_layout(
            _block_params(rng, C, M))]
        out = torch.empty_like(x)
        assert emu.vf_fused_block(_DT[dtype], x.data_ptr(),
                                  *[p.data_ptr() for p in params],
                                  out.data_ptr(), tracks * L, C, M, L,
                                  H) == code
        assert not tfm.block_route_takes(dtype, C, L, H, M)
        blk = tlay.AttnBlock(C, H, dtype=dtype)
        with torch.no_grad():
            for p, v in zip((blk.attn.in_proj_weight, blk.attn.in_proj_bias,
                             blk.attn.out_proj.weight, blk.attn.out_proj.bias,
                             blk.mlp.fc1.weight, blk.mlp.fc1.bias,
                             blk.mlp.fc2.weight, blk.mlp.fc2.bias), params):
                p.copy_(v.float())
        got = blk(x.view(tracks, L, C)).reshape(tracks * L, C)
        half = tfm.fused_ln_attn_ref(x, *params[:4], L, H)
        assert torch.equal(got, tfm.fused_ln_mlp_ref(half, *params[4:]))
    else:
        R, C, M = shape
        code = -8 if M % 16 else -100
        x = torch.from_numpy(_mk(rng, R, C) * 20).to(dtype)
        ws = [torch.from_numpy(a).to(dtype) for a in (
            _mk(rng, M, C), _mk(rng, M), _mk(rng, C, M), _mk(rng, C))]
        out = torch.empty_like(x)
        scratch = torch.empty(R * (C + M) * 2, dtype=torch.uint8)
        assert emu.vf_fused_ln_mlp(_DT[dtype], x.data_ptr(),
                                   *[w.data_ptr() for w in ws],
                                   out.data_ptr(), scratch.data_ptr(), R, C,
                                   M) == code
        assert not tfm.mlp_route_takes(dtype, C, M)
        mlp = tlay.Mlp(C, M, C, dtype=dtype)
        with torch.no_grad():
            for p, v in zip((mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                             mlp.fc2.bias), ws):
                p.copy_(v.float())
        assert torch.equal(mlp(x, ln_residual=True),
                           tfm.fused_ln_mlp_ref(x, *ws))


def test_ln_mlp_kernel_count_and_scratch(emu):
    """The three-kernel path (WIDE_MLP_KERNELS launches per call, xn and h
    as scratch of the working dtype) in bf16 above C = 384 and in f32 at
    every width; one kernel and no scratch in bf16 at C <= 384."""
    for dt in (torch.float32, torch.bfloat16):
        for C, M in ((768, 3072), (400, 96), (384, 1536), (64, 256)):
            split = dt == torch.float32 or C > 384
            assert emu.vf_ln_mlp_kernels(_DT[dt], C) == (
                tfm.WIDE_MLP_KERNELS if split else 1)
            assert emu.vf_ln_mlp_scratch_bytes(_DT[dt], 10, C, M) == (
                10 * (C + M) * dt.itemsize if split else 0)
    assert tfm.WIDE_MLP_KERNELS == 3


@pytest.mark.parametrize("L,tracks,C,H", [(8, 17, 128, 4), (9, 15, 96, 2)])
def test_emulated_ring_block_matches_plain(rng, emu, L, tracks, C, H):
    """The ring path with several slabs per product, every ring stage
    reused, four / three 128-wide hidden chunks, a ragged last tile (L = 9:
    63-row blocks, the last one 9 rows) and, at C = 96, warps that hold no
    x1 column tile."""
    x = torch.from_numpy(_mk(rng, tracks * L, C) * 20).to(torch.bfloat16)
    params = [p.to(torch.bfloat16) for p in _torch_layout(
        _block_params(rng, C, 4 * C))]
    out = _emu_block(emu, x, params, L, H)
    ref = tfm.fused_transformer_block_ref(x, *params, L, H)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=0.03125)


def test_emulated_ring_ln_mlp_matches_plain(rng, emu):
    """ln_mlp on the ring path: 130 rows (a 2-row last tile), four hidden
    chunks."""
    R, C, M = 130, 128, 512
    x = torch.from_numpy(_mk(rng, R, C) * 20).to(torch.bfloat16)
    w1, b1, w2, b2 = [torch.from_numpy(a).to(torch.bfloat16) for a in (
        _mk(rng, M, C), _mk(rng, M), _mk(rng, C, M), _mk(rng, C))]
    out = _emu_ln_mlp(emu, x, w1, b1, w2, b2)
    ref = tfm.fused_ln_mlp_ref(x, w1, b1, w2, b2)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=0.03125)


def test_emulated_warp_mma_matches_numpy(rng, emu):
    """cp.async, ldmatrix (.x4 and .x2) and mma.sync m16n8k16 of one warp
    against a numpy product of the same bf16 values: products of bf16 are
    exact in f32, the 32-term f32 sums within 1e-5 of the f64 ones."""
    a = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32)).to(
        torch.bfloat16)
    d = torch.empty(16, 16)
    d8 = torch.empty(16, 8)
    fn = emu.vf_emu_warp_mma
    fn.argtypes = [ctypes.c_void_p] * 4
    assert fn(a.data_ptr(), w.data_ptr(), d.data_ptr(), d8.data_ptr()) == 0
    ref = a.double().numpy() @ w.double().numpy().T
    np.testing.assert_allclose(d.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(d8, d[:, 8:])


def test_ring_ablation_variants_apply():
    """Each variant of vggsfm_tpu_torch/tools/ablate_ring.py (the ring
    path with one part changed, timed on the card) still finds its text in
    fused_former.cuh exactly once, and changes it."""
    from vggsfm_tpu_torch.tools import ablate_ring

    with open(f"{_build.CSRC}/fused_former.cuh") as f:
        base = f.read()
    for name, subs in ablate_ring.VARIANTS.items():
        assert (ablate_ring.variant_source(base, subs) == base) == (not subs)


def test_camera_ablation_variants_apply():
    """Each variant of vggsfm_tpu_torch/tools/ablate_camera.py (the wide
    MLP path and the attention half with one design choice changed, timed
    on the card) finds its text in fused_former.cuh exactly once."""
    from vggsfm_tpu_torch.tools import ablate_camera, ablate_ring

    with open(f"{_build.CSRC}/fused_former.cuh") as f:
        base = f.read()
    for name, subs in ablate_camera.VARIANTS.items():
        assert (ablate_ring.variant_source(base, subs) == base) == (not subs)


def test_emulated_kernel_rejects_shapes_it_does_not_take(emu):
    x = torch.zeros(10, 800)
    # ln_mlp: C > 768; the block: C > 384, then R not a multiple of L,
    # then L > 64
    assert emu.vf_fused_ln_mlp(0, *[x.data_ptr()] * 7, 10, 784, 8) == -2
    # the wide path without its scratch
    assert emu.vf_fused_ln_mlp(1, *[x.data_ptr()] * 6, None, 10, 768,
                               64) == -9
    assert emu.vf_fused_block(0, *[x.data_ptr()] * 10, 10, 400, 8, 2,
                              4) == -2
    assert emu.vf_fused_block(0, *[x.data_ptr()] * 10, 10, 64, 8, 3,
                              4) == -5
    assert emu.vf_fused_block(0, *[x.data_ptr()] * 10, 130, 64, 8, 65,
                              4) == -4
    # ln_attn: heads wider than 128, then groups longer than 64 rows
    assert emu.vf_fused_ln_attn(0, *[x.data_ptr()] * 7, 16, 512, 8,
                                2, 132) == -6
    assert emu.vf_fused_ln_attn(0, *[x.data_ptr()] * 7, 130, 64, 65,
                                4, 132) == -4


def _emu_attn(lib, x, params, L, H, sms):
    R, C = x.shape
    nbytes = lib.vf_attn_scratch_bytes(_DT[x.dtype], R, C)
    assert nbytes == R * C * x.element_size() * 5 + R * 8
    scratch = torch.empty(nbytes, dtype=torch.uint8)
    out = torch.empty_like(x)
    rc = lib.vf_fused_ln_attn(_DT[x.dtype], x.data_ptr(),
                              *[p.data_ptr() for p in params],
                              out.data_ptr(), scratch.data_ptr(), R, C, L, H,
                              sms)
    assert rc == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,tracks,C,H,bm,sms,tiles", [
    (8, 9, 192, 2, 16, 16, (41, 41)),
    (40, 3, 64, 4, 64, 1, (44, 44)),
    (9, 7, 48, 3, 16, 132, (11, 11)),
    (20, 3, 32, 2, 32, 1, (44, 41)),
    (33, 2, 32, 2, 64, 132, (11, 11)),
    (1, 20, 96, 12, 16, 4, (41, 41))])
def test_emulated_ln_attn_kernel_matches_plain(rng, emu, dtype, L, tracks,
                                               C, H, bm, sms, tiles):
    """The group length L picks the attention core's row tile of `bm` =
    16, 32 or 64 rows (the smallest holding a track), with ragged last
    blocks; head dims 96 (C = 192, 2 heads), 16, 8; the card's SM count
    `sms` picks the GEMM tiles (q|k|v, out-projection) as 10 RT + CT:
    64 x 64, 64 x 16 or 16 x 16, each with ragged rows or columns."""
    R = tracks * L
    assert (emu.vf_cc_tile(R, 3 * C, sms), emu.vf_cc_tile(R, C, sms)) == \
        tiles
    x = torch.from_numpy(_mk(rng, R, C) * 20).to(dtype)
    params = [p.to(dtype) for p in _torch_layout(
        _block_params(rng, C, 4 * C)[:4])]
    out = _emu_attn(emu, x, params, L, H, sms)
    ref = tfm.fused_ln_attn_ref(x, *params, L, H)
    tol = 2e-5 if dtype == torch.float32 else 0.03125
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=tol)


def test_attention_gemm_tiles_spread_over_the_card(emu):
    """At the camera trunk (R = 64, C = 768) on 132 SMs the q|k|v product
    runs 144 blocks of 64 x 16 and the out-projection 192 of 16 x 16; at
    R = 4096 both take 64 x 64 tiles."""
    assert emu.vf_cc_tile(64, 3 * 768, 132) == 41
    assert emu.vf_cc_tile(64, 768, 132) == 11
    assert emu.vf_cc_tile(4096, 3 * 768, 132) == 44
    assert emu.vf_cc_tile(4096, 768, 132) == 44
    assert emu.vf_cc_tile(72, 768, 132) == 11


def test_shared_memory_fits_a_hopper_block(emu):
    # 227 KB dynamic shared memory per block on sm_90
    for C, H in ((384, 8), (256, 8)):
        assert emu.vf_block_smem_bytes(C, H, 64) <= 232448
        assert emu.vf_ln_mlp_smem_bytes(C) <= 232448
    assert emu.vf_ln_mlp_smem_bytes(768) <= 232448
    for tsize in (2, 4):
        for H in (8, 6):  # head dims 96 and 128, the widest tile and L
            assert emu.vf_attn_smem_bytes(768, H, 64, tsize) <= 232448
    # the wide path's GEMM: 3 stages of 128 A rows and 128 W rows, 64 deep
    # padded to 72 (bf16)
    assert emu.vf_ln_mlp_smem_bytes(768) == 3 * 256 * 72 * 2
    # the attention half: its largest carve, the attention core's q|k|v,
    # scores and output at head dim 128 and L = 64 (f32), beside the GEMM's
    # ring of slabs of 272-byte rows: 2 stages of 128 rows (64 x 64 tile)
    core = 64 * 384 * 4 + 64 * 64 * 4 + 64 * 128 * 4
    gemm = 2 * 128 * 272
    assert emu.vf_attn_smem_bytes(768, 6, 64, 4) == max(core, gemm)
    assert emu.vf_attn_smem_bytes(768, 8, 8, 2) == gemm
    # the ring path's carve (16-divisible shapes): xa, three ring
    # stages of the widest product's rows x 40, statistics, the 64 x 32
    # partials, and the larger of one head's scratch and the GELU chunk; at
    # every width, head width and group length the block kernel takes
    for C in range(16, 385, 16):
        for H in range(1, C // 16 + 1):
            D = C // H
            if C % H or D % 16 or D > 64:
                continue
            rows = max(C, 3 * D, 128)
            common = 64 * (C + 8) * 2 + 3 * rows * 80 + 512 + 8192
            for L in (1, 8, 9, 64):
                head = (64 * 3 * D * 2 + -(-64 * L * 4 // 128) * 128
                        + 64 * (D + 8) * 2)
                want = common + max(head, 64 * 136 * 2)
                assert emu.vf_block_smem_bytes(C, H, L) == want
                assert want <= 232448
        assert emu.vf_ln_mlp_smem_bytes(C) == (
            64 * (C + 8) * 2 + 3 * max(C, 128) * 80 + 512 + 8192 + 64 * 136 * 2)
