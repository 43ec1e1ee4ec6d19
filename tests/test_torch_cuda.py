"""The port's kernels on a CUDA GPU against their plain versions.

Marked `cuda`: skipped without a GPU. Imports nothing of JAX, so it runs
on a machine with only the port's dependencies (tests/conftest.py imports
JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states and justifies them, element by
element: f32 1e-4 absolute (sums in another order); bf16 2 ulp of |ref|
(the two sides' final roundings) plus 2^-5 (rounding flips of the
intermediates). The correlation kernel sums exact products in f32, from
f32 and from bf16 maps alike: 1e-4 absolute with f32 output, and with
bf16 output one rounding of the plain f32 result (half a bf16 ulp of it,
plus 1e-4).
"""

import pytest
import torch

from vggsfm_tpu_torch.ops import corr as tc
from vggsfm_tpu_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda


def _assert_close(out, ref):
    err = (out.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        bound = torch.full_like(err, 1e-4)
    else:
        _, e = torch.frexp(ref.float().abs())  # |ref| = m 2^e, m in [.5, 1)
        bound = 2 * torch.ldexp(torch.ones_like(err), e - 8) + 2.0 ** -5
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator().manual_seed(0)


def _w(gen, *shape, dtype, scale=0.05):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,tracks,C", [(8, 520, 384), (64, 8, 384),
                                        (9, 100, 256), (1, 77, 128),
                                        (8, 112, 384)])
def test_block_kernel_matches_plain(gen, dtype, L, tracks, C):
    """(8, 112, 384): the few-track path's 896 rows (14 blocks). The
    kernel takes bf16 only: f32 raises and launches nothing."""
    M = 4 * C
    x = _w(gen, tracks * L, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in (
        (3 * C, C), (3 * C,), (C, C), (C,), (M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_transformer_block"]
    if dtype == torch.float32:
        with pytest.raises(ValueError):
            fm.fused_transformer_block(x, *ws, L, 8)
        assert fm.launch_counts["fused_transformer_block"] == n0
        return
    out = fm.fused_transformer_block(x, *ws, L, 8)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_transformer_block"] == n0 + 1
    ref = fm.fused_transformer_block_ref(x, *ws, L, 8)
    _assert_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(32768, 384), (37, 256), (32312, 768),
                                 (45, 768), (896, 384)])
def test_ln_mlp_kernel_matches_plain(gen, dtype, R, C):
    """In bf16 at C = 768 the wide path's three kernels (the camera's
    cross-attention tails at R = 32312); in f32 three kernels at C <= 384
    (the LayerNorm pass, two CUDA-core GEMMs), while f32 rows wider than
    384 raise and launch nothing."""
    M = 4 * C
    x = _w(gen, R, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in ((M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_ln_mlp"]
    f32 = dtype == torch.float32
    if f32 and C > fm.MAX_C:
        with pytest.raises(ValueError):
            fm.fused_ln_mlp(x, *ws)
        assert fm.launch_counts["fused_ln_mlp"] == n0
        return
    out = fm.fused_ln_mlp(x, *ws)
    torch.cuda.synchronize()
    split = f32 or C > fm.MAX_C
    assert fm.launch_counts["fused_ln_mlp"] == n0 + (
        fm.WIDE_MLP_KERNELS if split else 1)
    ref = fm.fused_ln_mlp_ref(x, *ws)
    _assert_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,tracks,C,H", [(8, 8, 768, 8), (24, 3, 768, 8),
                                          (9, 8, 768, 8), (8, 256, 384, 8),
                                          (64, 2, 768, 8), (1, 77, 48, 3)])
def test_ln_attn_kernel_matches_plain(gen, dtype, L, tracks, C, H):
    """L picks the row tile: 16 rows (L = 1, 8, 9), 32 (L = 24), 64."""
    x = _w(gen, tracks * L, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in ((3 * C, C), (3 * C,), (C, C),
                                             (C,))]
    n0 = fm.launch_counts["fused_ln_attn"]
    out = fm.fused_ln_attn(x, *ws, L, H)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_ln_attn"] == n0 + fm.ATTN_KERNELS
    ref = fm.fused_ln_attn_ref(x, *ws, L, H)
    _assert_close(out, ref)


def test_f32_attn_block_matches_plain_block(gen):
    """An f32 AttnBlock at C = 384 (the tracker's width) runs its two
    halves: fused_ln_attn's kernels, then fused_ln_mlp's f32 kernels, and
    nothing else of the fused former ops; it matches the plain block on
    the same weights."""
    from vggsfm_tpu_torch.models.layers import AttnBlock

    L, tracks, C, H = 8, 64, 384, 8
    blk = AttnBlock(C, H).cuda()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(_w(gen, *p.shape, dtype=torch.float32))
    x = _w(gen, tracks, L, C, dtype=torch.float32, scale=1.5)
    n0 = dict(fm.launch_counts)
    out = blk(x)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_ln_attn"] == n0["fused_ln_attn"] + \
        fm.ATTN_KERNELS
    assert fm.launch_counts["fused_ln_mlp"] == n0["fused_ln_mlp"] + \
        fm.WIDE_MLP_KERNELS
    assert sum(fm.launch_counts.values()) == sum(n0.values()) + \
        fm.ATTN_KERNELS + fm.WIDE_MLP_KERNELS
    ref = fm.fused_transformer_block_ref(
        x.reshape(-1, C), *blk.attn.packed(), *blk.mlp.packed(), L, H)
    _assert_close(out.reshape(-1, C), ref)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    C = 784  # wider than the widest register tile
    x = _w(gen, 16, C, dtype=torch.float32)
    ws = [_w(gen, *s, dtype=torch.float32)
          for s in ((4 * C, C), (4 * C,), (C, 4 * C), (C,))]
    with pytest.raises(ValueError):
        fm.fused_ln_mlp(x, *ws)
    with pytest.raises(TypeError):
        fm.fused_ln_mlp(x.half(), *ws)


def _corr_close(out, ref):
    """ref: the plain version's f32 result."""
    err = (out.float() - ref).abs()
    if out.dtype == torch.float32:
        return float(err.max()) <= 1e-4
    _, e = torch.frexp(ref.abs())
    return bool((err <= torch.ldexp(torch.ones_like(ref), e - 9) + 1e-4)
                .all())


def _pyramid(gen, F, dims, C, dtype, flat):
    """NHWC maps, or (F, H, W, C) views of flat channel-first storage."""
    if flat:
        return [torch.randn(F, C, H * W, generator=gen).to("cuda", dtype)
                .view(F, C, H, W).permute(0, 2, 3, 1) for H, W in dims]
    return [torch.randn(F, H, W, C, generator=gen).to("cuda", dtype)
            for H, W in dims]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,W,C,N,r,L,flat", [
    (8, 128, 128, 128, 48, 4, 5, False), (8, 8, 8, 128, 63, 4, 1, False),
    (8, 31, 31, 32, 16, 3, 3, False), (3, 31, 31, 32, 1, 3, 3, False),
    (2, 12, 14, 33, 7, 1, 2, False), (2, 9, 40, 20, 5, 7, 1, False),
    (1, 16, 16, 256, 3, 2, 3, False), (2, 20, 24, 600, 70, 4, 2, False),
    (64, 31, 31, 32, 1, 3, 3, True), (4, 15, 15, 8, 3, 2, 2, True)])
def test_corr_kernel_matches_plain(gen, dtype, out_dtype, S, H, W, C, N, r,
                                   L, flat):
    """One launch over L levels (each half the last, down to 1 cell),
    NHWC or flat channel-first; tracks inside, on and across every border
    and far outside; C = 33 and C = 20 bf16 take the element loads, C =
    600 several channel chunks."""
    dims = [(max(1, H >> i), max(1, W >> i)) for i in range(L)]
    levels = _pyramid(gen, S, dims, C, dtype, flat)
    coords = torch.rand(S, N, 2, generator=gen) * (W + 12) - 6
    edge = torch.tensor([[3.0, 4.0], [-0.0, 0.0], [-1.0, H - 1.0],
                         [W - 0.5, -0.25], [-300.0, 5.0], [7.0, 1e6]])
    coords[0, :min(N, 6)] = edge[:N]
    coords = coords.cuda()
    feats = torch.randn(S, N, C, generator=gen).to("cuda", dtype)
    name = ("corr_sample_pallas_smallc" if C < tc.SMALL_C
            else "corr_sample_pallas")
    n0 = dict(fm.launch_counts)
    out = tc.corr_sample_kernel(levels, coords, feats, r, out_dtype)
    torch.cuda.synchronize()
    assert fm.launch_counts[name] == n0[name] + 1
    assert sum(fm.launch_counts.values()) == sum(n0.values()) + 1
    assert out.dtype == out_dtype
    assert out.shape == (S, N, L * (2 * r + 1) ** 2)
    ref = tc.corr_sample_plain(levels, coords, feats, r)
    assert _corr_close(out, ref)
    if N >= 5:
        assert not out[0, 4].any()  # the window far outside: zeros


@pytest.mark.parametrize("flat", [False, True], ids=["coarse", "fine"])
def test_corr_kernel_at_the_main_path_shapes(gen, flat):
    """The tracker's two calls per iteration: coarse, 8 frames x 4096
    tracks over 5 levels (128^2 .. 8^2), C = 128, r = 4; fine, 4096 x 8
    track-frames, each its own 31^2 patch pyramid (3 levels), C = 32,
    r = 3, flat channel-first. bf16 maps and output."""
    if flat:
        F, N, C, r, dims = 4096 * 8, 1, 32, 3, [(31, 31), (15, 15), (7, 7)]
        coords = torch.rand(F, N, 2, generator=gen) * 8 + 11.5
    else:
        F, N, C, r = 8, 4096, 128, 4
        dims = [(128 >> i, 128 >> i) for i in range(5)]
        coords = torch.rand(F, N, 2, generator=gen) * 136 - 4
    levels = _pyramid(gen, F, dims, C, torch.bfloat16, flat)
    coords = coords.cuda()
    feats = torch.randn(F, N, C, generator=gen).to("cuda", torch.bfloat16)
    out = tc.corr_sample_kernel(levels, coords, feats, r, torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (F, N, len(dims) * (2 * r + 1) ** 2)
    assert bool(torch.isfinite(out.float()).all())
    assert _corr_close(out, tc.corr_sample_plain(levels, coords, feats, r))


def test_corr_sample_route_on_the_card(gen):
    """models/tracker.corr_sample and corr_sample_flat: one launch per
    call over every level, bf16 maps read as they are, at 10 and at 70
    tracks."""
    from vggsfm_tpu_torch.models import tracker as ttr

    for C, N, name in ((128, 10, "corr_sample_pallas"),
                       (128, 70, "corr_sample_pallas"),
                       (32, 10, "corr_sample_pallas_smallc")):
        fmaps = torch.randn(1, 4, 32, 32, C, generator=gen).to(
            "cuda", torch.bfloat16)
        coords = (torch.rand(1, 4, N, 2, generator=gen) * 40 - 4).cuda()
        feats = torch.randn(1, 4, N, C, generator=gen).to(
            "cuda", torch.bfloat16)
        pyr = ttr.build_corr_pyramid(fmaps, 3)
        n0 = fm.launch_counts[name]
        out = ttr.corr_sample(pyr, coords, feats, 3)
        torch.cuda.synchronize()
        assert fm.launch_counts[name] == n0 + 1
        assert out.dtype == torch.bfloat16 and out.shape == (1, 4, N, 3 * 49)
        ref = ttr.corr_sample([p.cpu() for p in pyr], coords.cpu(),
                              feats.cpu(), 3)
        # both round the same f32 values (to ~1e-6) to bf16: one ulp of
        # O(1-8) outputs where a value sits on a rounding boundary
        assert float((out.float().cpu() - ref.float()).abs().max()) <= 0.0625
    x = torch.randn(6, 4, 32, 31 * 31, generator=gen).to("cuda",
                                                         torch.bfloat16)
    levels, hws = ttr.build_corr_pyramid_flat(x, (31, 31), 3)
    coords = (torch.rand(6, 4, 1, 2, generator=gen) * 31).cuda()
    feats = torch.randn(6, 4, 1, 32, generator=gen).to("cuda", torch.bfloat16)
    n0 = fm.launch_counts["corr_sample_pallas_smallc"]
    out = ttr.corr_sample_flat(levels, hws, coords, feats, 3)
    torch.cuda.synchronize()
    assert fm.launch_counts["corr_sample_pallas_smallc"] == n0 + 1
    ref = ttr.corr_sample_flat([lv.cpu() for lv in levels], hws,
                               coords.cpu(), feats.cpu(), 3)
    assert float((out.float().cpu() - ref.float()).abs().max()) <= 0.0625
