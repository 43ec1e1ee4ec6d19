"""The port's kernels on a CUDA GPU against their plain versions.

Marked `cuda`: skipped without a GPU. Imports nothing of JAX, so it runs
on a machine with only the port's dependencies (tests/conftest.py imports
JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states and justifies them, element by
element: f32 1e-4 absolute (sums in another order); bf16 2 ulp of |ref|
(the two sides' final roundings) plus 2^-5 (rounding flips of the
intermediates). The correlation kernel returns f32 sums of exact
products, from f32 and from bf16 maps alike: 1e-4 absolute for both.
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
    """(8, 112, 384): the few-track path's 896 rows (14 blocks)."""
    M = 4 * C
    x = _w(gen, tracks * L, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in (
        (3 * C, C), (3 * C,), (C, C), (C,), (M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_transformer_block"]
    out = fm.fused_transformer_block(x, *ws, L, 8)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_transformer_block"] == n0 + 1
    ref = fm.fused_transformer_block_ref(x, *ws, L, 8)
    _assert_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(32768, 384), (37, 256), (32312, 768),
                                 (45, 768), (896, 384)])
def test_ln_mlp_kernel_matches_plain(gen, dtype, R, C):
    """bf16 at C = 768: the wide path's three kernels (the camera's
    cross-attention tails at R = 32312)."""
    M = 4 * C
    x = _w(gen, R, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in ((M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_ln_mlp"]
    out = fm.fused_ln_mlp(x, *ws)
    torch.cuda.synchronize()
    wide = dtype == torch.bfloat16 and C > fm.MAX_C
    assert fm.launch_counts["fused_ln_mlp"] == n0 + (
        fm.WIDE_MLP_KERNELS if wide else 1)
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    C = 784  # wider than the widest register tile
    x = _w(gen, 16, C, dtype=torch.float32)
    ws = [_w(gen, *s, dtype=torch.float32)
          for s in ((4 * C, C), (4 * C,), (C, 4 * C), (C,))]
    with pytest.raises(ValueError):
        fm.fused_ln_mlp(x, *ws)
    with pytest.raises(TypeError):
        fm.fused_ln_mlp(x.half(), *ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,W,C,N,r", [
    (8, 128, 128, 128, 48, 4), (8, 8, 8, 128, 63, 4), (8, 31, 31, 32, 16, 3),
    (3, 31, 31, 32, 1, 3), (2, 12, 14, 33, 7, 1), (2, 9, 40, 20, 5, 7),
    (1, 16, 16, 256, 3, 2)])
def test_corr_kernel_matches_plain(gen, dtype, S, H, W, C, N, r):
    """Tracks inside, on and across every border and far outside; C = 33
    takes the element-by-element loads. bf16 maps only below C = 128."""
    if dtype == torch.bfloat16 and C >= tc.SMALL_C:
        with pytest.raises(TypeError):
            tc.corr_sample_kernel(
                torch.zeros(S, H, W, C, dtype=dtype, device="cuda"),
                torch.zeros(S, N, 2, device="cuda"),
                torch.zeros(S, N, C, dtype=dtype, device="cuda"), r)
        return
    fmap = torch.randn(S, H, W, C, generator=gen).to("cuda", dtype)
    coords = torch.rand(S, N, 2, generator=gen) * (W + 12) - 6
    edge = torch.tensor([[3.0, 4.0], [-0.0, 0.0], [-1.0, H - 1.0],
                         [W - 0.5, -0.25], [-300.0, 5.0], [7.0, 1e6]])
    coords[0, :min(N, 6)] = edge[:N]
    coords = coords.cuda()
    feats = torch.randn(S, N, C, generator=gen).to("cuda", dtype)
    name = ("corr_sample_pallas_smallc" if C < tc.SMALL_C
            else "corr_sample_pallas")
    n0 = dict(fm.launch_counts)
    out = tc.corr_sample_kernel(fmap, coords, feats, r)
    torch.cuda.synchronize()
    assert fm.launch_counts[name] == n0[name] + 1
    assert sum(fm.launch_counts.values()) == sum(n0.values()) + 1
    assert out.dtype == torch.float32 and out.shape == (S, N, (2 * r + 1) ** 2)
    ref = tc.corr_sample_plain(fmap, coords, feats, r)
    assert float((out - ref).abs().max()) <= 1e-4
    if N >= 5:
        assert not out[0, 4].any()  # the window far outside: zeros


def test_corr_sample_route_on_the_card(gen):
    """models/tracker.corr_sample with fewer than 64 tracks: one launch per
    pyramid level, bf16 maps cast up for C = 128 and kept for C = 32."""
    from vggsfm_tpu_torch.models import tracker as ttr

    for C, name in ((128, "corr_sample_pallas"),
                    (32, "corr_sample_pallas_smallc")):
        fmaps = torch.randn(1, 4, 32, 32, C, generator=gen).to(
            "cuda", torch.bfloat16)
        coords = (torch.rand(1, 4, 10, 2, generator=gen) * 40 - 4).cuda()
        feats = torch.randn(1, 4, 10, C, generator=gen).to(
            "cuda", torch.bfloat16)
        pyr = ttr.build_corr_pyramid(fmaps, 3)
        n0 = fm.launch_counts[name]
        out = ttr.corr_sample(pyr, coords, feats, 3)
        torch.cuda.synchronize()
        assert fm.launch_counts[name] == n0 + 3
        assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 10, 3 * 49)
        ref = ttr.corr_sample([p.cpu() for p in pyr], coords.cpu(),
                              feats.cpu(), 3)
        # both round the same f32 values (to ~1e-6) to bf16: one ulp of
        # O(1-8) outputs where a value sits on a rounding boundary
        assert float((out.float().cpu() - ref.float()).abs().max()) <= 0.0625
