"""The fused former kernels on a CUDA GPU against their plain versions.

Marked `cuda`: skipped without a GPU. Imports nothing of JAX, so it runs
on a machine with only the port's dependencies (tests/conftest.py imports
JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states and justifies them, element by
element: f32 1e-4 absolute (sums in another order); bf16 2 ulp of |ref|
(the two sides' final roundings) plus 2^-5 (rounding flips of the
intermediates).
"""

import pytest
import torch

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
                                        (9, 100, 256), (1, 77, 128)])
def test_block_kernel_matches_plain(gen, dtype, L, tracks, C):
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
                                 (45, 768)])
def test_ln_mlp_kernel_matches_plain(gen, dtype, R, C):
    M = 4 * C
    x = _w(gen, R, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in ((M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_ln_mlp"]
    out = fm.fused_ln_mlp(x, *ws)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_ln_mlp"] == n0 + 1
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
