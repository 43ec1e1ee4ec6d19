"""The fused former kernels on a CUDA GPU against their plain versions.

Marked `cuda`: skipped without a GPU. Imports nothing of JAX, so it runs
on a machine with only the port's dependencies (tests/conftest.py imports
JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states them: f32 1e-4 absolute (sums in
another order), bf16 2 ulp of the O(1-5) outputs (0.0625).
"""

import pytest
import torch

from vggsfm_tpu_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.0625}


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
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(32768, 384), (37, 256)])
def test_ln_mlp_kernel_matches_plain(gen, dtype, R, C):
    M = 4 * C
    x = _w(gen, R, C, dtype=dtype, scale=1.5)
    ws = [_w(gen, *s, dtype=dtype) for s in ((M, C), (M,), (C, M), (C,))]
    n0 = fm.launch_counts["fused_ln_mlp"]
    out = fm.fused_ln_mlp(x, *ws)
    torch.cuda.synchronize()
    assert fm.launch_counts["fused_ln_mlp"] == n0 + 1
    ref = fm.fused_ln_mlp_ref(x, *ws)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    C = 400  # wider than the register tile
    x = _w(gen, 16, C, dtype=torch.float32)
    ws = [_w(gen, *s, dtype=torch.float32)
          for s in ((4 * C, C), (4 * C,), (C, 4 * C), (C,))]
    with pytest.raises(ValueError):
        fm.fused_ln_mlp(x, *ws)
    with pytest.raises(TypeError):
        fm.fused_ln_mlp(x.half(), *ws)
