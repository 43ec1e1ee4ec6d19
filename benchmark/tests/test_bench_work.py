"""The frozen work formulas against the port's FLOP formulas, and the
correlation's counted cells against a direct count."""

import pytest
import torch

from benchmark.harness import work
from vggsfm_tpu_torch.ops import corr, fused_mlp


@pytest.mark.parametrize("R,L,C,M", [(33280, 8, 384, 1536),
                                     (512, 64, 384, 1536),
                                     (64, 8, 768, 3072)])
def test_former_flops_match_the_port(R, L, C, M):
    assert work.block_work(R, L, C, M, 2)[0] == fused_mlp.block_flops(
        R, C, M, L)
    assert work.mlp_work(R, C, M, 2)[0] == fused_mlp.ln_mlp_flops(R, C, M)
    assert work.attn_work(R, L, C, 2)[0] == fused_mlp.ln_attn_flops(R, C, L)


def test_corr_work_counts_each_cell_once():
    g = torch.Generator().manual_seed(0)
    F, N, C, r = 2, 5, 8, 1
    levels = [(F, 12, 10, C), (F, 6, 5, C)]
    coords = torch.rand(F, N, 2, generator=g) * 9
    flops, nbytes = work.corr_work(levels, coords, r, C, 2, 4)
    cells = 0
    for i, (_, H, W, _) in enumerate(levels):
        for f in range(F):
            seen = set()
            for n in range(N):
                x0, y0 = (coords[f, n] / 2 ** i).floor().long().tolist()
                for y in range(y0 - r, y0 + r + 2):
                    for x in range(x0 - r, x0 + r + 2):
                        if 0 <= x < W and 0 <= y < H:
                            seen.add((y, x))
            cells += len(seen)
    taps = len(levels) * (2 * r + 1) ** 2
    assert nbytes == cells * C * 2 + F * N * (C * 2 + 8 + taps * 4)
    # the products the port's formula counts are the upper bound of the
    # in-map ones counted here
    assert flops - 8 * F * N * taps <= corr.corr_flops(F, N, C, r,
                                                       len(levels))


def test_bound_takes_the_larger_of_the_two_limits():
    s = dict(R=64, L=8, C=768, tsize=4, dtype="torch.float32")
    flops, nbytes = work.attn_work(64, 8, 768, 4)
    assert work.bound_s("attn", s) == max(
        flops / work.PEAK_FLOPS["torch.float32"],
        nbytes / work.HBM_BYTES_PER_S)
