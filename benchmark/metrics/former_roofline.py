"""The fused former kernels (fused_transformer_block, fused_ln_mlp,
fused_ln_attn) as a share of their roofline, in %."""

from benchmark.metrics._roofline import share


def read(rec: dict) -> float | None:
    return share(rec, "former")
