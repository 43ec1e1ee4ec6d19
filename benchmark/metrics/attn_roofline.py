"""The long-sequence attention kernel (ops/attention.py flash_attention)
as a share of its roofline, in %: the larger of its tensor-core, exponent
and memory bounds (benchmark/families/vggt/kernels.py) over its device
time."""

from benchmark.metrics._roofline import share


def read(rec: dict) -> float | None:
    return share(rec, "attn")
