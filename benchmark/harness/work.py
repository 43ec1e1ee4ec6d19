"""The table of peaks a kernel's work is held against: the published
peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).

A kernel's roofline share is its bound over its device time: the larger of
its operations over the peak rate and its bytes over the memory rate. Each
family gives, for each kind of kernel it registers (its `KERNELS`), the
bound of one call from the call's shapes; the VGGSfM family's frozen
formulas are in benchmark/families/vggsfm/kernels.py.
"""

from __future__ import annotations

PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the step's share of the chip: the dense bf16 rate
STEP_PEAK_FLOPS = 989e12

# the VGGSfM family's work formulas, importable from here as before
_MOVED = ("block_work", "mlp_work", "attn_work", "window_index",
          "corr_work", "bound_s")


def __getattr__(name):
    if name in _MOVED:
        from benchmark.families.vggsfm import kernels
        return getattr(kernels, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
