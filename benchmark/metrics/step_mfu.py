"""The window's model FLOPs (the benchmark's own count over the float32
reference at the shapes the window ran) over the window's seconds times
the dense bf16 peak, in %."""

from benchmark.harness.work import STEP_PEAK_FLOPS


def read(rec: dict) -> float | None:
    flops = rec.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (rec["window_s"] * STEP_PEAK_FLOPS)
