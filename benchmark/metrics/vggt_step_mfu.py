"""VGGT's window model FLOPs (the benchmark's own count over the float32
reference at the shapes the window ran: aggregator, camera head, depth
head) over the window's seconds times the dense bf16 peak, in %; as
`step_mfu` reads the VGGSfM cells."""

from benchmark.metrics.step_mfu import read  # noqa: F401
