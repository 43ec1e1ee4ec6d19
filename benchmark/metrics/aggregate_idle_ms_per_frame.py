"""Milliseconds per frame of the profiled unit in which the device ran
nothing inside VGGT's aggregator stage (the program's trace)."""

from benchmark.metrics._program import per_frame


def read(rec: dict) -> float | None:
    return per_frame(rec, "aggregator", "idle_s", 1e3)
