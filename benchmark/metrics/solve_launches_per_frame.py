"""Kernel launch calls inside the solve's stages, per frame of the
profiled unit (the program's trace)."""

from benchmark.metrics._program import per_frame


def read(rec: dict) -> float | None:
    return per_frame(rec, "solve", "launches")
