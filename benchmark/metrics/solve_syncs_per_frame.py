"""The host's waits on the device inside the solve's stages, per frame of
the profiled unit: synchronize calls and blocking device-to-host copies
(the program's trace)."""

from benchmark.metrics._program import per_frame


def read(rec: dict) -> float | None:
    return per_frame(rec, "solve", "syncs")
