"""Milliseconds per frame in VGGT's heads layer over the window (the
program's stage timings the configuration lists under `heads`: the camera
head, the depth head and the points)."""

from benchmark.metrics._timings import ms_per_frame


def read(rec: dict) -> float | None:
    return ms_per_frame(rec, "heads")
