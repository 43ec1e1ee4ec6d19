"""Milliseconds per frame in VGGT's aggregator layer over the window (the
program's stage timings the configuration lists under `aggregator`)."""

from benchmark.metrics._timings import ms_per_frame


def read(rec: dict) -> float | None:
    return ms_per_frame(rec, "aggregator")
