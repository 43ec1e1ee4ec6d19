"""Milliseconds per frame in the tracker layer over the window (the program's
stage timings the configuration lists under `tracker`)."""

from benchmark.metrics._timings import ms_per_frame


def read(rec: dict) -> float | None:
    return ms_per_frame(rec, "tracker")
