"""Megabytes (1e6) per frame of the profiled unit written by the models'
casts of their weights at use inside the tracker's stages: the program's
``weights.cast_bytes`` counter."""

from benchmark.metrics._program import per_frame


def read(rec: dict) -> float | None:
    return per_frame(rec, "tracker", "cast_bytes", 1e-6)
