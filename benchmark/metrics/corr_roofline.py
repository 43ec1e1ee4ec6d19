"""The correlation sampling kernel as a share of its roofline, in %."""

from benchmark.metrics._roofline import share


def read(rec: dict) -> float | None:
    return share(rec, "corr")
