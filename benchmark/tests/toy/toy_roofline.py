"""The toy kernel as a share of its roofline, in %."""

from benchmark.metrics._roofline import share


def read(rec):
    return share(rec, "toy")
