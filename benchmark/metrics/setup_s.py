"""Set-up: process start to the first timed scene (the kernels' build or
cache lookup, the weights, the scenes, the warm-up), host clock."""


def read(rec: dict) -> float:
    return rec["setup_s"]
