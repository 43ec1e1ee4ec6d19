"""Device operations (kernels, copies, sets) of the profiled scene per
frame."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t:
        return None
    return t["device_ops"] / t["frames"]
