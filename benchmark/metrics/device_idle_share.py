"""The share of the profiled scene's host time in which no operation ran
on the device, in %."""


def read(rec: dict) -> float | None:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
