"""A kernel group's share of its roofline over the profiled scene: the
summed least times of its calls (frozen work formulas against the
published peaks) over the summed device time of its ranges."""


def share(rec: dict, group: str) -> float | None:
    k = rec.get("trace", {}).get("kernels", {}).get(group)
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
