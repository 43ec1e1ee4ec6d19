"""The share of the window's host time that a layer's stages took, from
the program's own stage timings (each stage ends in a device
synchronize), per frame."""


def ms_per_frame(rec: dict, layer: str) -> float | None:
    """Milliseconds per frame of `layer`: the sum over the window's scenes
    of the timing keys the configuration lists for it (a key with a
    leading '-' is subtracted), over the window's frames."""
    keys = rec["config"]["timings"].get(layer)
    if not keys:
        return None
    total = 0.0
    for s in rec["scenes"]:
        for k in keys:
            sign, name = (-1.0, k[1:]) if k.startswith("-") else (1.0, k)
            total += sign * s["timings"].get(name, 0.0)
    frames = sum(s["frames"] for s in rec["scenes"])
    return 1e3 * total / frames
