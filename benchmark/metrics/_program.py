"""What the program's own trace of the profiled unit reads for a layer
(`harness/program_trace.py`), per frame of the unit."""

from benchmark.harness import program_trace


def per_frame(rec: dict, layer: str, field: str,
              scale: float = 1.0) -> float | None:
    """`field` of `layer` in the program's trace, times `scale`, over the
    unit's frames; None where the run has no program trace."""
    p = program_trace.read(rec)
    if p is None:
        return None
    return scale * p["layers"][layer][field] / p["frames"]
