"""The share of the LM iterations the profiled unit ran that were replayed
from a CUDA graph, in %: the program's ``ba.iters_graphed`` over
``ba.iters_run``, every dense and sparse LM call summed (each call runs
its first iteration eagerly). Nothing to read where the program does not
count ``ba.iters_graphed``."""

from benchmark.harness import program_trace


def read(rec: dict) -> float | None:
    p = program_trace.read(rec)
    if p is None or not p["counters"].get("ba.iters_run") \
            or "ba.iters_graphed" not in p["counters"]:
        return None
    c = p["counters"]
    return 100.0 * c["ba.iters_graphed"] / c["ba.iters_run"]
