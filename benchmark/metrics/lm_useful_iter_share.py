"""The share of the LM iterations the profiled unit ran that began before
the solver's `done` flag was set, in %: the program's ``ba.iters_useful``
over ``ba.iters_run``, every dense and sparse LM call summed (the rest
ran only until the host's next read of the flag)."""

from benchmark.harness import program_trace


def read(rec: dict) -> float | None:
    p = program_trace.read(rec)
    if p is None or not p["counters"].get("ba.iters_run"):
        return None
    c = p["counters"]
    return 100.0 * c.get("ba.iters_useful", 0.0) / c["ba.iters_run"]
