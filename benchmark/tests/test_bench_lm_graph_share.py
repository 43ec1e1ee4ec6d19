"""The reader of `lm_graph_iter_share`: the program's ``ba.iters_graphed``
over ``ba.iters_run``, through the same hand-built event list that
test_bench_program_trace.py reduces, and nothing from a program that does
not count ``ba.iters_graphed``."""

import pytest

from benchmark.harness import program_trace
from benchmark.metrics import lm_graph_iter_share
from benchmark.tests.test_bench_program_trace import (EVENTS, LAYERS, SPANS,
                                                      _record)


def _with_graphed(n):
    """The hand-built spans, the ``ba.dense`` span counting `n` graphed
    iterations (None: a program without the counter)."""
    out = []
    for s in SPANS:
        c = dict(s["counters"])
        if n is not None and "ba.iters_run" in c:
            c["ba.iters_graphed"] = n
        out.append(dict(s, counters=c))
    return out


@pytest.mark.parametrize("graphed,want", [(7, 87.5), (0, 0.0), (None, None)])
def test_lm_graph_iter_share_reads_graphed_over_run(graphed, want):
    program = program_trace.reduce(EVENTS, _with_graphed(graphed), LAYERS, 8)
    got = lm_graph_iter_share.read(_record(program))
    assert got == (None if want is None else pytest.approx(want))
    # no trace, and a program without the tracer (its pass gave None)
    assert lm_graph_iter_share.read({"scenes": []}) is None
    assert lm_graph_iter_share.read(_record(None)) is None
