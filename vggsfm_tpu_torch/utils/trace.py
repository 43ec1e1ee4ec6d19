"""The port's tracer: stages, spans and counters of the pipeline's calls.

* `stage(name, timings, device)` times a part of a call into the caller's
  ``timings`` dict under ``name`` (or ``key``), the device's work included:
  it ends in a device synchronize on a GPU. A stage always times, whether
  the tracer records or not, and knows the seconds of the stages nested
  in it (`stage.inner`).
* `span(name)` marks a part below a stage: no synchronize, no timings key.
* `call(name)` is the span of one top-level call
  (`VGGSfMRunner.sparse_reconstruct`, `VideoRunner.run`); every span
  records the id of the outermost call open around it.
* `count(name, n)` adds ``n`` to a counter of the innermost open span.
  ``n`` is a number or a tensor (its elements summed); a tensor stays where
  it is and is summed when the recording ends, after the call's own last
  synchronize, so counting never synchronizes.

Recording is off by default. Then `span`, `call` and `count` test the
module flag `ON` and return, allocating and launching nothing; a stage
times and synchronizes as it always did. `recording()` turns it on for
its body and yields the `Recording`, whose ``spans`` are complete when the
body ends. While recording, and while a torch.profiler is active, every
span is also a profiler range named ``vggsfm.<name>``, on the clock of the
device's kernels in the profiler's trace.

The tracer follows one thread: the pipeline opens its spans on the
thread that calls it.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

RANGE_PREFIX = "vggsfm."

# recording is on: the one flag `span`, `call` and `count` test
ON = False

_NULL = contextlib.nullcontext()
_rec = None  # the active Recording
_open: list = []  # the open recorded spans, innermost last
_stages: list = []  # the open stages, innermost last (recording or not)
_call_ids = itertools.count()


class Recording:
    """The spans of a recording, in the order they opened: dicts with
    ``name``, ``kind`` ('call', 'stage' or 'span'), ``key`` (a stage's
    timings key, else None), ``start_ns`` and ``end_ns`` (the host's
    perf_counter_ns), ``parent`` (the index of the enclosing span, or
    None), ``call`` (the id of the outermost call around it, or None),
    ``counters`` ({name: number}) and ``attrs`` (a stage's notes).
    Counters added outside every span go to ``outside``."""

    def __init__(self):
        self.spans: list = []
        self.outside: dict = {}
        self._pending: list = []  # (counters dict, name, tensor)

    def totals(self, name: str) -> float:
        """The sum of counter `name` over every span and outside them."""
        return (sum(s["counters"].get(name, 0) for s in self.spans)
                + self.outside.get(name, 0))

    def _resolve(self) -> None:
        """Add the tensors counted during the recording: one sum each,
        read in one transfer per device."""
        by_dev: dict = {}
        for item in self._pending:
            by_dev.setdefault(item[2].device, []).append(item)
        for items in by_dev.values():
            sums = torch.stack([t.sum().double() for _, _, t in items])
            for (counters, name, _), v in zip(items, sums.tolist()):
                counters[name] = counters.get(name, 0) + v
        self._pending = []


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the body. Inside a recording, the
    outer recording takes them (and this yields it)."""
    global ON, _rec
    if _rec is not None:
        yield _rec
        return
    rec = _rec = Recording()
    ON = True
    try:
        yield rec
    finally:
        ON = False
        _rec = None
        _open.clear()
        rec._resolve()


class _Span:
    """One recorded span (see `span`, `call` and `stage`)."""

    __slots__ = ("rec", "_range")

    def __init__(self, name: str, kind: str, key=None):
        parent = _open[-1].rec if _open else None
        if kind == "call" and (parent is None or parent["call"] is None):
            call_id = next(_call_ids)
        else:
            call_id = None if parent is None else parent["call"]
        self.rec = {"name": name, "kind": kind, "key": key,
                    "start_ns": 0, "end_ns": 0,
                    "parent": None if parent is None else parent["index"],
                    "call": call_id, "counters": {}, "attrs": {},
                    "index": len(_rec.spans)}
        self._range = None

    def open(self, t_ns: int) -> None:
        self.rec["start_ns"] = t_ns
        _rec.spans.append(self.rec)
        _open.append(self)
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(
                RANGE_PREFIX + self.rec["name"])
            self._range.__enter__()

    def close(self, t_ns: int) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.rec["end_ns"] = t_ns
        if _open and _open[-1] is self:
            _open.pop()

    def __enter__(self):
        self.open(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self.close(time.perf_counter_ns())
        return False


def span(name: str):
    """A span below a stage (a context manager); with recording off, a
    shared no-op one."""
    if not ON:
        return _NULL
    return _Span(name, "span")


def call(name: str):
    """The span of a top-level call (a context manager); a call inside
    another is a span of the outer call."""
    if not ON:
        return _NULL
    return _Span(name, "call")


def count(name: str, n) -> None:
    """Add `n` (a number, or a tensor whose elements are summed when the
    recording ends) to counter `name` of the innermost open span."""
    if not ON:
        return
    counters = _open[-1].rec["counters"] if _open else _rec.outside
    if torch.is_tensor(n):
        _rec._pending.append((counters, name, n))
    else:
        counters[name] = counters.get(name, 0) + n


class stage:
    """A stage named `name` (a context manager), timed into
    ``timings[key or name]``; it ends in a synchronize of `device` when
    that is a GPU. After the body, ``seconds`` (the body and its device
    work) is added to the timings; ``inner`` holds the seconds of the
    stages nested in it, by key; ``attrs`` what `note` gave it, which its
    recorded span keeps. A body that raises adds no time and no
    synchronize."""

    __slots__ = ("name", "key", "timings", "device", "seconds", "inner",
                 "attrs", "_t0", "_span")

    def __init__(self, name: str, timings: dict, device=None, key=None):
        self.name, self.key = name, key or name
        self.timings, self.device = timings, device
        self.seconds = 0.0
        self.inner: dict = {}
        self.attrs: dict = {}

    def note(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        _stages.append(self)
        self._span = _Span(self.name, "stage", self.key) if ON else None
        self._t0 = time.perf_counter_ns()
        if self._span is not None:
            self._span.open(self._t0)
        return self

    def __exit__(self, exc_type, exc, tb):
        if (exc_type is None and self.device is not None
                and self.device.type == "cuda"):
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        _stages.remove(self)
        if self._span is not None:
            self._span.rec["attrs"] = self.attrs
            self._span.close(t1)
        if exc_type is not None:
            return False
        self.seconds = (t1 - self._t0) / 1e9
        self.timings[self.key] = self.timings.get(self.key, 0.0) \
            + self.seconds
        for outer in _stages:
            outer.inner[self.key] = outer.inner.get(self.key, 0.0) \
                + self.seconds
        return False
