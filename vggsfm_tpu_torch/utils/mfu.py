"""Device-utilization accounting: FLOP counts and MFU of the hot stages.
Counterpart of vggsfm_tpu/utils/mfu.py, with its names.

Every hot entry point (the runner's stages, both bundle adjusters) goes
through `timed_call`, which records (name, call count, the shapes of the
call) into a process-global ledger: a dict update per call, always on.
With `SYNC_TIMING` on (a measurement pass, never the normal path) the
ledger also:

  * counts the FLOPs of the first call at each shape signature under
    `torch.utils.flop_counter.FlopCounterMode` (that call is not timed:
    the counter's dispatch overhead stays out of the seconds);
  * times every other call, synchronized before and after with
    `torch.cuda.synchronize()`, and accumulates its seconds and the FLOPs
    of its signature.

MFU is achieved FLOP/s over the card's published dense bf16 peak.

What is counted: what `FlopCounterMode` counts, matrix products,
convolutions and attention, plus the port's hand-written kernels. The
kernels are ctypes launches that the counter cannot see, so each wrapper
adds its function's FLOPs by one formula (`add_kernel_flops`), on the card
where the kernel runs and on the CPU where its plain version runs; the
plain version then runs with the counter suspended (`plain`), so its own
aten ops are not counted a second time. Each formula counts what the
counter counts of the plain version (its matrix products). XLA's cost
analysis, which the JAX ledger reads, also counts elementwise work, so
the two packages' FLOPs differ by that share.

The FLOPs of a data-dependent call (an LM loop that leaves early) are
those of its counted call at the same shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SYNC_TIMING = False

# name -> {"count": int, "sig": the last call's shape signature,
#          "calls": {sig: count}, "flops": {sig: FLOPs of one call},
#          "seconds": float, "timed_flops": float, "timed_calls": int}
_LEDGER: dict = {}
# the kernel FLOPs of the call being counted ({kernel name: FLOPs}), or
# None when no call is being counted
_KERNELS: dict | None = None
_DEPTH = 0  # recorded calls in progress (an inner call is part of its outer)


def _sig(x):
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    if isinstance(x, (int, float, bool, str, type(None))):
        return x
    if dataclasses.is_dataclass(x) and x.__hash__ is not None:
        return x  # a frozen config: its fields shape the work
    return type(x).__name__


def record(name: str, fn, args: tuple, kwargs: dict | None = None) -> tuple:
    """Count one call to computation `name` at `args`' shapes; returns the
    call's shape signature."""
    sig = _sig((args, kwargs or {}))
    ent = _LEDGER.get(name)
    if ent is None:
        ent = _LEDGER[name] = {"count": 0, "sig": None, "calls": {},
                               "flops": {}, "seconds": 0.0,
                               "timed_flops": 0.0, "timed_calls": 0}
    ent["count"] += 1
    ent["sig"] = sig
    ent["calls"][sig] = ent["calls"].get(sig, 0) + 1
    ent["fn"] = getattr(fn, "__name__", str(fn))
    return sig


def counting() -> bool:
    """Whether a call is being counted (the kernel wrappers ask)."""
    return _KERNELS is not None


def add_kernel_flops(name: str, flops: float) -> None:
    """Charge one launch of hand-written kernel `name` (or its plain
    version) with `flops` to the call being counted."""
    if _KERNELS is not None:
        _KERNELS[name] = _KERNELS.get(name, 0.0) + float(flops)


def plain(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` with the FLOP counter suspended while a call
    is counted: a kernel's plain version, whose FLOPs its wrapper charged
    by formula."""
    if _KERNELS is None:
        return fn(*args, **kwargs)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return fn(*args, **kwargs)


def count_flops(fn, *args, **kwargs):
    """(fn's output, {op or kernel: FLOPs}) of one call of fn: aten ops by
    `FlopCounterMode`, the kernels by their formulas."""
    global _KERNELS
    from torch.utils.flop_counter import FlopCounterMode

    outer, _KERNELS = _KERNELS, {}
    try:
        with FlopCounterMode(display=False) as counter:
            out = fn(*args, **kwargs)
        by_op = {str(k): float(v)
                 for k, v in counter.get_flop_counts().get("Global",
                                                           {}).items()}
        for k, v in _KERNELS.items():
            by_op[f"kernel:{k}"] = by_op.get(f"kernel:{k}", 0.0) + v
    finally:
        _KERNELS = outer
    return out, by_op


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_call(name: str, fn, args: tuple, kwargs: dict | None = None):
    """Record + execute one call; with `SYNC_TIMING`, also count its
    FLOPs (the first call at its shapes) or time it (the others). A call
    made inside another recorded call runs unrecorded: the outer call's
    FLOPs and seconds include it."""
    global _DEPTH
    kwargs = kwargs or {}
    if _DEPTH:
        return fn(*args, **kwargs)
    sig = record(name, fn, args, kwargs)
    _DEPTH += 1
    try:
        if not SYNC_TIMING:
            return fn(*args, **kwargs)
        ent = _LEDGER[name]
        if sig not in ent["flops"]:
            out, by_op = count_flops(fn, *args, **kwargs)
            ent["flops"][sig] = sum(by_op.values())
            ent["by_op"] = by_op
            return out
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        ent["seconds"] += time.perf_counter() - t0
        ent["timed_calls"] += 1
        ent["timed_flops"] += ent["flops"][sig]
        return out
    finally:
        _DEPTH -= 1


def reset() -> None:
    _LEDGER.clear()


def flops_of(name: str) -> float | None:
    """FLOPs of one call of `name` at its last call's shapes (None until
    a `SYNC_TIMING` pass counted a call at those shapes)."""
    ent = _LEDGER.get(name)
    if ent is None:
        return None
    return ent["flops"].get(ent["sig"])


def flops_report(device=None) -> dict:
    """{name: {calls, flops_per_call, total_flops[, device_s, mfu]}} for
    every recorded computation: total_flops None while a signature was
    never counted; device_s and mfu over the timed calls of a
    `SYNC_TIMING` pass."""
    out = {}
    for name, ent in list(_LEDGER.items()):
        per = flops_of(name)
        known = all(s in ent["flops"] for s in ent["calls"])
        total = (sum(ent["flops"][s] * n for s, n in ent["calls"].items())
                 if known else None)
        row = {"calls": ent["count"], "flops_per_call": per,
               "total_flops": total}
        if ent["timed_calls"]:
            row["device_s"] = ent["seconds"]
            row["timed_calls"] = ent["timed_calls"]
            u = mfu(ent["timed_flops"], ent["seconds"], device)
            if u is not None:
                row["mfu"] = u
        out[name] = row
    return out


# dense bf16 tensor-core peak per card, FLOP/s, keyed by substrings of
# torch.cuda.get_device_name(), with the board power the figure is quoted
# at (NVIDIA H100 Tensor Core GPU datasheet: H100 SXM5, 989.4 TFLOPS
# dense BF16 at up to 700 W; the 1,979 of the sheet's headline is with
# sparsity). A card capped below that power runs slower under load: the
# caller reads the limit with nvidia-smi and reports it beside the MFU.
_PEAK_BF16 = (
    ("H100 80GB HBM3", 989.4e12, 700.0),  # H100 SXM5
)


def peak_flops(device=None) -> float | None:
    """Dense bf16 peak FLOP/s of `device` (a device name, a CUDA device or
    its index; default the current card), None for a part not in the
    table or without a card."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        if device is None and not torch.cuda.is_available():
            return None
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device) \
            if not isinstance(device, int) else torch.device("cuda", device)
        if dev.type != "cuda":
            return None
        name = torch.cuda.get_device_name(dev)
    for key, peak, _watts in _PEAK_BF16:
        if key in name:
            return peak
    return None


def mfu(total_flops: float | None, seconds: float,
        device=None) -> float | None:
    peak = peak_flops(device)
    if not peak or not total_flops or seconds <= 0:
        return None
    return total_flops / seconds / peak


@contextlib.contextmanager
def sync_timing():
    """A measurement pass: `SYNC_TIMING` on within the block."""
    global SYNC_TIMING
    old, SYNC_TIMING = SYNC_TIMING, True
    try:
        yield
    finally:
        SYNC_TIMING = old
