"""The model FLOPs of a window, counted by the benchmark itself: every
neural call the recorder's census saw (module, shapes, options), each
distinct one run once through the float32 reference module the family
names for it (its `census_modules`) under
`torch.utils.flop_counter.FlopCounterMode` on inputs of the same shapes.
The counter sees the reference's matrix products, convolutions and
attention; the solvers' elementwise work is not model FLOPs and is not
counted."""

from __future__ import annotations

from collections import Counter

import torch
from torch.utils.flop_counter import FlopCounterMode


def _build(sig, device, gen):
    """Inputs of a recorded signature: float tensors uniform in [0, 1)
    (float32), other tensors zeros; the rest as recorded."""
    if isinstance(sig, tuple) and sig and sig[0] == "T":
        _, shape, dtype = sig
        if "float" in dtype:
            return torch.rand(shape, generator=gen, device=device)
        return torch.zeros(shape, dtype=getattr(torch, dtype.split(".")[-1]),
                           device=device)
    if isinstance(sig, tuple):
        return tuple(_build(s, device, gen) for s in sig)
    return sig


@torch.inference_mode()
def count_calls(device, census: list, census_modules) -> float:
    """The summed FLOPs of every call in `census`, each through its
    module of `census_modules(device)` (census name -> module)."""
    mods = census_modules(device)
    gen = torch.Generator(device=device).manual_seed(0)
    total = 0.0
    for (name, (args, kwargs)), n in Counter(census).items():
        if name not in mods:
            raise LookupError(f"no census module for {name!r}")
        a = _build(args, device, gen)
        k = {key: _build(v, device, gen) for key, v in kwargs}
        with FlopCounterMode(display=False) as counter:
            mods[name](*a, **k)
        total += n * counter.get_total_flops()
    return total
