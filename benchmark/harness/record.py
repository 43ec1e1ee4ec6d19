"""What the benchmark reads of the program while it runs: references to
the outputs of the calls its family's checks compare (for the correctness
check after the window), the shapes of every neural call (for the FLOP
count), and, while a scene is profiled, a named range around each call of
a kernel function with the call's shapes (for the kernel rooflines).

Everything hooks the program from outside: forward hooks on its modules,
wrappers on its public methods and on the kernel functions the models
call. A family's recorder is a `Recorder` given the family's `KERNELS`,
with its own hooks on the program (the VGGSfM family's:
benchmark/families/vggsfm/record.py). A hook that is not recording costs
one attribute test.
"""

from __future__ import annotations

import importlib

import torch
from torch.profiler import record_function

RANGE_PREFIX = "bench.kernel."


class Recorder:
    """The recording a family's hooks share. `kernels` is the family's
    `KERNELS` (kind -> module, attribute, group, shapes, bound).
    `sample_scene(call)` arms the capture of what runs next (what the
    family's hooks keep in `sample` while `_armed` is set); `counting`
    turns the
    census of neural calls on; `kernel_ranges` the per-call kernel
    ranges."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.counting = False
        self.census: list = []  # (module name, input signature)
        self.ranging = False
        self.kernel_calls: list = []  # (kind, shapes dict)
        self._armed = None
        self.sample: dict = {}
        self._depth = 0
        self._handles = []
        self._patched = []  # the kernel functions while ranged
        self._wrapped = []  # the program's functions wrapped for good

    def hook(self, module, name, on_output=None):
        """Count `module`'s outermost calls in the census as `name`, and
        hand each call's (args, kwargs, output) to `on_output` while
        armed."""
        def pre(mod, args, kwargs):
            if self.counting and self._depth == 0:
                self.census.append((name, _signature(args, kwargs)))
            self._depth += 1

        def post(mod, args, kwargs, output):
            self._depth -= 1
            if on_output is not None and self._armed is not None:
                on_output(args, kwargs, output)

        self._handles.append(module.register_forward_pre_hook(
            pre, with_kwargs=True))
        self._handles.append(module.register_forward_hook(
            post, with_kwargs=True))

    def wrap(self, obj, attr: str, make) -> None:
        """Replace `obj.attr` with `make(obj.attr)` until `close`."""
        fn = getattr(obj, attr)
        setattr(obj, attr, make(fn))
        self._wrapped.append((obj, attr, fn))

    # ---------------------------------------------------------- control

    def sample_scene(self, call: int) -> None:
        """Capture the `call`-th sampled call of what runs next."""
        self._armed = call
        self.sample = {"call": call}

    def stop_sampling(self) -> dict:
        self._armed = None
        return self.sample

    def kernel_ranges(self, on: bool) -> None:
        """Wrap (or unwrap) the kernel functions the models call in named
        ranges, recording each call's shapes."""
        if on and not self._patched:
            for kind, (modname, attr, *_) in self.kernels.items():
                mod = importlib.import_module(modname)
                fn = getattr(mod, attr)
                setattr(mod, attr, self._ranged(fn, kind))
                self._patched.append((mod, attr, fn))
        elif not on:
            for mod, attr, fn in self._patched:
                setattr(mod, attr, fn)
            self._patched = []
        self.ranging = on

    def _ranged(self, fn, kind):
        shapes = self.kernels[kind][3]

        def call(*args, **kwargs):
            if not self.ranging:
                return fn(*args, **kwargs)
            idx = len(self.kernel_calls)
            with record_function(f"{RANGE_PREFIX}{idx}"):
                out = fn(*args, **kwargs)
            self.kernel_calls.append((kind, shapes(args, kwargs)))
            return out
        return call

    def close(self) -> None:
        self.kernel_ranges(False)
        for obj, attr, fn in self._wrapped:
            setattr(obj, attr, fn)
        self._wrapped = []
        for h in self._handles:
            h.remove()
        self._handles = []


def frame_sums(frames: torch.Tensor) -> torch.Tensor:
    """One float64 sum per frame of (F, ...): a fingerprint that tells
    which frames of a scene a call saw, without keeping the frames."""
    return frames.flatten(1).sum(1, dtype=torch.float64)


def match_frames(sums: torch.Tensor, candidates: torch.Tensor) -> list:
    """For each fingerprint in `sums`, the index of the nearest one among
    `candidates`."""
    return (sums[:, None] - candidates[None, :]).abs().argmin(1).tolist()


def _signature(args, kwargs) -> tuple:
    def sig(x):
        if torch.is_tensor(x):
            return ("T", tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        if isinstance(x, (int, float, bool, str, type(None))):
            return x
        return type(x).__name__
    return (sig(tuple(args)), tuple(sorted((k, sig(v))
                                           for k, v in kwargs.items())))
