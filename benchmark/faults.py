"""Faults planted in the program underneath a run, for the readings the
check's limits are set from (`control.py --fault`) and for the tests that
see each one make `correct` false. Each family declares its own
(`FAULTS`: name -> (install, {pipeline: the number that reads it
there}); the VGGSfM family's are in benchmark/families/vggsfm/faults.py).
A fault is installed after the warm-up, beneath the benchmark's own
hooks, so what the check reads is what the broken program passed on.
`install(pipe, patch)` takes `patch(obj, attr, value)`, a setattr that
can be undone.
"""

from __future__ import annotations


def plant(pipeline_cls, install, patch) -> None:
    """Make every Pipeline of `pipeline_cls` built from now on install
    the fault right after its warm-up."""
    warm_up = pipeline_cls.warm_up

    def warm_up_then_break(self):
        n = warm_up(self)
        install(self, patch)
        return n
    patch(pipeline_cls, "warm_up", warm_up_then_break)


class Patches:
    """`patch(obj, attr, value)` that `undo()` reverts, newest first."""

    def __init__(self):
        self._saved = []

    def __call__(self, obj, attr, value):
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def undo(self):
        while self._saved:
            obj, attr, value = self._saved.pop()
            setattr(obj, attr, value)


# the VGGSfM family's faults, importable from here as before
_MOVED = ("FAULTS", "tracks_moved", "fine_moved", "features_scaled",
          "trunk_scaled", "scores_scaled", "query_points_moved",
          "corners_moved", "points_moved", "ba_unchanged")


def __getattr__(name):
    if name in _MOVED:
        from benchmark.families.vggsfm import faults
        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
