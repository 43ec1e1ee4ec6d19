"""Where a configuration's model family plugs in: the pipeline module its
`pipeline` names (benchmark/pipelines/<pipeline>.py) holds the class
`Pipeline` and `FAMILY`, the module of the family's declarations
(benchmark/README.md lists them). The harness reads every check,
reference, FLOP census module, kernel kind and fault through here; a
declaration or an entry the family lacks raises, naming it.
"""

from __future__ import annotations

import importlib


def pipeline_module(cfg: dict):
    """The module of the configuration's pipeline."""
    return importlib.import_module(f"benchmark.pipelines.{cfg['pipeline']}")


class Family:
    """The declarations of one family, as attributes; `entry` reads one
    entry of a declared table."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        try:
            return getattr(self.module, name)
        except AttributeError:
            raise LookupError(f"the family {self.module.__name__} declares "
                              f"no {name!r}") from None

    def entry(self, table: str, key: str):
        entries = getattr(self, table)
        if key not in entries:
            raise LookupError(f"the family {self.module.__name__} has no "
                              f"{key!r} in its {table}")
        return entries[key]


def of(cfg: dict) -> Family:
    """The family of the configuration's pipeline."""
    mod = pipeline_module(cfg)
    if not hasattr(mod, "FAMILY"):
        raise LookupError(f"the pipeline {mod.__name__} declares no "
                          f"'FAMILY'")
    return Family(mod.FAMILY)
