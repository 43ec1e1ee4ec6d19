"""The VGGT family: what the pipeline `vggt` (benchmark/pipelines/vggt.py,
its `FAMILY`) declares to the harness.

- `NEURAL`, `SCENE_READS`, `over_window`, `scene_failed`, `want_kwargs`,
  `max_query_pts`, `check_sample`, `reference_models`, `census_modules`,
  and the seeded weights `state_dict`: the checks, the FLOP census and the
  weights (checks.py);
- `KERNELS`: the attention kernel, its roofline group, shapes and work
  formula (kernels.py);
- `FAULTS`: the faults planted under a run (faults.py);
- `VGGTRecorder`: the recorder's hooks on a VGGTRunner (record.py).
"""

from benchmark.families.vggt.checks import (  # noqa: F401
    NEURAL,
    SCENE_READS,
    census_modules,
    check_sample,
    max_query_pts,
    over_window,
    reference_models,
    scene_failed,
    state_dict,
    want_kwargs,
)
from benchmark.families.vggt.faults import FAULTS  # noqa: F401
from benchmark.families.vggt.kernels import KERNELS  # noqa: F401
from benchmark.families.vggt.record import VGGTRecorder  # noqa: F401
