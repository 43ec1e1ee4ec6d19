"""The VGGSfM family: what the sparse and the video pipeline (`FAMILY` of
benchmark/pipelines/sparse.py and video.py) declare to the harness.

- `NEURAL`, `SCENE_READS`, `over_window`, `scene_failed`, `want_kwargs`,
  `max_query_pts`, `check_sample`, `reference_models`, `census_modules`:
  the checks and the FLOP census (checks.py);
- `KERNELS`: the four kernel functions, their roofline groups, shapes and
  frozen work formulas (kernels.py);
- `FAULTS`: the faults planted under a run (faults.py);
- `VGGSfMRecorder`: the recorder's hooks on a VGGSfMRunner (record.py).
"""

from benchmark.families.vggsfm.checks import (  # noqa: F401
    NEURAL,
    SCENE_READS,
    census_modules,
    check_sample,
    max_query_pts,
    over_window,
    reference_models,
    scene_failed,
    want_kwargs,
)
from benchmark.families.vggsfm.faults import FAULTS  # noqa: F401
from benchmark.families.vggsfm.kernels import KERNELS  # noqa: F401
from benchmark.families.vggsfm.record import VGGSfMRecorder  # noqa: F401
