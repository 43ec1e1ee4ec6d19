"""Neural models of the port (tracking slice)."""

from vggsfm_tpu_torch.models.tracker import (  # noqa: F401
    BaseTrackerPredictor,
    EfficientUpdateFormer,
    TrackerPredictor,
    init_tracker_,
)
