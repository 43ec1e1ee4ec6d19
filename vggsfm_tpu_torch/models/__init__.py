"""Neural models of the port: the tracker and the camera predictor."""

from vggsfm_tpu_torch.models.camera import (  # noqa: F401
    CameraPredictor,
    init_camera_,
)
from vggsfm_tpu_torch.models.tracker import (  # noqa: F401
    BaseTrackerPredictor,
    EfficientUpdateFormer,
    TrackerPredictor,
    init_tracker_,
)
