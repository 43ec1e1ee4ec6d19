"""Reconstruction data model and COLMAP-format IO (host-side, numpy).
Counterpart of vggsfm_tpu/io: the COLMAP sparse-model spec
(cameras/images/points3D, binary and text), the bridge from the
pipeline's dense arrays, and the GLB scene export (`io.glb`).
"""

from vggsfm_tpu_torch.io.colmap import (
    Camera,
    Image,
    Point3D,
    Reconstruction,
    CAMERA_MODELS,
    read_model,
    write_model,
)
from vggsfm_tpu_torch.io.bridge import (
    arrays_to_reconstruction,
    reconstruction_to_arrays,
)
