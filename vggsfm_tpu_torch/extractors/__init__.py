"""Query-point extractors. Counterpart of vggsfm_tpu/extractors/.

  * ``sift`` -> a difference-of-Gaussians scale-space detector
    (extractors/dog.py): classical, no weights;
  * ``harris`` -> Harris corner response, the cheap fallback;
  * ``aliked`` / ``superpoint`` -> the CNNs (weights from the public
    checkpoints when given, a seeded random init otherwise);
  * ``grid`` -> a uniform grid.
"""

from vggsfm_tpu_torch.extractors.corners import detect_harris_keypoints
from vggsfm_tpu_torch.extractors.dispatch import (
    get_query_points,
    get_query_points_batched,
)
from vggsfm_tpu_torch.extractors.dog import detect_dog_keypoints

__all__ = ["detect_dog_keypoints", "detect_harris_keypoints",
           "get_query_points", "get_query_points_batched"]
