"""The SfM solve of the port (counterpart of vggsfm_tpu/sfm/): initial
pair, init BA, pose refinement, triangulation and BA, iterative global BA
on dense masked tensors, and the gauge normalization."""

from vggsfm_tpu_torch.sfm.refine import refine_poses
from vggsfm_tpu_torch.sfm.triangulator import SfmConfig, run_sfm
