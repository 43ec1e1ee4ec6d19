"""Two-view geometry of the port: batched robust estimators for the
fundamental and essential matrices, homographies and absolute pose, the
essential-matrix decomposition and the preliminary relative cameras
(counterpart of vggsfm_tpu/twoview/, under the same names). The main path
runs the fundamental-matrix LORANSAC, the decomposition and the 6-point
PnP; the five-point, homography and EPnP solvers are library API.
"""

from vggsfm_tpu_torch.twoview.utils import (
    normalize_points_masked,
    sampson_epipolar_distance,
    generate_samples,
)
from vggsfm_tpu_torch.twoview.fundamental import (
    run_7point,
    run_8point,
    estimate_fundamental,
)
from vggsfm_tpu_torch.twoview.essential import (
    essential_from_fundamental,
    decompose_essential_matrix,
    remove_cheirality,
)
from vggsfm_tpu_torch.twoview.preliminary import (
    estimate_preliminary_cameras,
)
from vggsfm_tpu_torch.twoview.five_point import (
    run_5point,
    estimate_essential,
)
from vggsfm_tpu_torch.twoview.pnp import absolute_pose_ransac, solve_pnp_dlt
from vggsfm_tpu_torch.twoview.homography import (
    estimate_homography,
    decompose_homography_matrix,
    run_homography_dlt,
)
