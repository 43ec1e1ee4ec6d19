"""Bundle adjustment of the port: the dense Levenberg-Marquardt solver
with a Schur complement (counterpart of vggsfm_tpu/ba/lm.py) and the
observation-major implicit-Schur PCG solver (ba/sparse_lm.py)."""

from vggsfm_tpu_torch.ba.lm import BAConfig, bundle_adjust, reprojection_cost
from vggsfm_tpu_torch.ba.sparse_lm import SparseBAConfig, bundle_adjust_sparse
