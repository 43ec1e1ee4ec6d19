"""Bundle adjustment of the port: the dense Levenberg-Marquardt solver
with a Schur complement (counterpart of vggsfm_tpu/ba/lm.py)."""

from vggsfm_tpu_torch.ba.lm import BAConfig, bundle_adjust, reprojection_cost
