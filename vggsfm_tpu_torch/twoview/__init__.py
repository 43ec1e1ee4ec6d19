"""Two-view geometry of the port: the batched LORANSAC fundamental-matrix
estimator, the essential-matrix decomposition and the preliminary
relative cameras (counterpart of vggsfm_tpu/twoview/ for the main path's
preliminary stage)."""
