"""PyTorch/CUDA port of vggsfm_tpu (query ranking, camera init and
tracking)."""
