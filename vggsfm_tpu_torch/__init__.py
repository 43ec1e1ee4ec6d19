"""PyTorch/CUDA port of vggsfm_tpu (tracking slice)."""
