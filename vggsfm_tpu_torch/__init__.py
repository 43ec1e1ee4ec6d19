"""PyTorch/CUDA port of vggsfm_tpu: the sparse pipeline from a folder of
images to a COLMAP model (`runner.VGGSfMRunner`, `python -m
vggsfm_tpu_torch.demo`)."""
