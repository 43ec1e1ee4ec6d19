"""VGGT-1B's feed-forward reconstruction (PyTorch): the model in
models/vggt.py, run stage by stage and exported as a COLMAP model by
`VGGTRunner`. No counterpart in the JAX package."""

from vggsfm_tpu_torch.vggt.runner import VGGTConfig, VGGTRunner  # noqa: F401
