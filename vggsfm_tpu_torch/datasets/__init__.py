"""Dataset loaders (host-side, Pillow + numpy)."""

from vggsfm_tpu_torch.datasets.demo_loader import (
    DemoLoader,
    pad_and_resize_image,
)
