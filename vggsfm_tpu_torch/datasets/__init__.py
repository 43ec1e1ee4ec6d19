"""Dataset loaders (host-side, Pillow + numpy): scene folders and the IMC
benchmark (bags, calibrations, submission files)."""

from vggsfm_tpu_torch.datasets.demo_loader import (
    DemoLoader,
    pad_and_resize_image,
)
from vggsfm_tpu_torch.datasets.imc import (
    IMCDataset,
    evaluate_bag,
    load_h5,
    save_h5,
    save_pose_submission,
)
from vggsfm_tpu_torch.datasets.imc_submission import (
    load_scene_submission,
    pack_scene_submission,
)
