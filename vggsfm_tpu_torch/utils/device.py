"""Where an entry point of the port runs."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when a GPU is asked for
    and none is present (no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vggsfm_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev
