"""Learned keypoint extractors wired for query-point dispatch. Counterpart
of vggsfm_tpu/extractors/cnn.py: ALIKED / SuperPoint score maps, whose
peaks go through the shared NMS + top-K
(`superpoint_keypoints_from_heatmap`), and the SDDH descriptors.

Checkpoints: set ``VGGSFM_TPU_ALIKED_CKPT`` / ``VGGSFM_TPU_SUPERPOINT_CKPT``
to torch checkpoint paths (official key names). Without one the models run
with a deterministic seeded init: still a usable detector (a random
conv-selu score map fires on texture), and the whole CNN path runs either
way. The models are built once and kept per device; the loaders build
on the GPU unless asked for the CPU, and raise where there is none.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from vggsfm_tpu_torch.extractors.aliked import ALIKED, SDDH
from vggsfm_tpu_torch.extractors.superpoint import (
    SuperPoint,
    superpoint_keypoints_from_heatmap,
)
from vggsfm_tpu_torch.utils.device import resolve_device

_CACHE: dict = {}


@torch.no_grad()
def init_extractor_(model: nn.Module, generator: torch.Generator):
    """Seeded init as the JAX modules': conv kernels LeCun-normal
    (truncated at 2 std), biases 0; the BatchNorms keep scale 1, bias 0."""
    for name, p in sorted(model.named_parameters()):
        if p.dim() == 4:
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif name.endswith("bias"):
            p.zero_()
    return model


def _load_checkpoint(path: str, prefix: str = "") -> dict:
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {str(k).removeprefix("module."): v for k, v in sd.items()}
    return {k.removeprefix(prefix): v for k, v in sd.items()
            if k.startswith(prefix)}


def _cached(name: str, device, build):
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(device))
    if key not in _CACHE:
        _CACHE[key] = build().to(device).eval()
    return _CACHE[key]


def _build_model(model: nn.Module, env: str, seed: int, prefix: str = ""):
    path = os.environ.get(env, "")
    sd = _load_checkpoint(path, prefix) if path and os.path.exists(path) \
        else {}
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own}
    if sd:
        model.load_state_dict(sd)
    else:
        init_extractor_(model, torch.Generator().manual_seed(seed))
    return model


def load_aliked(device="cuda", dtype: torch.dtype = torch.bfloat16) -> ALIKED:
    """The score model in compute dtype `dtype` (weights float32), on the
    GPU unless the caller passes ``device="cpu"``."""
    return _cached(f"aliked_{dtype}", device, lambda: _build_model(
        ALIKED(dtype=dtype), "VGGSFM_TPU_ALIKED_CKPT", 0))


def load_superpoint(device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> SuperPoint:
    return _cached(f"superpoint_{dtype}", device, lambda: _build_model(
        SuperPoint(dtype=dtype), "VGGSFM_TPU_SUPERPOINT_CKPT", 1))


def load_sddh(device="cuda") -> SDDH:
    """The descriptor head: the ALIKED checkpoint's ``desc_head`` subtree
    where there is one, a seeded init otherwise."""
    return _cached("sddh", device, lambda: _build_model(
        SDDH(), "VGGSFM_TPU_ALIKED_CKPT", 2, prefix="desc_head."))


@torch.inference_mode()
def aliked_score_map(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W) float32 scores; the CNN
    computes in bfloat16, so NMS and top-K compare float32 scores."""
    return load_aliked(images.device)(images.float())


@torch.inference_mode()
def superpoint_heat_map(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) grayscale in [0, 1] -> (B, H, W) float32 heat map."""
    return load_superpoint(gray.device)(gray.float()[..., None])[0]


def detect_aliked_keypoints(image: torch.Tensor, max_keypoints: int = 4096,
                            nms_radius: int = 2):
    """(H, W, 3) RGB in [0, 1], or a batch (B, H, W, 3) -> (xy (K, 2),
    score (K,), valid (K,)) [each with the leading B]: NMS peaks of the
    ALIKED score map, strongest first."""
    batched = image.dim() == 4
    score = aliked_score_map(image if batched else image[None])
    out = superpoint_keypoints_from_heatmap(score, max_keypoints,
                                            nms_radius=nms_radius)
    return out if batched else tuple(t[0] for t in out)


def detect_superpoint_keypoints(image: torch.Tensor,
                                max_keypoints: int = 4096,
                                nms_radius: int = 4):
    """(H, W) grayscale in [0, 1], or a batch (B, H, W) -> (xy (K, 2),
    score (K,), valid (K,)) [each with the leading B]."""
    batched = image.dim() == 3
    heat = superpoint_heat_map(image if batched else image[None])
    out = superpoint_keypoints_from_heatmap(heat, max_keypoints,
                                            nms_radius=nms_radius)
    return out if batched else tuple(t[0] for t in out)


@torch.inference_mode()
def describe_aliked_keypoints(image: torch.Tensor, xy: torch.Tensor):
    """(H, W, 3) image + (K, 2) keypoint pixels -> (K, 128) L2-normalized
    SDDH descriptors, float32 throughout."""
    _, feats = load_aliked(image.device, torch.float32)(
        image.float()[None], return_feats=True)
    desc, _ = load_sddh(image.device)(feats, xy.float()[None])
    return desc[0]
