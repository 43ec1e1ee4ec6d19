"""JAX tracker, camera and extractor params -> the port's state_dicts.

`tracker_state_dict_from_jax` inverts vggsfm_tpu/models/convert.py's
`convert_tracker` (its :81-153), `camera_state_dict_from_jax` its
`convert_camera_predictor` with `convert_dinov2` (:155-208). The tracker's
mapping: HWIO -> OIHW convs, (in, out) -> (out, in)
linears, the packed ``in_proj`` -> ``in_proj_weight``/``in_proj_bias``,
``norm_scale``/``norm_bias`` -> ``norm.weight``/``norm.bias``, and the
reference's Sequential indices (``ffeat_updater.0``, ``vis_predictor.0``,
``downsample.0``) and key typo ``virual_tracks``. The resulting keys and
shapes are the reference checkpoint's ``track_predictor.*`` entries with
the prefix stripped, so `TrackerPredictor.load_state_dict` takes either.

The camera's adds LayerNorm ``scale`` -> ``weight``, the DINOv2 block names
(``mlp_fc1`` -> ``mlp.fc1``, ``ls1_gamma`` -> ``ls1.gamma``,
``patch_embed`` -> ``patch_embed.proj``), and the ``mask_token`` the JAX
module does not keep (zeros, never used).

The extractors' (`aliked_state_dict_from_jax`, `sddh_state_dict_from_jax`,
`superpoint_state_dict_from_jax`) give the official checkpoints' key names,
so `convert_aliked_checkpoint`, `convert_sddh_checkpoint` and
`convert_superpoint_checkpoint` of vggsfm_tpu/extractors map them back onto
the same params; a folded `InferenceBatchNorm` (scale, bias) becomes a
BatchNorm with running mean 0 and running variance 1 - eps.

Pure numpy in, torch tensors out; no JAX import.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (1, 0)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mha(sd, prefix, p):
    sd[f"{prefix}.in_proj_weight"] = _t(np.transpose(p["in_proj"]["kernel"],
                                                     (1, 0)))
    sd[f"{prefix}.in_proj_bias"] = _t(p["in_proj"]["bias"])
    _dense(sd, f"{prefix}.out_proj", p["out_proj"])


def _mlp(sd, prefix, p):
    _dense(sd, f"{prefix}.fc1", p["fc1"])
    _dense(sd, f"{prefix}.fc2", p["fc2"])


def _residual_block(sd, prefix, p):
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    if "downsample" in p:
        _conv(sd, f"{prefix}.downsample.0", p["downsample"])


def _basic_encoder(sd, prefix, p):
    for name in ("conv1", "conv2", "conv3"):
        _conv(sd, f"{prefix}.{name}", p[name])
    for k in range(1, 5):
        for i in range(2):
            _residual_block(sd, f"{prefix}.layer{k}.{i}", p[f"layer{k}_{i}"])


def _shallow_encoder(sd, prefix, p):
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    _residual_block(sd, f"{prefix}.layer1", p["layer1"])
    _residual_block(sd, f"{prefix}.layer2", p["layer2"])


def _update_former(sd, prefix, p):
    _dense(sd, f"{prefix}.input_transform", p["input_transform"])
    _dense(sd, f"{prefix}.flow_head", p["flow_head"])
    if "virtual_tracks" in p:
        sd[f"{prefix}.virual_tracks"] = _t(p["virtual_tracks"])
    i = 0
    while f"time_blocks_{i}" in p:
        blk = p[f"time_blocks_{i}"]
        _mha(sd, f"{prefix}.time_blocks.{i}.attn", blk["attn"])
        _mlp(sd, f"{prefix}.time_blocks.{i}.mlp", blk["mlp"])
        i += 1
    j = 0
    while f"space_virtual_blocks_{j}" in p:
        blk = p[f"space_virtual_blocks_{j}"]
        _mha(sd, f"{prefix}.space_virtual_blocks.{j}.attn", blk["attn"])
        _mlp(sd, f"{prefix}.space_virtual_blocks.{j}.mlp", blk["mlp"])
        for name in ("space_point2virtual_blocks",
                     "space_virtual2point_blocks"):
            cb = p[f"{name}_{j}"]
            pre = f"{prefix}.{name}.{j}"
            _mha(sd, f"{pre}.cross_attn", cb["cross_attn"])
            sd[f"{pre}.norm_context.weight"] = _t(cb["norm_context"]["scale"])
            sd[f"{pre}.norm_context.bias"] = _t(cb["norm_context"]["bias"])
            _mlp(sd, f"{pre}.mlp", cb["mlp"])
        j += 1


def _base_predictor(sd, prefix, p):
    _update_former(sd, f"{prefix}.updateformer", p["updateformer"])
    sd[f"{prefix}.norm.weight"] = _t(p["norm_scale"])
    sd[f"{prefix}.norm.bias"] = _t(p["norm_bias"])
    _dense(sd, f"{prefix}.ffeat_updater.0", p["ffeat_updater"])
    if "vis_predictor" in p:
        _dense(sd, f"{prefix}.vis_predictor.0", p["vis_predictor"])


def tracker_state_dict_from_jax(params_np) -> dict:
    """JAX `TrackerPredictor` params (a numpy pytree, with or without the
    outer ``{"params": ...}``) -> the port's TrackerPredictor state_dict."""
    p = params_np.get("params", params_np)
    sd: dict = {}
    _basic_encoder(sd, "coarse_fnet", p["coarse_fnet"])
    _shallow_encoder(sd, "fine_fnet", p["fine_fnet"])
    _base_predictor(sd, "coarse_predictor", p["coarse_predictor"])
    _base_predictor(sd, "fine_predictor", p["fine_predictor"])
    return sd


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dinov2(sd, prefix, p):
    cls = np.asarray(p["cls_token"])
    sd[f"{prefix}.cls_token"] = _t(cls)
    sd[f"{prefix}.mask_token"] = torch.zeros(1, cls.shape[-1])
    sd[f"{prefix}.register_tokens"] = _t(p["register_tokens"])
    sd[f"{prefix}.pos_embed"] = _t(p["pos_embed"])
    _conv(sd, f"{prefix}.patch_embed.proj", p["patch_embed"])
    _norm(sd, f"{prefix}.norm", p["norm"])
    i = 0
    while f"blocks_{i}" in p:
        blk, b = p[f"blocks_{i}"], f"{prefix}.blocks.{i}"
        _norm(sd, f"{b}.norm1", blk["norm1"])
        _norm(sd, f"{b}.norm2", blk["norm2"])
        _dense(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        _dense(sd, f"{b}.mlp.fc1", blk["mlp_fc1"])
        _dense(sd, f"{b}.mlp.fc2", blk["mlp_fc2"])
        sd[f"{b}.ls1.gamma"] = _t(blk["ls1_gamma"])
        sd[f"{b}.ls2.gamma"] = _t(blk["ls2_gamma"])
        i += 1


def camera_state_dict_from_jax(params_np) -> dict:
    """JAX `CameraPredictor` params (a numpy pytree, with or without the
    outer ``{"params": ...}``) -> the port's CameraPredictor state_dict."""
    p = params_np.get("params", params_np)
    sd: dict = {}
    _dinov2(sd, "backbone", p["backbone"])
    _mlp(sd, "input_transform", p["input_transform"])
    sd["pose_token"] = _t(p["pose_token"])
    i = 0
    while f"self_att_{i}" in p:
        _mha(sd, f"self_att.{i}.attn", p[f"self_att_{i}"]["attn"])
        _mlp(sd, f"self_att.{i}.mlp", p[f"self_att_{i}"]["mlp"])
        cb, pre = p[f"cross_att_{i}"], f"cross_att.{i}"
        _mha(sd, f"{pre}.cross_attn", cb["cross_attn"])
        _norm(sd, f"{pre}.norm_context", cb["norm_context"])
        _mlp(sd, f"{pre}.mlp", cb["mlp"])
        i += 1
    i = 0
    while f"trunk_{i}" in p:
        _mha(sd, f"trunk.{i}.attn", p[f"trunk_{i}"]["attn"])
        _mlp(sd, f"trunk.{i}.mlp", p[f"trunk_{i}"]["mlp"])
        i += 1
    _mlp(sd, "pose_branch", p["pose_branch"])
    _dense(sd, "ffeat_updater.0", p["ffeat_updater"])
    return sd


def _batch_norm(sd, prefix, p, eps=1e-5):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    n = np.asarray(p["scale"]).shape[0]
    sd[f"{prefix}.running_mean"] = torch.zeros(n)
    sd[f"{prefix}.running_var"] = torch.ones(n) - eps


def aliked_state_dict_from_jax(params_np) -> dict:
    """JAX `ALIKED` params (a numpy pytree, with or without the outer
    ``{"params": ...}``) -> the port's ALIKED state_dict, the official
    ALIKED-n16 key names."""
    p = params_np.get("params", params_np)
    sd: dict = {}
    for k in range(1, 5):
        blk = p[f"block{k}"]
        for name in ("conv1", "conv2"):
            _conv(sd, f"block{k}.{name}", blk[name])
        for name in ("bn1", "bn2"):
            _batch_norm(sd, f"block{k}.{name}", blk[name])
        if "downsample" in blk:
            _conv(sd, f"block{k}.downsample", blk["downsample"])
        _conv(sd, f"conv{k}", p[f"conv{k}"])
        _conv(sd, f"score_head.{2 * k - 2}", p[f"score_head{k}"])
    return sd


def sddh_state_dict_from_jax(params_np, prefix: str = "desc_head.") -> dict:
    """JAX `SDDH` params -> the official ALIKED checkpoint's ``desc_head``
    entries (`prefix=""`: the port's SDDH state_dict)."""
    p = params_np.get("params", params_np)
    sd: dict = {}
    _conv(sd, f"{prefix}offset_conv.0", p["offset_conv1"])
    _conv(sd, f"{prefix}offset_conv.2", p["offset_conv2"])
    for name in ("sf_conv", "convM"):
        sd[f"{prefix}{name}.weight"] = _t(
            np.transpose(p[name]["kernel"], (3, 2, 0, 1)))
    return sd


def superpoint_state_dict_from_jax(params_np) -> dict:
    """JAX `SuperPoint` params -> the port's SuperPoint state_dict, the
    public ``superpoint_v1.pth`` key names."""
    p = params_np.get("params", params_np)
    sd: dict = {}
    for name, conv_p in p.items():
        _conv(sd, name, conv_p)
    return sd
