"""Seeded weights, made on the device.

One normal draw fills a flat float32 buffer for a whole model; one
multiply-add gives each leaf its scale; the state dict's tensors are views
of the buffer. The same seed gives the same weights on every call, so the
program and the reference are handed identical tensors.

The scales follow the seeded inits of the JAX package and the port: every
Linear/Conv kernel LeCun-normal (fan-in = input channels x taps,
truncated at 2 std), biases 0, norm scales and LayerScale gammas 1,
virtual tracks N(0, 1), DINO's pos_embed N(0, 0.02), the pose token
N(0, 1e-6), class/register/mask tokens 0; the trackers' flow heads
N(0, flow_head_std), not 0 as in the port's own seeded init, so that the
formers move the tracks (a zero head would leave them at the matching
init and the formers' outputs unread).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

NORMS = ("LayerNorm", "GroupNorm", "InferenceBatchNorm")


def _leaf_rules(skeleton: nn.Module, flow_head_std: float) -> dict:
    """name -> (mean, std) for every floating entry of the state dict."""
    norm_params, deconvs = set(), set()
    for mname, m in skeleton.named_modules():
        prefix = f"{mname}." if mname else ""
        if type(m).__name__ in NORMS:
            norm_params.update(prefix + p for p, _ in
                               m.named_parameters(recurse=False))
        if isinstance(m, nn.ConvTranspose2d):
            deconvs.add(prefix + "weight")
    rules = {}
    for name, t in skeleton.state_dict().items():
        if not t.is_floating_point():
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name in norm_params:
            rules[name] = (1.0 if leaf == "weight" else 0.0, 0.0)
        elif leaf == "running_var":
            rules[name] = (1.0 - 1e-5, 0.0)
        elif leaf in ("running_mean", "cls_token", "register_tokens",
                      "mask_token") or leaf.endswith("bias"):
            rules[name] = (0.0, 0.0)
        elif leaf == "gamma":
            rules[name] = (1.0, 0.0)
        elif leaf == "virual_tracks":
            rules[name] = (0.0, 1.0)
        elif leaf == "pos_embed":
            rules[name] = (0.0, 0.02)
        elif leaf == "pose_token":
            rules[name] = (0.0, 1e-6)
        elif name.endswith("flow_head.weight"):
            rules[name] = (0.0, flow_head_std)
        else:
            fan_in = (t.shape[0] * t[0, 0].numel() if name in deconvs
                      else t[0].numel())
            rules[name] = (0.0, math.sqrt(1.0 / fan_in))
    return rules


def seeded_state_dict(skeleton: nn.Module, seed: int, device,
                      flow_head_std: float = 0.0) -> dict:
    """The state dict of `skeleton` (any device, `meta` included) filled
    from `seed` on `device`: float entries as views of one buffer, the
    others zeros."""
    rules = _leaf_rules(skeleton, flow_head_std)
    shapes = {k: t.shape for k, t in skeleton.state_dict().items()}
    names = sorted(rules)
    numels = torch.tensor([math.prod(shapes[n]) for n in names],
                          device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(int(numels.sum()), generator=gen, device=device)
    flat.clamp_(-2.0, 2.0)  # the truncation of the LeCun normal
    std = torch.tensor([rules[n][1] for n in names], device=device)
    mean = torch.tensor([rules[n][0] for n in names], device=device)
    flat = torch.addcmul(mean.repeat_interleave(numels), flat,
                         std.repeat_interleave(numels))
    out, off = {}, 0
    for n in names:
        k = math.prod(shapes[n])
        out[n] = flat[off: off + k].view(shapes[n])
        off += k
    for n, t in skeleton.state_dict().items():
        if n not in out:
            out[n] = torch.zeros(shapes[n], dtype=t.dtype, device=device)
    return out


# one seed per model, derived from a configuration's weights_seed
MODEL_SEEDS = {"tracker": 1, "camera": 2, "aliked": 3}


def model_seed(weights_seed: int, model: str) -> int:
    return (weights_seed * 8 + MODEL_SEEDS[model]) % (2 ** 63)
