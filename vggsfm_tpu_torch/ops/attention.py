"""Full (non-causal) attention over long sequences, head width 64.

Replaces no kernel of the JAX package, whose attention never spans more
than a few thousand tokens (the plain (L, L) scores of models/dinov2.py);
VGGT-1B's global blocks (models/vggt.py) attend over every token of a
scene, S x 1374 of them (65,952 at 48 frames), where those scores would
take 278 GB a layer.

  * `flash_attention(q, k, v, batch)` launches the hand-written CUDA
    kernel (csrc/flash_attn.cu, built at first use with the port's other
    kernels by ops/_build.py `load_library`) for CUDA tensors, or raises if the kernel does not
    take the inputs; CPU tensors, and only those, take `attention_plain`.
  * `attention_plain` is the same function in plain PyTorch, with the
    same signature: the keys in the kernel's tiles of 128 with an online
    softmax (so it never holds more than (L, 128) scores a head), f32
    statistics, the probabilities rounded to v's dtype before their product
    with v, as the kernel rounds them to bf16.
  * Each launch counts in `launch_counts["flash_attention"]`; while the
    tracer records, every call adds to ``attn.calls`` and ``attn.scores``
    (heads x L_q x L_k, the kernel's exact work).

Inputs q, k, v: (B * H, L, 64), contiguous, one dtype (bf16 for the
kernel); `batch` is B. Output (B, L, H * 64) in the inputs' dtype, the
layout the out-projection reads.
"""

from __future__ import annotations

import math

import torch

from vggsfm_tpu_torch.ops import _build, launch_counts
from vggsfm_tpu_torch.utils import trace

HEAD_DIM = 64
KEY_BLOCK = 128  # keys per block of the plain route: the kernel's tile


def _count(BH: int, L: int) -> None:
    if trace.ON:
        trace.count("attn.calls", 1)
        trace.count("attn.scores", BH * L * L)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    batch: int) -> torch.Tensor:
    """Plain version of `flash_attention`, same signature and result."""
    BH, L, D = q.shape
    H = BH // batch
    scale = math.log2(math.e) / math.sqrt(D)
    qf = q.float() * scale
    m = torch.full((BH, L, 1), -math.inf, device=q.device)
    s_sum = torch.zeros((BH, L, 1), device=q.device)
    acc = torch.zeros((BH, L, D), device=q.device)
    for j in range(0, L, KEY_BLOCK):
        s = qf @ k[:, j:j + KEY_BLOCK].float().transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        s_sum = s_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v[:, j:j + KEY_BLOCK]\
            .float()
        m = m_new
    out = (acc / s_sum).to(q.dtype)
    _count(BH, L)
    return out.view(batch, H, L, D).transpose(1, 2).reshape(batch, L, H * D)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    batch: int) -> torch.Tensor:
    """softmax(q k^T / 8) v per head, one kernel launch; see the module
    docstring for the shapes."""
    if q.device.type != "cuda":
        return attention_plain(q, k, v, batch)
    BH, L, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.shape != (BH, L, D) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention takes contiguous bf16 q, k, v "
                             f"of one shape (BH, L, {HEAD_DIM}); {name} is "
                             f"{t.dtype} {tuple(t.shape)}")
    if D != HEAD_DIM or BH % batch:
        raise ValueError(f"flash_attention takes head width {HEAD_DIM} and "
                         f"B * H rows; got D = {D}, BH = {BH}, B = {batch}")
    H = BH // batch
    out = torch.empty((batch, L, H * D), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    rc = lib.vf_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), BH, L, H, D,
                           math.log2(math.e) / math.sqrt(D),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed ({rc}) at "
                           f"BH={BH}, L={L}")
    launch_counts["flash_attention"] += 1
    _count(BH, L)
    return out
