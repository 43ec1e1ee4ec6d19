"""The kernel of the VGGT family as the benchmark reads it: the
long-sequence attention (`vggsfm_tpu_torch.ops.attention.flash_attention`,
which the aggregator's frame and global blocks and its DINOv2 call through
that module), the shapes its work depends on, and the least time of one
call on the chip against the peaks of `harness/work.py`.

At head width 64 a score costs 4 x 64 FLOP on the tensor cores (q.k and
p.v) and one exponential on the special-function units: 16 a clock per SM
on 132 SMs at 1.83 GHz, 3.9e12 a second (the CUDA C programming guide's
throughput table; FlashAttention-3, arXiv:2407.08608). Each of q, k, v and
the output counts once in the bytes.
"""

from __future__ import annotations

from benchmark.harness.work import HBM_BYTES_PER_S, PEAK_FLOPS

EXP_PER_S = 3.9e12


def attn_shapes(args, kwargs) -> dict:
    """The shapes of one call `flash_attention(q, k, v, batch)`."""
    q, k = args[0], args[1]
    return {"BH": int(q.shape[0]), "Lq": int(q.shape[1]),
            "Lk": int(k.shape[1]), "D": int(q.shape[2]),
            "tsize": q.element_size()}


def attn_work(s: dict) -> tuple:
    """(scores, FLOPs, bytes) of one call."""
    scores = s["BH"] * s["Lq"] * s["Lk"]
    nbytes = s["tsize"] * s["BH"] * s["D"] * 2 * (s["Lq"] + s["Lk"])
    return scores, 4 * s["D"] * scores, nbytes


def attn_bound_s(s: dict) -> float:
    """The least time (s) of one call: max(4 D scores / 989e12, scores /
    3.9e12, bytes of q, k, v and out / 3.35e12)."""
    scores, flops, nbytes = attn_work(s)
    return max(flops / PEAK_FLOPS["torch.bfloat16"], scores / EXP_PER_S,
               nbytes / HBM_BYTES_PER_S)


# kind -> (module, attribute: the kernel function as the models reach it;
# the roofline group; the shapes of a call; the least time of a call)
KERNELS = {
    "flash": ("vggsfm_tpu_torch.ops.attention", "flash_attention", "attn",
              attn_shapes, attn_bound_s),
}
