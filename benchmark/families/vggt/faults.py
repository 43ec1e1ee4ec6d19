"""Faults planted in a VGGT pipeline underneath a run (`control.py
--fault`, and the tests that see each one make `correct` false). Each is
installed after the warm-up (`benchmark/faults.py` `plant`), beneath the
benchmark's own hooks; `install(pipe, patch)` takes `patch(obj, attr,
value)`, a setattr that can be undone.
"""

from __future__ import annotations


def _tokens_per_frame(pipe) -> int:
    agg = pipe.runner.model.aggregator
    grid = pipe.opts["img_size"] // agg.patch_size
    return agg.patch_start_idx + grid * grid


def global_per_frame(pipe, patch):
    """Every global block attends within each frame only: the mechanism
    VGGT adds, taken away."""
    P = _tokens_per_frame(pipe)
    for blk in pipe.runner.model.aggregator.global_blocks:
        def confined(x, pos=None, forward=blk.forward):
            C = x.shape[-1]
            return forward(x.reshape(-1, P, C), pos[:, :P]).reshape(x.shape)
        patch(blk, "forward", confined)


def no_global_rope(pipe, patch):
    """The global blocks without their rotary embedding."""
    for blk in pipe.runner.model.aggregator.global_blocks:
        patch(blk.attn, "rope", None)


def first_slot_everywhere(pipe, patch):
    """Every frame takes frame 0's camera and register tokens."""
    agg = pipe.runner.model.aggregator
    special = agg.special_tokens
    patch(agg, "special_tokens",
          lambda S: special(1).expand(S, -1, -1))


FAULTS = {
    "global_per_frame": (global_per_frame, {"vggt": "agg_rel"}),
    "no_global_rope": (no_global_rope, {"vggt": "agg_rel"}),
    "first_slot_everywhere": (first_slot_everywhere, {"vggt": "agg_rel"}),
}
