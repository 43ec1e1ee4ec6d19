"""Count the PyTorch ops the preliminary two-view stage dispatches, on the
CPU: the launch count of the stage on a GPU, sized without one.

    python -m vggsfm_tpu_torch.tools.count_ops [N]   # from the repo root

Runs `estimate_preliminary_cameras` at the runner's settings (8 frames, N
random tracks, default 512, 1024 minimal sets, lo_num 128, 4 px) under a
dispatch mode that counts every op except views (which launch nothing on
a GPU), and prints the total and the most frequent ops. On the GPU each
counted op is about one kernel launch; the count hardly depends on N.
"""

from __future__ import annotations

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vggsfm_tpu_torch.twoview.preliminary import estimate_preliminary_cameras

VIEWS = ("view", "expand", "select", "slice", "unsqueeze", "squeeze",
         "transpose", "permute", "detach", "alias", "t.", "_reshape_alias",
         "unbind", "split", "diagonal", "as_strided")


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not any(v in name for v in VIEWS):
            self.by_op[name] = self.by_op.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main(n: int = 512) -> None:
    g = torch.Generator().manual_seed(0)
    tracks = torch.rand(1, 8, n, 2, generator=g) * 1024
    vis = torch.ones(1, 8, n)
    with OpCount() as count:
        estimate_preliminary_cameras(
            tracks, vis, 1024, 1024, torch.Generator().manual_seed(1),
            tracks_score=vis, max_error=4.0, lo_num=128,
            max_ransac_iters=1024)
    total = sum(count.by_op.values())
    top = sorted(count.by_op.items(), key=lambda kv: -kv[1])[:10]
    print(f"estimate_preliminary_cameras, 8 frames x {n} tracks: {total} "
          f"ops (views excluded); most frequent: "
          + ", ".join(f"{k} {v}" for k, v in top))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
