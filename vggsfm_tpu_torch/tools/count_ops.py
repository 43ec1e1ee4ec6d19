"""Count the PyTorch ops a stage dispatches, on the CPU: the launch count
of the stage on a GPU, sized without one.

    python -m vggsfm_tpu_torch.tools.count_ops preliminary [N]
    python -m vggsfm_tpu_torch.tools.count_ops sfm [N]

`preliminary` runs `estimate_preliminary_cameras` at the runner's settings
(8 frames, N random tracks, default 512, 1024 minimal sets, lo_num 128,
4 px). `sfm` runs `run_sfm` at the runner's settings (robust_refine 2,
ba_iters 2) on an oracle of `render_two_plane_scene(8, 1024)`: N points
(default 32,768) on its two planes projected through the planted cameras,
0.5 px noise, 10% outlier tracks, from the planted cameras with 2 cm of
translation noise; it counts each part of the solve on its own. Each
count is of every op except views (which launch nothing on a GPU), with
the most frequent ops and the host reads (`aten._local_scalar_dense`,
a tensor read as a Python number or bool, and `aten.nonzero`, a
boolean-mask gather): on a GPU each counted op is about one kernel launch
and each host read one wait for the device. The counts hardly depend on
N while the tracks fit one chunk of the triangulation (N <= 32,768).
"""

from __future__ import annotations

import contextlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

VIEWS = ("view", "expand", "select", "slice", "unsqueeze", "squeeze",
         "transpose", "permute", "detach", "alias", "t.", "_reshape_alias",
         "unbind", "split", "diagonal", "as_strided")
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero")


class OpCount(TorchDispatchMode):
    """Counts the non-view ops, by op and by the part set in `part`."""

    def __init__(self):
        super().__init__()
        self.by_op: dict = {}
        self.by_part: dict = {}
        self.part = "-"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not any(v in name for v in VIEWS):
            self.by_op[name] = self.by_op.get(name, 0) + 1
            ops, reads = self.by_part.get(self.part, (0, 0))
            self.by_part[self.part] = (ops + 1,
                                       reads + (name in HOST_READS))
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def stage(self, name):
        self.part = name
        yield
        self.part = "-"


def _report(title, count: OpCount) -> None:
    total = sum(count.by_op.values())
    reads = sum(count.by_op.get(k, 0) for k in HOST_READS)
    top = sorted(count.by_op.items(), key=lambda kv: -kv[1])[:10]
    print(f"{title}: {total} ops (views excluded), {reads} host reads; "
          f"most frequent: " + ", ".join(f"{k} {v}" for k, v in top))
    if len(count.by_part) > 1:
        for part, (ops, r) in count.by_part.items():
            print(f"  {part}: {ops} ops, {r} host reads")


def count_preliminary(n: int = 512) -> None:
    from vggsfm_tpu_torch.twoview.preliminary import (
        estimate_preliminary_cameras,
    )

    g = torch.Generator().manual_seed(0)
    tracks = torch.rand(1, 8, n, 2, generator=g) * 1024
    vis = torch.ones(1, 8, n)
    with OpCount() as count:
        estimate_preliminary_cameras(
            tracks, vis, 1024, 1024, torch.Generator().manual_seed(1),
            tracks_score=vis, max_error=4.0, lo_num=128,
            max_ransac_iters=1024)
    _report(f"estimate_preliminary_cameras, 8 frames x {n} tracks", count)


def oracle_scene(n: int, size: int = 1024, seed: int = 0):
    """Planted cameras of `render_two_plane_scene(8, size)` and N points
    on its planes that every view sees, projected with 0.5 px noise, the
    first 10% of the tracks uniform pixels beyond frame 0: (extrinsics
    (8, 3, 4), intrinsics (8, 3, 3), tracks (8, N, 2))."""
    from vggsfm_tpu_torch.geometry.cameras import project_points
    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    scene = render_two_plane_scene(8, size)
    extr = torch.as_tensor(scene["extrinsics"])
    intr = torch.as_tensor(scene["intrinsics"])
    g = torch.Generator().manual_seed(seed)
    pts = []
    for z, half in ((4.0, 2.5), (2.0, 0.7)):
        xy = (torch.rand(2 * n, 2, generator=g) * 2 - 1) * half
        pts.append(torch.cat([xy, torch.full((2 * n, 1), z)], 1))
    pts = torch.cat(pts)
    pix = project_points(pts, extr, intr)
    inside = ((pix >= 0) & (pix <= size - 1)).all(-1).all(0)
    tracks = pix[:, torch.nonzero(inside)[:n, 0]]
    tracks = tracks + 0.5 * torch.randn(tracks.shape, generator=g)
    n_out = n // 10
    tracks[1:, :n_out] = torch.rand(7, n_out, 2, generator=g) * (size - 1)
    return extr, intr, tracks


def count_sfm(n: int = 32768) -> None:
    from vggsfm_tpu_torch.sfm import SfmConfig, run_sfm

    extr, intr, tracks = oracle_scene(n)
    g = torch.Generator().manual_seed(1)
    extr0 = extr.clone()
    extr0[1:, :, 3] += 0.02 * torch.randn(7, 3, generator=g)
    vis = torch.ones(tracks.shape[:2])
    count = OpCount()
    with count:
        run_sfm(extr0, intr, tracks, vis, (1024, 1024), score=vis,
                cfg=SfmConfig(), stage=count.stage)
    _report(f"run_sfm, 8 frames x {n} tracks, robust_refine 2, ba_iters 2",
            count)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "preliminary"
    size = [int(a) for a in sys.argv[2:3]]
    {"preliminary": count_preliminary, "sfm": count_sfm}[what](*size)
