"""`sparse_reconstruct` of two checkouts of the repo timed in turns on one
card, to compare a change with its parent.

    python -m vggsfm_tpu_torch.tools.ab_reconstruct PARENT CHANGE [RUNS]

Each checkout runs in its own child process, in the order parent,
change, change, parent: its kernels built (or loaded) from its own
sources, then `VGGSfMRunner.sparse_reconstruct` on
`render_two_plane_scene(8, 1024)` at bench.py's matched workload (8 query
frames x 4096 ALIKED points, fine tracking, comple_nonvis, bf16, hybrid
camera init, seeded weights), once to warm up, then RUNS (default 3)
timed runs, each ending in a synchronize. Prints the card, one JSON line
per turn (the walls and the stage times of the top-level stages) and the
two sides' medians; exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

_build.load_library()
images = render_two_plane_scene(8, 1024)["images"]
runner = VGGSfMRunner(RunnerConfig(
    precision="bf16", query_frame_num=8, max_query_pts=4096,
    query_method="aliked", fine_tracking=True, comple_nonvis=True,
    camera_init="hybrid"), device="cuda")
runner.sparse_reconstruct(images)
torch.cuda.synchronize()
walls, stages = [], []
for _ in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    out = runner.sparse_reconstruct(images)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    stages.append({k: v for k, v in out["timings"].items() if "." not in k})
print(json.dumps({"walls": walls, "stages": stages,
                  "valid_tracks": int(out["valid_tracks"].sum())}))
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parent, change = (os.path.abspath(a) for a in argv[:2])
    runs = argv[2] if len(argv) > 2 else "3"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if card.returncode != 0:
        print("ab_reconstruct: no GPU", file=sys.stderr)
        return 2
    print(f"card: {card.stdout.strip()}", flush=True)
    walls = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        tree = parent if side == "parent" else change
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree, runs],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        walls[side] += line["walls"]
        print(json.dumps({"side": side, **line}), flush=True)
    print(json.dumps({f"{side}_median_s": statistics.median(w)
                      for side, w in walls.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
