"""The VGGT pipeline: `VGGTRunner.reconstruct` on S-frame scenes, as
`python -m vggsfm_tpu_torch.vggt_demo` runs it on one scene folder (VGGT-1B's
feed-forward reconstruction: aggregator, camera head, depth head, the
points kept above the confidence threshold)."""

from __future__ import annotations

import torch

from benchmark.families import vggt
from benchmark.pipelines.common import render_pool
from vggsfm_tpu_torch.vggt import VGGTConfig, VGGTRunner

# the family's declarations the harness reads (benchmark/README.md)
FAMILY = vggt


class Pipeline:
    """`VGGTRunner.reconstruct` on S-frame scenes, with the
    configuration's seeded weights (`vggt.state_dict`)."""

    def __init__(self, cfg: dict, wl: dict, device, work_dir: str):
        self.cfg, self.wl, self.device = cfg, wl, device
        self.opts = {**cfg["runner"], **wl.get("runner", {})}
        self.runner = VGGTRunner(
            VGGTConfig(**self.opts, model=cfg.get("model_args", {})),
            device=device, state_dict=vggt.state_dict(cfg, device))
        self.recorder = vggt.VGGTRecorder(self.runner)
        self.scenes = render_pool(wl, self.opts["img_size"], device)

    def frames(self, i: int) -> int:
        return len(self.scenes[i]["images"])

    def warm_up(self) -> int:
        """Scene 0 (the traced run's profiled scene too); its frames."""
        self.runner.reconstruct(self.scenes[0]["images"])
        return self.frames(0)

    def run(self, i: int) -> dict:
        out = self.runner.reconstruct(self.scenes[i]["images"])
        return {"extrinsics": out["extrinsics"], "timings": out["timings"],
                "out": out}

    def sample_calls(self) -> int:
        """One call of each head a scene."""
        return 1

    def solve_checks(self, res: dict, scene: dict) -> dict:
        """The scene's non-finite outputs and kept points."""
        out = res["out"]
        bad = sum(int((~torch.isfinite(out[k].float())).sum())
                  for k in ("extrinsics", "intrinsics", "depth",
                            "depth_conf", "points3d"))
        return {"nonfinite": float(bad),
                "points": float(out["points3d"].shape[0])}
