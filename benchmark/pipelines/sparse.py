"""The sparse pipeline: `VGGSfMRunner.sparse_reconstruct` on S-frame
scenes, as the demo CLI runs it on one scene folder."""

from __future__ import annotations

import torch

from benchmark.families import vggsfm
from benchmark.pipelines.common import make_runner, render_pool

# the family's declarations the harness reads (benchmark/README.md)
FAMILY = vggsfm


class Pipeline:
    """`VGGSfMRunner.sparse_reconstruct` on S-frame scenes."""

    def __init__(self, cfg: dict, wl: dict, device, work_dir: str):
        self.cfg, self.wl, self.device = cfg, wl, device
        self.runner, self.opts = make_runner(cfg, wl, device,
                                             work_dir)
        self.recorder = vggsfm.VGGSfMRecorder(
            self.runner, aliked="aliked" in self.opts["query_method"])
        self.scenes = render_pool(wl, self.opts["img_size"], device)
        if self.opts["comple_nonvis"]:
            # the re-query's last round may add SuperPoint; its model is
            # built here, in set-up, not in the window
            from vggsfm_tpu_torch.extractors.cnn import load_superpoint
            load_superpoint(device)

    def frames(self, i: int) -> int:
        return len(self.scenes[i]["images"])

    def warm_up(self) -> int:
        """Scene 0 (the traced run's profiled scene too); its frames."""
        self.runner.sparse_reconstruct(self.scenes[0]["images"])
        return self.frames(0)

    def run(self, i: int) -> dict:
        out = self.runner.sparse_reconstruct(self.scenes[i]["images"])
        return {"extrinsics": out["extrinsics"], "timings": out["timings"],
                "out": out}

    def sample_calls(self) -> int:
        """How many coarse calls the main pass of a scene makes."""
        return self.opts["query_frame_num"]

    def solve_checks(self, res: dict, scene: dict) -> dict:
        """The solve's numbers (`checks`) on one scene of the window."""
        from benchmark.harness import checks

        out = res["out"]
        valid = out["valid_tracks"].bool()
        mask = out["valid_2d_mask"].bool() & valid[None]
        f, p = torch.nonzero(mask, as_tuple=True)
        return {"pose_err_deg": checks.pose_err_deg(out["extrinsics"],
                                                    scene["extrinsics"]),
                "reproj_over": checks.reproj_over(
                    out["points3d"].float(), out["extrinsics"].float(),
                    out["intrinsics"].float(),
                    None if out.get("extra_params") is None
                    else out["extra_params"].float(),
                    f, p, out["pred_track"][0, f, p].float(),
                    self.cfg["solve_gate_px"]),
                "valid_tracks": float(valid.sum())}
