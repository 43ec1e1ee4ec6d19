"""The video pipeline: `VideoRunner.run` on T-frame sequences, as the
video CLI runs it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.families import vggsfm
from benchmark.pipelines.common import make_runner, render_pool

# the family's declarations the harness reads (benchmark/README.md)
FAMILY = vggsfm


class Pipeline:
    """`VideoRunner.run` on T-frame sequences."""

    def __init__(self, cfg: dict, wl: dict, device, work_dir: str):
        from vggsfm_tpu_torch.video import VideoConfig, VideoRunner

        self.cfg, self.wl, self.device = cfg, wl, device
        runner, self.opts = make_runner(cfg, wl, device, work_dir)
        self.video = VideoRunner(runner, VideoConfig(**cfg["video"]))
        self.runner = runner
        import vggsfm_tpu_torch.video.runner as video_runner

        self.recorder = vggsfm.VGGSfMRecorder(
            runner, aliked="aliked" in self.opts["query_method"],
            queries_in=video_runner)
        self._maps: list = []
        # the final map (observations) of each sequence, for the check:
        # the run returns no observations, and the map reaches only the
        # (private) color step
        if not hasattr(self.video, "_point_colors"):
            raise RuntimeError("VideoRunner has no `_point_colors`: the "
                               "final map cannot be read")
        point_colors = self.video._point_colors

        def kept_colors(images, reg):
            self._maps.append(reg)
            return point_colors(images, reg)

        self.video._point_colors = kept_colors
        self.scenes = render_pool(wl, self.opts["img_size"], device)

    def frames(self, i: int) -> int:
        return len(self.scenes[i]["images"])

    def warm_up(self) -> int:
        """The first frames of sequence 0: the initial window, one window
        and a joint BA, at the cell's shapes (the traced run's profiled
        unit too); their count."""
        n = self.wl["warm_up_frames"]
        self._run(self.scenes[0]["images"][:n])
        return n

    def _run(self, images) -> dict:
        self.video.timings = {}
        self.video.windows = []
        self._maps = []
        preds = self.video.run(images)
        return preds

    def run(self, i: int) -> dict:
        preds = self._run(self.scenes[i]["images"])
        if len(self._maps) != 1:
            raise RuntimeError("the sequence's final map was not seen")
        timings = {**self.runner.timings, **self.video.timings}
        return {"extrinsics": torch.as_tensor(preds["extrinsics"]),
                "timings": timings, "preds": preds, "map": self._maps[-1]}

    def sample_calls(self) -> int:
        return self.wl["sample_calls"]

    def solve_checks(self, res: dict, scene: dict) -> dict:
        """The solve's numbers (`checks`) on one sequence of the window."""
        from benchmark.harness import checks

        p, reg = res["preds"], res["map"]

        def t(x, dtype=torch.float64):
            return torch.as_tensor(np.asarray(x)).to(dtype)

        return {"reproj_over": checks.reproj_over(
                    t(p["points3d"]), t(p["extrinsics"]),
                    t(p["intrinsics"]),
                    None if p["extra_params"] is None
                    else t(p["extra_params"]),
                    t(reg.obs_frame, torch.long), t(reg.obs_point,
                                                    torch.long),
                    t(reg.obs_xy), self.cfg["solve_gate_px"]),
                "valid_tracks": float(p["num_points"])}
