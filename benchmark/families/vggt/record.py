"""The VGGT family's recorder: hooks on one VGGTRunner that keep, of the
sampled scene, the aggregator's taps, the camera head's input and each
iteration's trunk output and pose delta, the depth head's output and the
kept points, and name the aggregator, camera head and depth head calls in
the census (`census_modules` counts them)."""

from __future__ import annotations

from benchmark.families.vggt.kernels import KERNELS
from benchmark.harness.record import Recorder


class VGGTRecorder(Recorder):
    def __init__(self, runner):
        super().__init__(KERNELS)
        self.runner = runner
        m = runner.model
        self.hook(m.aggregator, "aggregator", self._on_aggregator)
        self.hook(m.camera_head, "camera_head", self._on_camera_head)
        self.hook(m.camera_head.trunk, "trunk", self._on_trunk)
        self.hook(m.camera_head.pose_branch, "pose_branch",
                  self._on_pose_branch)
        self.hook(m.depth_head, "depth_head", self._on_depth_head)

        def make(points):
            def wrapped(images, depth, conf, extr, intr):
                out = points(images, depth, conf, extr, intr)
                if self._armed is not None:
                    cfg = runner.cfg
                    self.sample["points"] = dict(
                        out, extrinsics=extr, intrinsics=intr,
                        conf_thres=cfg.conf_thres,
                        max_points=cfg.max_points)
                return out
            return wrapped

        self.wrap(runner, "points", make)

    def _on_aggregator(self, args, kwargs, output):
        self.sample["taps"] = list(output)

    def _on_camera_head(self, args, kwargs, output):
        self.sample["camera"] = dict(tokens=args[0], iterations=len(output),
                                     poses=list(output))

    def _on_trunk(self, args, kwargs, output):
        self.sample.setdefault("trunk", []).append(output[0].clone())

    def _on_pose_branch(self, args, kwargs, output):
        # the delta less the branch's bias, which would dominate it
        bias = self.runner.model.camera_head.pose_branch.fc2.bias
        self.sample.setdefault("deltas", []).append((output - bias)[0])

    def _on_depth_head(self, args, kwargs, output):
        self.sample["depth"], self.sample["conf"] = output
        self.sample["image_hw"] = tuple(args[1])
        self.sample["chunk"] = args[2] if len(args) > 2 else 8
