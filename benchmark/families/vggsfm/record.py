"""The VGGSfM family's recorder: hooks on one VGGSfMRunner that keep the
outputs of one sampled tracker, camera (with its trunk's first iteration)
and query-point call for the checks, and name its neural calls in the
census (`census_modules` counts them)."""

from __future__ import annotations

from benchmark.families.vggsfm.kernels import KERNELS
from benchmark.harness.record import Recorder, frame_sums


class VGGSfMRecorder(Recorder):
    """Hooks on one VGGSfMRunner (`runner`; with `aliked`, on its ALIKED
    extractor too; with `queries_in`, a module whose `get_query_points`
    the program calls, on that function). `sample_scene(call)` arms the
    capture of the `call`-th coarse tracker call of what runs next (the
    fine calls after it, the first camera forward with its trunk's first
    iteration, and the first query points with it)."""

    def __init__(self, runner, aliked: bool, queries_in=None):
        super().__init__(KERNELS)
        self.runner = runner
        self._coarse_seen = 0
        tr = runner.tracker
        self.hook(tr.coarse_predictor, "coarse", self._on_coarse)
        self.hook(tr.fine_predictor, "fine", self._on_fine)
        self.hook(tr.coarse_fnet, "coarse_fnet")
        self.hook(tr.fine_fnet, "fine_fnet")
        self.hook(runner.camera, "camera", self._on_camera)
        self.hook(runner.camera.backbone, "dino")
        self.hook(runner.camera.pose_branch, "pose_branch",
                  self._on_pose_branch)
        if aliked:
            from vggsfm_tpu_torch.extractors.cnn import load_aliked
            self.hook(load_aliked(runner.device), "aliked",
                      self._on_aliked)
        query_points = runner.query_points
        fmaps = runner.fmaps

        def wrapped_query_points(images, query_indices, masks=None,
                                 query_method=None, max_query_pts=None):
            out = query_points(images, query_indices, masks, query_method,
                               max_query_pts)
            if self._armed is not None and query_method is None \
                    and "query" not in self.sample:
                self.sample["query"] = (list(query_indices), out)
            return out

        def wrapped_fmaps(images):
            out = fmaps(images)
            if self._armed is not None:
                self.sample["last_fmaps"] = (frame_sums(images[0]),
                                             frame_sums(out[0]))
            return out

        runner.query_points = wrapped_query_points
        runner.fmaps = wrapped_fmaps
        if queries_in is not None:
            self._watch_queries(queries_in)

    def sample_scene(self, call: int) -> None:
        """Capture the `call`-th coarse tracker call of what runs next."""
        super().sample_scene(call)
        self._coarse_seen = 0

    # ------------------------------------------------------------ hooks

    def _on_coarse(self, args, kwargs, output):
        if self._coarse_seen == self._armed:
            self.sample["coarse"] = dict(
                query_points=args[0], kwargs=dict(kwargs),
                fmaps_sums=frame_sums(args[1][0]),
                scene=self.sample.get("last_fmaps"),
                tracks=output[0][-1], vis=output[1])
        self._coarse_seen += 1

    def _on_fine(self, args, kwargs, output):
        # the fine calls between the sampled coarse call and the next one
        if self._coarse_seen == self._armed + 1:
            self.sample.setdefault("fine", []).append(output[0][-1])

    def _on_camera(self, args, kwargs, output):
        if "camera" not in self.sample:
            self.sample["camera"] = dict(
                frame_sums=frame_sums(args[0].flatten(0, 1)).view(
                    args[0].shape[:2]),
                iters=kwargs.get("iters", 4),
                feat=output["rgb_feat_init"])

    def _on_pose_branch(self, args, kwargs, output):
        # the first trunk iteration of the first camera forward: the
        # trunk's output (the branch's input) and the pose branch's delta
        if "trunk" not in self.sample and "camera" not in self.sample:
            self.sample["trunk"] = (args[0].clone(), output.clone())

    def _watch_queries(self, module) -> None:
        """Wrap `module.get_query_points` (the dispatcher as `module`
        calls it): the first call while armed is kept, with the
        fingerprint of its image, its budget and its points."""
        def make(fn):
            def wrapped(query_image, generator=None, query_method="sift",
                        max_query_num=4096, *args, **kwargs):
                out = fn(query_image, generator, query_method,
                         max_query_num, *args, **kwargs)
                if self._armed is not None and "corners" not in self.sample:
                    self.sample["corners"] = dict(
                        frame_sum=frame_sums(query_image[None].float()),
                        method=query_method, max_pts=int(max_query_num),
                        xy=out[0].clone(), valid=out[1].clone())
                return out
            return wrapped

        self.wrap(module, "get_query_points", make)

    def _on_aliked(self, args, kwargs, output):
        # the score map of the sampled call's query frame, from the main
        # pass's batched extraction over the query frames
        if "aliked" not in self.sample and self._armed < output.shape[0]:
            self.sample["aliked"] = output[self._armed].clone()
