"""What the benchmark reads of the program while it runs: references to
the outputs of one sampled tracker, camera (with its trunk's first
iteration) and query-point call (for the correctness check after the
window), the shapes of every neural call (for
the FLOP count), and, while a scene is profiled, a named range around each
kernel wrapper with the call's shapes (for the kernel rooflines).

Everything hooks the program from outside: forward hooks on its modules,
wrappers on its public methods and on the kernel functions the models
call. A hook that is not recording costs one attribute test.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

# the kernel functions as the models reach them: (module, attribute, kind)
KERNEL_SITES = (
    ("vggsfm_tpu_torch.models.layers", "fused_transformer_block", "block"),
    ("vggsfm_tpu_torch.models.layers", "fused_ln_mlp", "mlp"),
    ("vggsfm_tpu_torch.models.layers", "fused_ln_attn", "attn"),
    ("vggsfm_tpu_torch.models.tracker", "corr_sample_kernel", "corr"),
)
RANGE_PREFIX = "bench.kernel."


class Recorder:
    """Hooks on one VGGSfMRunner (`runner`; with `aliked`, on its ALIKED
    extractor too; with `queries_in`, a module whose `get_query_points`
    the program calls, on that function). `sample_scene(call)` arms the
    capture of the `call`-th coarse tracker call of what runs next (the
    fine calls after it, the first camera forward with its trunk's first
    iteration, and the first query points with it);
    `counting` turns the census of neural calls on; `kernel_ranges` the
    per-call kernel ranges."""

    def __init__(self, runner, aliked: bool, queries_in=None):
        self.runner = runner
        self.counting = False
        self.census: list = []  # (module name, input signature)
        self.ranging = False
        self.kernel_calls: list = []  # (kind, shapes dict)
        self._armed = None
        self.sample: dict = {}
        self._depth = 0
        self._coarse_seen = 0
        self._handles = []
        self._patched = []  # the kernel functions while ranged
        self._wrapped = []  # the program's functions wrapped for good
        tr = runner.tracker
        self._hook(tr.coarse_predictor, "coarse", self._on_coarse)
        self._hook(tr.fine_predictor, "fine", self._on_fine)
        self._hook(tr.coarse_fnet, "coarse_fnet")
        self._hook(tr.fine_fnet, "fine_fnet")
        self._hook(runner.camera, "camera", self._on_camera)
        self._hook(runner.camera.backbone, "dino")
        self._hook(runner.camera.pose_branch, "pose_branch",
                   self._on_pose_branch)
        if aliked:
            from vggsfm_tpu_torch.extractors.cnn import load_aliked
            self._hook(load_aliked(runner.device), "aliked",
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

    # ------------------------------------------------------------ hooks

    def _hook(self, module, name, on_output=None):
        def pre(mod, args, kwargs):
            if self.counting and self._depth == 0:
                self.census.append((name, _signature(args, kwargs)))
            self._depth += 1

        def post(mod, args, kwargs, output):
            self._depth -= 1
            if on_output is not None and self._armed is not None:
                on_output(args, kwargs, output)

        self._handles.append(module.register_forward_pre_hook(
            pre, with_kwargs=True))
        self._handles.append(module.register_forward_hook(
            post, with_kwargs=True))

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
        fn = module.get_query_points

        def wrapped(query_image, generator=None, query_method="sift",
                    max_query_num=4096, *args, **kwargs):
            out = fn(query_image, generator, query_method, max_query_num,
                     *args, **kwargs)
            if self._armed is not None and "corners" not in self.sample:
                self.sample["corners"] = dict(
                    frame_sum=frame_sums(query_image[None].float()),
                    method=query_method, max_pts=int(max_query_num),
                    xy=out[0].clone(), valid=out[1].clone())
            return out

        module.get_query_points = wrapped
        self._wrapped.append((module, "get_query_points", fn))

    def _on_aliked(self, args, kwargs, output):
        # the score map of the sampled call's query frame, from the main
        # pass's batched extraction over the query frames
        if "aliked" not in self.sample and self._armed < output.shape[0]:
            self.sample["aliked"] = output[self._armed].clone()

    # ---------------------------------------------------------- control

    def sample_scene(self, call: int) -> None:
        """Capture the `call`-th coarse tracker call of what runs next."""
        self._armed = call
        self.sample = {"call": call}
        self._coarse_seen = 0

    def stop_sampling(self) -> dict:
        self._armed = None
        return self.sample

    def kernel_ranges(self, on: bool) -> None:
        """Wrap (or unwrap) the kernel functions the models call in named
        ranges, recording each call's shapes."""
        import importlib

        if on and not self._patched:
            for modname, attr, kind in KERNEL_SITES:
                mod = importlib.import_module(modname)
                fn = getattr(mod, attr)
                setattr(mod, attr, self._ranged(fn, kind))
                self._patched.append((mod, attr, fn))
        elif not on:
            for mod, attr, fn in self._patched:
                setattr(mod, attr, fn)
            self._patched = []
        self.ranging = on

    def _ranged(self, fn, kind):
        def call(*args, **kwargs):
            if not self.ranging:
                return fn(*args, **kwargs)
            idx = len(self.kernel_calls)
            with record_function(f"{RANGE_PREFIX}{idx}"):
                out = fn(*args, **kwargs)
            self.kernel_calls.append((kind, _kernel_shapes(kind, args,
                                                           kwargs)))
            return out
        return call

    def close(self) -> None:
        self.kernel_ranges(False)
        for mod, attr, fn in self._wrapped:
            setattr(mod, attr, fn)
        self._wrapped = []
        for h in self._handles:
            h.remove()
        self._handles = []


def frame_sums(frames: torch.Tensor) -> torch.Tensor:
    """One float64 sum per frame of (F, ...): a fingerprint that tells
    which frames of a scene a call saw, without keeping the frames."""
    return frames.flatten(1).sum(1, dtype=torch.float64)


def match_frames(sums: torch.Tensor, candidates: torch.Tensor) -> list:
    """For each fingerprint in `sums`, the index of the nearest one among
    `candidates`."""
    return (sums[:, None] - candidates[None, :]).abs().argmin(1).tolist()


def _signature(args, kwargs) -> tuple:
    def sig(x):
        if torch.is_tensor(x):
            return ("T", tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        if isinstance(x, (int, float, bool, str, type(None))):
            return x
        return type(x).__name__
    return (sig(tuple(args)), tuple(sorted((k, sig(v))
                                           for k, v in kwargs.items())))


def _kernel_shapes(kind: str, args, kwargs) -> dict:
    """The shapes the work formulas need (and, for the correlation, a copy
    of the positions, whose windows decide the bytes read)."""
    x = args[0]
    if kind == "corr":
        levels, coords, feats, radius = args[:4]
        return dict(levels=[tuple(lv.shape) for lv in levels],
                    coords=coords.detach().clone(), radius=int(radius),
                    C=int(feats.shape[-1]), tsize=levels[0].element_size(),
                    out_dtype=str(args[4] if len(args) > 4
                                  else kwargs.get("out_dtype",
                                                  torch.float32)))
    R, C = x.shape
    d = dict(R=int(R), C=int(C), tsize=x.element_size(), dtype=str(x.dtype))
    if kind == "block":
        d.update(M=int(args[5].shape[0]), L=int(args[9]))
    elif kind == "mlp":
        d.update(M=int(args[1].shape[0]))
    else:
        d.update(L=int(args[5]))
    return d
