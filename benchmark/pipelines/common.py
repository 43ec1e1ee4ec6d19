"""What every pipeline shares: the weights made on the device and handed
to the program, and the cell's pool of scenes.

Both are fixed for a cell: the weights come from the configuration's
`weights_seed` (they stand in for the checkpoint a user would load) and
the scenes from the workload's `scene_seed`. The run's seed draws the
order in which the window takes the scenes and the scene and tracker call
the check samples. So every run of a cell does the same work in another
order: with weights and scenes drawn per seed, the video pipeline's
window retries (each at twice the query points) made one sequence take
2.3x another and the peak memory double.

A pipeline (one module per `pipeline` a configuration names, holding a
class `Pipeline`) renders its pool, warms up on the cell's own shapes
(`warm_up`, on scene 0, which is also what a traced run profiles after
the window), then runs one scene or sequence at a time for the window
(`run(i)` for i >= 1).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness import scenes
from benchmark.harness.weights import model_seed, seeded_state_dict


def scene_seed(base: int, index: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([base, index])


def _skeleton(part: str):
    from benchmark.reference.aliked import ALIKED
    from benchmark.reference.camera import CameraPredictor
    from benchmark.reference.tracker import TrackerPredictor

    cls = {"tracker": TrackerPredictor, "camera": CameraPredictor,
           "aliked": ALIKED}[part]
    with torch.device("meta"):
        return cls()


def make_runner(cfg: dict, wl: dict, device, work_dir: str):
    """A VGGSfMRunner of the configuration with its weights (from
    `weights_seed`).

    The tracker and the camera predictor get them through the runner's
    `state_dict` / `camera_state_dict`; ALIKED through the checkpoint
    path the port reads (VGGSFM_TPU_ALIKED_CKPT), a file written here. The
    camera predictor's dict is handed over on the host: the runner keeps
    the dict it is given, which on the device would be a second copy
    through the window. The weights are seeded, not trained, so the
    tracker runs in the runner's weights-free mode (cycle-consistency
    visibility and the NCC polish), the mode the runner gives its own
    seeded weights."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    seed = cfg["weights_seed"]
    opts = {**cfg["runner"], **wl.get("runner", {})}
    if "aliked" in opts["query_method"]:
        sd = seeded_state_dict(_skeleton("aliked"),
                               model_seed(seed, "aliked"), device)
        os.makedirs(work_dir, exist_ok=True)
        path = os.path.join(work_dir, "aliked.pt")
        torch.save({k: v.cpu() for k, v in sd.items()}, path)
        os.environ["VGGSFM_TPU_ALIKED_CKPT"] = path
    tracker = seeded_state_dict(_skeleton("tracker"),
                                model_seed(seed, "tracker"), device,
                                cfg["flow_head_std"])
    camera = {k: v.cpu() for k, v in seeded_state_dict(
        _skeleton("camera"), model_seed(seed, "camera"), device).items()}
    with torch.device(device):
        runner = VGGSfMRunner(RunnerConfig(**opts), device=device,
                              state_dict=tracker, camera_state_dict=camera)
        runner.camera  # built now, in set-up
    # the port has no public option for this mode: the flag its tracker
    # stages read (the family's `check_sample` checks that they did)
    if not hasattr(runner, "_weights_loaded"):
        raise RuntimeError("VGGSfMRunner has no `_weights_loaded`: the "
                           "weights-free tracker mode cannot be set")
    runner._weights_loaded = False
    return runner, opts


def render_pool(wl: dict, image_size: int, device) -> list:
    """The cell's `pool` scenes (from its `scene_seed`), each with its
    frames in the loader's form (host float32, 8-bit levels) and its
    planted cameras."""
    sc = wl["scene"]
    pool = []
    for i in range(wl["pool"]):
        s = scenes.render_two_plane_scene(
            sc["frames"], image_size, scene_seed(wl["scene_seed"], i),
            device, **{k: v for k, v in sc.items() if k != "frames"})
        s["images"] = scenes.as_loaded(s["images"])
        pool.append(s)
    return pool
