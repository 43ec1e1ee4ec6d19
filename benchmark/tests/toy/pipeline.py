"""The toy family's pipeline: `ToySystem.reconstruct` on scenes of
seeded rows and planted cameras."""

import numpy as np
import torch

from benchmark.harness.record import Recorder
from benchmark.tests.toy import family
from benchmark.tests.toy.program import ToyNet, ToySystem
from benchmark.tests.toy.reference import toy_weights

FAMILY = family


def _cameras(rng, frames):
    q, _ = np.linalg.qr(rng.standard_normal((frames, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    t = rng.standard_normal((frames, 3, 1))
    return torch.as_tensor(np.concatenate([q, t], -1), dtype=torch.float32)


class Pipeline:
    def __init__(self, cfg, wl, device, work_dir):
        m, sc = cfg["model"], wl["scene"]
        self.net = ToyNet(m["c"], m["h"]).to(device)
        self.net.load_state_dict(toy_weights(cfg["weights_seed"], m["c"],
                                             m["h"]))
        self.system = ToySystem(self.net)
        self.recorder = Recorder(family.KERNELS)
        self.recorder.hook(self.net, "net", self._on_net)
        self.scenes = []
        for i in range(wl["pool"]):
            rng = np.random.default_rng([wl["scene_seed"], i])
            rows = rng.random((sc["frames"], sc["rows"], m["c"]))
            self.scenes.append({
                "images": torch.as_tensor(rows, dtype=torch.float32),
                "extrinsics": _cameras(rng, sc["frames"])})

    def _on_net(self, args, kwargs, output):
        self.recorder.sample.setdefault("feat", output)

    def frames(self, i):
        return len(self.scenes[i]["images"])

    def warm_up(self):
        self.run(0)
        return self.frames(0)

    def run(self, i):
        s = self.scenes[i]
        out = self.system.reconstruct(s["images"], s["extrinsics"])
        return {"extrinsics": out["extrinsics"], "timings": out["timings"]}

    def sample_calls(self):
        return 1

    def solve_checks(self, res, scene):
        return {"frames_solved": float(len(res["extrinsics"]))}
