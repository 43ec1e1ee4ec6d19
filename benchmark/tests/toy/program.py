"""A toy program under test: a two-layer net whose first product runs
through a kernel function of this module, in bfloat16, and a solve that
answers with the cameras it is given."""

import time

import torch
from torch import nn


def scaled_mm(x, w, scale: float):
    """The toy's kernel: (R, C) @ (C, H) in bfloat16, times `scale`."""
    return (x.bfloat16() @ w.bfloat16()).float() * scale


class ToyNet(nn.Module):
    """(R, C) -> (R, C): relu(x @ w1) @ w2."""

    def __init__(self, c: int, h: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(c, h))
        self.w2 = nn.Parameter(torch.zeros(h, c))

    def forward(self, x):
        return torch.relu(scaled_mm(x, self.w1, 1.0)) @ self.w2


class ToySystem:
    """`reconstruct(rows, cameras)`: the net on every row, then the
    cameras; its stages' seconds in `timings` (`embed`, `head`)."""

    def __init__(self, net: ToyNet):
        self.net = net

    @torch.inference_mode()
    def reconstruct(self, rows: torch.Tensor, cameras: torch.Tensor):
        t0 = time.perf_counter()
        feat = self.net(rows.flatten(0, 1))
        t1 = time.perf_counter()
        extr = cameras.clone()
        t2 = time.perf_counter()
        return {"feat": feat, "extrinsics": extr,
                "timings": {"embed": t1 - t0, "head": t2 - t1}}
