"""The toy's plain float32 reference: the same net, nothing of the
program."""

import torch
from torch import nn


class ToyRef(nn.Module):
    def __init__(self, c: int, h: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(c, h))
        self.w2 = nn.Parameter(torch.zeros(h, c))

    def forward(self, x):
        return torch.relu(x @ self.w1) @ self.w2


def toy_weights(seed: int, c: int, h: int) -> dict:
    """The configuration's weights, from its `weights_seed`."""
    g = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn(c, h, generator=g) / c ** 0.5,
            "w2": torch.randn(h, c, generator=g) / h ** 0.5}
