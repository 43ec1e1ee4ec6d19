"""Lower-precision products for the control of the correctness check.

`rounded_products(dtype)` is a torch function mode under which every
matrix product, convolution and attention of the reference takes its
operands rounded through `dtype` (bfloat16, float8 e4m3 with one scale
per tensor, as fp8 inference scales them, or `TF32`: float32 with a 10-bit
mantissa, as TF32 tensor cores read it) while it accumulates in float32.
The reference under this mode is the control: the same mathematics one
precision step below the one the configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
# the operand rounding of TF32 products (not a torch dtype)
TF32 = "tf32"


def round_through(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to `dtype` and back to its own dtype; float8 scales the
    tensor so that its largest magnitude maps to the format's largest."""
    if not torch.is_floating_point(t) or t.numel() == 0:
        return t
    if dtype == TF32:
        # round to nearest on the 13 mantissa bits TF32 drops
        bits = t.float().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32).to(t.dtype)
    if dtype == torch.float8_e4m3fn:
        amax = t.detach().abs().amax().float()
        scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
        return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)
    return t.to(dtype).to(t.dtype)


# operand positions of each product (biases and shapes stay as they are)
_OPERANDS = {
    F.linear: (0, 1),
    torch.matmul: (0, 1),
    torch.Tensor.__matmul__: (0, 1),
    torch.mm: (0, 1),
    torch.bmm: (0, 1),
    torch.addmm: (1, 2),
    torch.baddbmm: (1, 2),
    F.conv2d: (0, 1),
    F.conv_transpose2d: (0, 1),
    F.scaled_dot_product_attention: (0, 1, 2),
}


class rounded_products(TorchFunctionMode):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            args = (args[0],) + tuple(
                round_through(a, self.dtype) if torch.is_tensor(a) else a
                for a in args[1:])
        elif func in _OPERANDS:
            args = tuple(
                round_through(a, self.dtype)
                if i in _OPERANDS[func] and torch.is_tensor(a) else a
                for i, a in enumerate(args))
        return func(*args, **kwargs)
