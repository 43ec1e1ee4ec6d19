"""Matmul precision control (PyTorch). Counterpart of
vggsfm_tpu/utils/precision.py.

The geometric solvers (DLT, Procrustes, projection, the 9x9 normal
matrices of the fundamental-matrix solvers) need true f32 products. On
an NVIDIA GPU cuDNN allows TF32 by default, and so does cuBLAS in any
process that sets matmul precision "high"; `f32_matmuls` turns TF32 off
for both inside a call and restores the caller's settings after it, as
the JAX package pins ``precision='highest'``. The neural paths keep
whatever the caller set, but for VGGT's heads, which run under
`default_precision`: PyTorch's defaults (full-f32 cuBLAS products, cuDNN
convolutions in TF32), as the public VGGT demo runs them, whatever the
caller set.

    @f32_matmuls
    def solve(...): ...

    with f32_matmuls():
        ...
"""

from __future__ import annotations

import functools

import torch


class _F32Matmuls:
    """TF32 off for cuBLAS, and for cuDNN unless `conv_tf32`, while the
    context is open."""

    def __init__(self, conv_tf32: bool = False):
        self.conv_tf32 = conv_tf32

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = self.conv_tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def _pinned(fn, conv_tf32: bool):
    if fn is None:
        return _F32Matmuls(conv_tf32)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _F32Matmuls(conv_tf32):
            return fn(*args, **kwargs)

    return wrapped


def f32_matmuls(fn=None):
    """Decorate `fn` to run with full-f32 products, or, called with no
    argument, a context that does the same for its body."""
    return _pinned(fn, conv_tf32=False)


def default_precision(fn=None):
    """As `f32_matmuls`, but with cuDNN's convolutions in TF32: PyTorch's
    default precision, pinned whatever the caller set."""
    return _pinned(fn, conv_tf32=True)
