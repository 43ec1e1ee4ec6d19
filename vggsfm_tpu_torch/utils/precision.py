"""Matmul precision control (PyTorch). Counterpart of
vggsfm_tpu/utils/precision.py.

The geometric solvers (DLT, Procrustes, projection, the 9x9 normal
matrices of the fundamental-matrix solvers) need true f32 products. On
an NVIDIA GPU cuDNN allows TF32 by default, and so does cuBLAS in any
process that sets matmul precision "high"; `f32_matmuls` turns TF32 off
for both inside a call and restores the caller's settings after it, as
the JAX package pins ``precision='highest'``. The neural paths keep
whatever the caller set.

    @f32_matmuls
    def solve(...): ...

    with f32_matmuls():
        ...
"""

from __future__ import annotations

import functools

import torch


class _F32Matmuls:
    """TF32 off for cuBLAS and cuDNN while the context is open."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def f32_matmuls(fn=None):
    """Decorate `fn` to run with full-f32 products, or, called with no
    argument, a context that does the same for its body."""
    if fn is None:
        return _F32Matmuls()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _F32Matmuls():
            return fn(*args, **kwargs)

    return wrapped
