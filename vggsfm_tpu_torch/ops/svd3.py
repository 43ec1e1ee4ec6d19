"""Batched 3x3 SVD from a small symmetric eigensolve (PyTorch).
Counterpart of vggsfm_tpu/ops/svd3.py.

V comes from the Jacobi eigendecomposition of AᵀA (`ops/eigh.py`);
U = A V Σ⁻¹ with a Gram-Schmidt and cross-product completion.
``svd3x3(A) -> (U, S, V)`` with ``A ≈ U diag(S) Vᵀ``,
``S[..., 0] >= S[..., 1] >= |S[..., 2]|`` and U, V proper rotations
(det = +1): the smallest singular value carries a sign, immaterial for
the rank-deficient essential / fundamental matrices this serves.
Elementwise apart from the eigensolve.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.ops.eigh import eigh_small

_EPS = 1e-12


def _normalize(v: torch.Tensor, eps: float = _EPS):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps), n[..., 0]


def _any_orthogonal(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit vector u: the coordinate axis
    least aligned with u, Gram-Schmidt'ed."""
    idx = torch.argmin(u.abs(), dim=-1, keepdim=True)
    # a comparison, not `one_hot`: that checks its indices on the host
    e = (idx == torch.arange(3, device=u.device)).to(u.dtype)
    v = e - (e * u).sum(-1, keepdim=True) * u
    return _normalize(v)[0]


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an elementwise sum."""
    return (A * x[..., None, :]).sum(-1)


def svd3x3(A: torch.Tensor):
    """Batched SVD of (..., 3, 3) matrices; see the module docstring."""
    AtA = (A[..., :, :, None] * A[..., :, None, :]).sum(-3)
    _, V = eigh_small(AtA, num_sweeps=8, sort=True)  # ascending
    v1, v2 = V[..., :, 2], V[..., :, 1]  # descending singular order
    v3 = torch.linalg.cross(v1, v2)  # det(V) = +1

    u1, s1 = _normalize(_matvec(A, v1))
    # A ~ 0: the e1 direction
    e1 = torch.zeros_like(u1)
    e1[..., 0] = 1.0
    u1 = torch.where(s1[..., None] > _EPS, u1, e1)

    u2_raw = _matvec(A, v2)
    u2, s2n = _normalize(u2_raw - (u2_raw * u1).sum(-1, keepdim=True) * u1)
    u2 = torch.where(s2n[..., None] > _EPS, u2, _any_orthogonal(u1))
    u3 = torch.linalg.cross(u1, u2)  # det(U) = +1

    S = torch.stack([(u * _matvec(A, v)).sum(-1)
                     for u, v in ((u1, v1), (u2, v2), (u3, v3))], dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    V = torch.stack([v1, v2, v3], dim=-1)
    return U, S, V


def project_rank2(A: torch.Tensor) -> torch.Tensor:
    """Nearest (Frobenius) rank-2 matrix: ``A - s3 u3 v3ᵀ``."""
    U, S, V = svd3x3(A)
    u3, v3 = U[..., :, 2], V[..., :, 2]
    return A - S[..., 2, None, None] * u3[..., :, None] * v3[..., None, :]
