"""Batched symmetric eigensolver for small matrices (PyTorch).
Counterpart of vggsfm_tpu/ops/eigh.py.

A fixed number of cyclic Jacobi sweeps, branch-free and batched without
limit: for n <= 6 one Givens rotation at a time over the static (p, q)
schedule; for n > 6 the parallel order, each round of disjoint rotations
(the circle-method tournament) applied as one batched similarity
Gᵀ A G, with two extra sweeps. The same algorithm as the JAX package,
so eigenvector signs and the order of equal eigenvalues follow it, which
`torch.linalg.eigh` does not promise (and on CUDA it checks its `info`
with a host sync). Nothing here reads a tensor on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vggsfm_tpu_torch.utils.precision import f32_matmuls


def _rotation(app, aqq, apq):
    """cos and sin of the Jacobi rotation zeroing apq."""
    small = apq.abs() <= 1e-30 * (app.abs() + aqq.abs() + 1e-30)
    safe_apq = torch.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)  # tau == 0: 45 degrees
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _givens(X, c, s, p: int, q: int, dim: int):
    """Rotate the columns (dim=-1) or rows (dim=-2) p and q of X in place."""
    Xp, Xq = X.select(dim, p), X.select(dim, q)
    new_p, new_q = c * Xp - s * Xq, s * Xp + c * Xq
    Xp.copy_(new_p)
    Xq.copy_(new_q)


def _jacobi_rotation(A, V, p: int, q: int):
    """One batched Givens rotation zeroing A[..., p, q] (p < q), in place:
    A <- Gᵀ A G, V <- V G."""
    c, s = _rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    c, s = c[..., None], s[..., None]
    _givens(A, c, s, p, q, -1)
    _givens(A, c, s, p, q, -2)
    _givens(V, c, s, p, q, -1)


def _round_robin_rounds(n: int) -> list:
    """Circle-method tournament schedule: a list of rounds, each an (m, 2)
    int array of DISJOINT index pairs; together they cover all n(n-1)/2
    pairs exactly once."""
    players = list(range(n)) + ([-1] if n % 2 else [])
    m = len(players)
    rounds = []
    for _ in range(m - 1):
        pairs = [(min(players[i], players[m - 1 - i]),
                  max(players[i], players[m - 1 - i]))
                 for i in range(m // 2)
                 if players[i] != -1 and players[m - 1 - i] != -1]
        rounds.append(np.asarray(pairs, np.int64))
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _device_rounds(n: int, device: torch.device) -> list:
    """Per round: (p, q, rows, cols) index tensors on `device`, where
    (rows, cols) address G's entries (p,p), (q,q), (p,q), (q,p). Made
    once per (n, device): a host-to-device copy waits for the device."""
    out = []
    for pr in _round_robin_rounds(n):
        p, q = pr[:, 0], pr[:, 1]
        rows = np.concatenate([p, q, p, q])
        cols = np.concatenate([p, q, q, p])
        out.append(tuple(torch.as_tensor(a, device=device)
                         for a in (p, q, rows, cols)))
    return out


def _parallel_round(A, V, eye, p, q, rows, cols):
    """One round of DISJOINT Givens rotations as one batched similarity
    A <- Gᵀ A G, V <- V G (the rotations commute; every angle is read
    from the same A)."""
    c, s = _rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    G = eye.expand(A.shape).clone()
    G[..., rows, cols] = torch.cat([c, c, s, -s], dim=-1)
    A = torch.matmul(torch.matmul(G.transpose(-1, -2), A), G)
    return A, torch.matmul(V, G)


@f32_matmuls
def eigh_small(A: torch.Tensor, num_sweeps: int = 6, sort: bool = True):
    """Eigendecomposition of batched symmetric (..., n, n) matrices:
    (eigenvalues (..., n), ascending with `sort`, eigenvectors (..., n, n)
    in columns), as `torch.linalg.eigh` lays them out."""
    n = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))
    # Jacobi is scale-invariant in exact arithmetic; normalizing keeps the
    # f32 intermediates of badly scaled inputs healthy
    scale = A.abs().amax(dim=(-1, -2), keepdim=True)
    scale = torch.where(scale == 0, 1.0, scale)
    A = A / scale
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()

    if n > 6:
        rounds = _device_rounds(n, A.device)
        for _ in range(num_sweeps + 2):
            for idx in rounds:
                A, V = _parallel_round(A, V, eye, *idx)
    else:
        pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
        for _ in range(num_sweeps):
            for p, q in pairs:
                _jacobi_rotation(A, V, p, q)

    w = torch.diagonal(A, dim1=-2, dim2=-1) * scale[..., 0]
    if sort:
        w, order = torch.sort(w, dim=-1, stable=True)
        V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w, V


def smallest_eigenvector(A: torch.Tensor, num_sweeps: int = 6):
    """Eigenvector of the smallest eigenvalue of (..., n, n) symmetric A,
    (..., n); the first one where eigenvalues tie."""
    w, V = eigh_small(A, num_sweeps=num_sweeps, sort=False)
    idx = torch.argmin(w, dim=-1)
    return torch.take_along_dim(V, idx[..., None, None], dim=-1)[..., 0]
