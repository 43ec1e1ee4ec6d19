"""Nistér 5-point essential-matrix minimal solver and its LORANSAC
(PyTorch). Counterpart of vggsfm_tpu/twoview/five_point.py (reference
vggsfm/two_view_geo/essential.py:203-488, which solves a 10x10 action-
matrix eigenproblem with a non-symmetric eigensolver). The same numerical
reformulation as the JAX package, batched over the minimal samples:

  1. the nullspace of the 5x9 epipolar system from the 9x9 Jacobi
     eigensolver: E(x, y, z) = x X + y Y + z Z + W;
  2. the ten cubic constraints (det E = 0 and 2 E Eᵀ E - tr(E Eᵀ) E = 0)
     are trilinear in E, so their 20 monomial coefficients are exact sums
     of trilinear forms over the 64 ordered basis triples (a constant
     triple -> monomial scatter, here a 0/1 matrix product);
  3. by z-power, M(z) = M0 + z M1 + z² M2 + z³ M3 acts on the
     (x, y)-monomial vector; solutions satisfy det M(z) = 0;
  4. the real roots by sign changes of the true determinant (batched
     10x10 LU determinants, f32) on a tangent-warped grid of 512 points,
     then 48 bisection steps; spurious roots are masked by their
     constraint residuals;
  5. per root, the (x, y)-monomial vector is the smallest eigenvector of
     M(z)ᵀ M(z) (10x10 Jacobi again).

Fixed shapes throughout and no host read: the bisection is a fixed loop
over tensors. The minimal sets of `estimate_essential` come from the
caller's `torch.Generator` or are given as `sample_idx`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vggsfm_tpu_torch.ops.eigh import eigh_small, smallest_eigenvector
from vggsfm_tpu_torch.twoview.utils import (
    BIG_RESIDUAL,
    generate_samples,
    residual_indicator,
    sampson_epipolar_distance,
    trial_validity,
)
from vggsfm_tpu_torch.utils.precision import f32_matmuls

# the (x, y)-monomial basis, paired with z-powers: the 20 Nistér monomials
# are XY[i] * z^k for the (i, k) pairs of _MONOMIALS. XY basis order:
# [x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1]
_XY_DEGS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
            (1, 0), (0, 1), (0, 0)]
# the z powers allowed with each xy-monomial (total degree <= 3)
_Z_MAX = {(3, 0): 0, (2, 1): 0, (1, 2): 0, (0, 3): 0,
          (2, 0): 1, (1, 1): 1, (0, 2): 1,
          (1, 0): 2, (0, 1): 2, (0, 0): 3}

_MONOMIALS = [(i, k) for i, d in enumerate(_XY_DEGS)
              for k in range(_Z_MAX[d] + 1)]  # 20 entries


def _triple_monomial_ids() -> np.ndarray:
    """(4, 4, 4): the monomial id in _MONOMIALS of each ordered triple
    (a, b, c) over w = [x, y, z, 1]."""
    ids = np.zeros((4, 4, 4), np.int32)
    mono_index = {m: i for i, m in enumerate(_MONOMIALS)}
    for a in range(4):
        for b in range(4):
            for c in range(4):
                counts = [0, 0, 0, 0]
                for v in (a, b, c):
                    counts[v] += 1
                key = (_XY_DEGS.index((counts[0], counts[1])), counts[2])
                ids[a, b, c] = mono_index[key]
    return ids


_TRIPLE_IDS = _triple_monomial_ids()
# the scatter of the 64 ordered triples into the 20 monomials, (20, 64)
_SCATTER = (np.arange(20)[:, None] == _TRIPLE_IDS.reshape(1, 64)).astype(
    np.float64)
# where each coefficient lands in M_k: _PLACE[k, i] is the monomial id of
# (i, k), or 20 (a zero row) where xy-monomial i takes no z^k
_PLACE = np.full((4, 10), 20, np.int64)
for _c, (_i, _k) in enumerate(_MONOMIALS):
    _PLACE[_k, _i] = _c
_LEVI = np.zeros((3, 3, 3))
for _i, _j, _k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
    _LEVI[_i, _j, _k] = 1.0
for _i, _j, _k in [(0, 2, 1), (2, 1, 0), (1, 0, 2)]:
    _LEVI[_i, _j, _k] = -1.0


@functools.lru_cache(maxsize=None)
def _device_constants(dtype: torch.dtype, device: torch.device):
    """_LEVI, _SCATTER and _PLACE on `device`, made once per (dtype,
    device): a host-to-device copy waits for the device."""
    return (torch.as_tensor(_LEVI, dtype=dtype, device=device),
            torch.as_tensor(_SCATTER, dtype=dtype, device=device),
            torch.as_tensor(_PLACE, device=device))


@f32_matmuls
def _coefficient_matrices(E_basis: torch.Tensor) -> torch.Tensor:
    """(n, 4, 3, 3) nullspace bases -> (n, 4, 10, 10): the z-power slices
    M0..M3 of M(z), rows the ten constraints, columns the xy-monomials.

    Exact: det(E) and 2 E Eᵀ E - tr(E Eᵀ) E are trilinear in E, so each
    monomial coefficient is the sum of the trilinear form over the ordered
    basis triples mapping to that monomial (no interpolation error)."""
    B = E_basis
    levi, scatter, place = _device_constants(B.dtype, B.device)
    # det: eps_ijk Ba[0,i] Bb[1,j] Bc[2,k] -> (n, 4, 4, 4)
    tri_det = torch.einsum("ijk,nai,nbj,nck->nabc", levi, B[:, :, 0],
                           B[:, :, 1], B[:, :, 2])
    # trace constraint: 2 (Ba Bbᵀ) Bc - tr(Ba Bbᵀ) Bc -> (n, 4, 4, 4, 3, 3)
    AB = torch.einsum("naij,nbkj->nabik", B, B)
    tr_ab = torch.diagonal(AB, dim1=-2, dim2=-1).sum(-1)
    tri_tr = (2.0 * torch.einsum("nabik,nckj->nabcij", AB, B)
              - tr_ab[:, :, :, None, None, None] * B[:, None, None])
    n = B.shape[0]
    tri_all = torch.cat([tri_tr.reshape(n, 64, 9),
                         tri_det.reshape(n, 64, 1)], dim=-1)  # (n, 64, 10)
    coeffs = torch.matmul(scatter, tri_all)
    coeffs = torch.cat([coeffs, torch.zeros_like(coeffs[:, :1])], dim=1)
    # (n, 4, 10 columns, 10 rows) -> rows first
    return coeffs[:, place].transpose(-1, -2)


def _tan_grid(grid: int, dtype, device) -> torch.Tensor:
    """tan of `grid` angles evenly spaced over +-0.499 pi (the JAX
    package's grid, each point within rounding of it)."""
    return torch.tan(torch.linspace(-0.499 * np.pi, 0.499 * np.pi, grid,
                                    dtype=dtype, device=device))


def _real_roots_of_det(Ms: torch.Tensor, grid: int = 512,
                       bisect: int = 48):
    """Up to 10 real roots of z -> det(M(z)) per sample by sign-change
    bisection: Ms (n, 4, 10, 10) -> (roots (n, 10), valid (n, 10)).

    Bisecting the true determinant (a batched 10x10 LU determinant) avoids
    the f32 error of interpolating the degree-10 coefficients. The grid is
    tangent-warped (dense near zero, covering all reals); the rows are
    scaled by their largest entry in M0."""
    M0, M1, M2, M3 = Ms.unbind(1)
    scale = M0.abs().amax(dim=-1, keepdim=True) + 1e-9  # (n, 10, 1)

    def f(z):  # z (n, G) -> (n, G)
        zz = z[..., None, None]
        Mz = (M0[:, None] + zz * M1[:, None] + zz ** 2 * M2[:, None]
              + zz ** 3 * M3[:, None])
        return torch.linalg.det(Mz / scale[:, None])

    xs = _tan_grid(grid, Ms.dtype, Ms.device)
    vals = f(xs.expand(Ms.shape[0], grid))
    sign_change = (vals[:, :-1] * vals[:, 1:]) < 0
    # the changes first, each in grid order (a stable sort)
    idx = torch.argsort((~sign_change).to(torch.uint8), dim=-1,
                        stable=True)[:, :10]
    valid = torch.take_along_dim(sign_change, idx, dim=-1)
    lo, hi = xs[:-1][idx], xs[1:][idx]
    for _ in range(bisect):
        mid = 0.5 * (lo + hi)
        same = (f(lo) * f(mid)) > 0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    return 0.5 * (lo + hi), valid


@f32_matmuls
def _nullspace_basis(points1: torch.Tensor,
                     points2: torch.Tensor) -> torch.Tensor:
    """(n, 5, 2) x2 -> (n, 4, 3, 3): the basis [X, Y, Z, W] of the 5x9
    epipolar system's nullspace, its 4 smallest eigenvectors. The four
    eigenvalues are rounding noise, so the basis within the nullspace is
    arbitrary (the solutions are not)."""
    x1, y1 = points1[..., 0], points1[..., 1]
    x2, y2 = points2[..., 0], points2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # (n, 5, 9)
    _, V = eigh_small(torch.matmul(A.transpose(-1, -2), A), num_sweeps=10,
                      sort=True)
    # eigenvectors 3, 2, 1, 0 (a flip, not a list index: that would be
    # copied to the device)
    return V[..., :4].flip(-1).transpose(-1, -2).reshape(-1, 4, 3, 3)


@f32_matmuls
def _solve_basis(E_basis: torch.Tensor):
    """The solutions in a nullspace basis (n, 4, 3, 3): (E (n, 10, 3, 3),
    valid (n, 10))."""
    Ms = _coefficient_matrices(E_basis)
    roots, valid = _real_roots_of_det(Ms)
    z = roots[..., None, None]  # (n, 10, 1, 1)
    Mz = (Ms[:, None, 0] + z * Ms[:, None, 1] + z ** 2 * Ms[:, None, 2]
          + z ** 3 * Ms[:, None, 3])  # (n, 10, 10, 10)
    m = smallest_eigenvector(torch.matmul(Mz.transpose(-1, -2), Mz),
                             num_sweeps=10)
    # the xy-monomial vector: [..., x, y, 1] at indices 7, 8, 9
    denom = torch.where(m[..., 9].abs() < 1e-12, 1e-12, m[..., 9])
    wv = torch.stack([m[..., 7] / denom, m[..., 8] / denom, roots,
                      torch.ones_like(roots)], dim=-1)  # (n, 10, 4)
    E = (wv[..., None, None] * E_basis[:, None]).sum(2)  # (n, 10, 3, 3)
    E = E / torch.clamp(torch.linalg.matrix_norm(E, keepdim=True),
                        min=1e-12)
    # mask the roots whose E violates the constraints
    EEt = torch.matmul(E, E.transpose(-1, -2))
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    res = (torch.linalg.det(E).abs() + torch.linalg.matrix_norm(
        2 * torch.matmul(EEt, E) - tr[..., None, None] * E))
    return E, valid & (res < 1e-2)


def run_5point(points1: torch.Tensor, points2: torch.Tensor,
               chunk: int = 1024):
    """Essential matrices from 5 normalized (intrinsics-free)
    correspondences, batched: (n, 5, 2) x2 -> (E (n, 10, 3, 3), valid
    (n, 10)), up to 10 solutions per minimal sample. The samples go in
    chunks of `chunk`: a chunk's grid of determinants is chunk x 512
    10x10 f32 matrices (210 MB at 1024, and as much again for the LU)."""
    out = [_solve_basis(_nullspace_basis(points1[s:s + chunk],
                                         points2[s:s + chunk]))
           for s in range(0, points1.shape[0], chunk)]
    return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))


@f32_matmuls
def estimate_essential(points1: torch.Tensor, points2: torch.Tensor,
                       generator: torch.Generator | None = None,
                       max_ransac_iters: int = 256,
                       max_error: float = 4.0,
                       focal_length: float = 1.0,
                       valid_mask: torch.Tensor | None = None,
                       sample_idx: torch.Tensor | None = None) -> dict:
    """LORANSAC essential-matrix estimation over (B, N, 2) normalized
    pairs. `max_error` is in pixels, converted to normalized units by
    `focal_length` (reference essential.py:111-200). The 5-point sets,
    shared across the batch, are drawn from `generator` or given as
    `sample_idx` (max_ransac_iters, 5). Returns dict ``emat`` (B, 3, 3),
    ``inlier_num`` (B,), ``inlier_mask`` (B, N)."""
    B, N, _ = points1.shape
    dev = points1.device
    thres = (max_error / focal_length) ** 2
    if valid_mask is None:
        valid_mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    if sample_idx is None:
        sample_idx, trial_valid = generate_samples(
            generator, N, max_ransac_iters, 5, device=dev)
    else:
        sample_idx = sample_idx.to(dev)
        trial_valid = trial_validity(sample_idx)
    R = sample_idx.shape[0]

    E_cand, e_valid = run_5point(points1[:, sample_idx].reshape(-1, 5, 2),
                                 points2[:, sample_idx].reshape(-1, 5, 2))
    E_cand = E_cand.reshape(B, R * 10, 3, 3)
    cand_valid = (e_valid.reshape(B, R, 10)
                  & trial_valid[None, :, None]).reshape(B, -1)

    res = sampson_epipolar_distance(points1, points2, E_cand, squared=True)
    res = torch.where(valid_mask[:, None] & cand_valid[..., None], res,
                      BIG_RESIDUAL)
    inl = res <= thres
    num = inl.sum(-1)
    mean = torch.where(inl, res, 0.0).sum(-1) / torch.clamp(num, min=1)

    best = torch.argmax(residual_indicator(num, mean, cand_valid), dim=1)
    E_best = E_cand[torch.arange(B, device=dev), best]
    res_best = sampson_epipolar_distance(points1, points2, E_best[:, None],
                                         squared=True)[:, 0]
    inlier = torch.where(valid_mask, res_best, BIG_RESIDUAL) <= thres
    return {"emat": E_best, "inlier_num": inlier.sum(-1),
            "inlier_mask": inlier}
