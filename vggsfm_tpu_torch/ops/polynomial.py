"""Closed-form real roots of cubics, batched and branch-free (PyTorch).
Counterpart of vggsfm_tpu/ops/polynomial.py.

Every trial computes all branches (linear, quadratic, Cardano,
trigonometric) and selects with `where`; an explicit validity mask marks
the root slots that hold real roots.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def solve_cubic(coeffs: torch.Tensor):
    """Real roots of ``a x^3 + b x^2 + c x + d = 0``, coeffs (..., 4)
    ``[a, b, c, d]`` -> (roots (..., 3), valid (..., 3) bool). A vanishing
    leading coefficient falls back to the quadratic or linear solve, the
    unused slots invalid."""
    a, b, c, d = coeffs.unbind(-1)
    a_zero = a.abs() < _EPS
    b_zero = b.abs() < _EPS
    c_zero = c.abs() < _EPS

    # linear: c x + d = 0
    lin_root = -d / torch.where(c.abs() < _EPS, 1.0, c)
    lin_valid = ~c_zero

    # quadratic: b x^2 + c x + d = 0, the cancellation-free roots
    b_safe = torch.where(b_zero, 1.0, b)
    disc_q = c * c - 4.0 * b_safe * d
    sqrt_q = torch.sqrt(torch.clamp(disc_q, min=0.0))
    qq = -0.5 * (c + torch.sign(c + (c == 0.0).to(c.dtype)) * sqrt_q)
    quad_r0 = qq / b_safe
    quad_r1 = d / torch.where(qq.abs() < _EPS, 1.0, qq)
    quad_valid = disc_q >= 0.0

    # cubic, normalized: x^3 + B x^2 + C x + D; depressed t^3 + p t + q
    # with x = t - B/3
    a_safe = torch.where(a_zero, 1.0, a)
    B, C, D = b / a_safe, c / a_safe, d / a_safe
    shift = B / 3.0
    p = C - B * B / 3.0
    q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = 0.25 * q * q + p ** 3 / 27.0

    # one real root (disc > 0): Cardano
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t_single = _cbrt(-0.5 * q + sqrt_disc) + _cbrt(-0.5 * q - sqrt_disc)

    # three real roots (disc <= 0): the trigonometric method (p < 0)
    p_neg = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    t0 = m * torch.cos(theta)
    t1 = m * torch.cos(theta - two_pi_3)
    t2 = m * torch.cos(theta + two_pi_3)

    three_real = disc <= 0.0
    cub_r0 = torch.where(three_real, t0, t_single) - shift
    cub_r1 = torch.where(three_real, t1, t_single) - shift
    cub_r2 = torch.where(three_real, t2, t_single) - shift

    r0 = torch.where(a_zero, torch.where(b_zero, lin_root, quad_r0), cub_r0)
    r1 = torch.where(a_zero, quad_r1, cub_r1)
    v0 = torch.where(a_zero, torch.where(b_zero, lin_valid, quad_valid),
                     torch.ones_like(a_zero))
    v1 = torch.where(a_zero, ~b_zero & quad_valid, three_real)
    v2 = ~a_zero & three_real
    return (torch.stack([r0, r1, cub_r2], dim=-1),
            torch.stack([v0, v1, v2], dim=-1))
