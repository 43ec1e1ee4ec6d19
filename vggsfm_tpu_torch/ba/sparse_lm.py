"""Observation-major sparse bundle adjustment: implicit Schur + PCG
(PyTorch). Counterpart of vggsfm_tpu/ba/sparse_lm.py.

The dense solver (ba/lm.py) materializes the reduced camera system
(S*C x S*C), right for a few hundred frames. The video pipeline's joint BA
spans every registered frame and map point (reference
runners/video_runner.py:494-541, solved there by CPU Ceres with a sparse
Schur), where the dense reduced system would not fit.

This solver never forms it: observations are flat (frame_idx, point_idx,
xy) triplets, the normal-equation blocks are segment sums over frames and
over points (`index_add_`), and the reduced camera system is solved by a
fixed count of preconditioned conjugate-gradient rounds whose matvec
applies U x - W V⁻¹ Wᵀ x through two gather / segment passes. Padding
observations (weight 0) are inert.

As in ba/lm.py, by design: the Jacobians are closed form (the JAX solver
takes `jax.jacfwd` of a per-observation residual), and the LM loop is
ba/lm.py's `lm_loop`: `max_iterations` masked steps under a device `done`
flag that the host reads every `_SYNC_EVERY` iterations, replayed from a
CUDA graph after the first on a CUDA device. On the GPU the segment sums are
atomic adds, so their f32 rounding may vary from run to run.
"""

from __future__ import annotations

import dataclasses

import torch

from vggsfm_tpu_torch.ba.lm import (
    _BEHIND_PENALTY_SQ,
    BAConfig,
    _inv3x3,
    _jacobians,
    _project_rotated,
    _robust_sqrt_weight,
    lm_loop,
)
from vggsfm_tpu_torch.geometry.rotations import axis_angle_to_matrix
from vggsfm_tpu_torch.ops.eigh import eigh_small
from vggsfm_tpu_torch.utils import trace
from vggsfm_tpu_torch.utils.precision import f32_matmuls


@dataclasses.dataclass(frozen=True)
class SparseBAConfig(BAConfig):
    cg_iters: int = 40


def _spd_inverse_small(M: torch.Tensor, eps: float) -> torch.Tensor:
    """Batched SPD inverse of (..., n, n), n <= 8, via the Jacobi eigh."""
    w, V = eigh_small(M, num_sweeps=6, sort=False)
    w_inv = 1.0 / torch.clamp(w, min=eps)
    return torch.einsum("...ij,...j,...kj->...ik", V, w_inv, V)


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of `x` summed into `n` segments by `idx`."""
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)


@f32_matmuls
def bundle_adjust_sparse(extrinsics: torch.Tensor,
                        intrinsics: torch.Tensor,
                        points3d: torch.Tensor,
                        obs_frame: torch.Tensor,
                        obs_point: torch.Tensor,
                        obs_xy: torch.Tensor,
                        obs_weight: torch.Tensor,
                        extra_params: torch.Tensor | None = None,
                        pose_free: torch.Tensor | None = None,
                        intr_free: torch.Tensor | None = None,
                        point_free: torch.Tensor | None = None,
                        cfg: SparseBAConfig = SparseBAConfig(),
                        group=None):
    """LM bundle adjustment over flat observation lists.

    extrinsics (S, 3, 4), intrinsics (S, 3, 3), points3d (P, 3);
    obs_frame / obs_point (O,) integer indices; obs_xy (O, 2) pixels;
    obs_weight (O,), 0 disables an observation (padding); extra_params
    optional (S, K); pose_free / intr_free (S,), point_free (P,): False
    freezes (default: frame 0's pose frozen).

    With `group` (a mesh `Axis`), the observation lists are this rank's
    block (cameras and points replicated): every segment sum over frames
    and over points, and the cost, is summed over the group (as the JAX
    solver's `axis_name` psums), so the CG loop, whose inputs are then
    all global, runs alike on every rank.

    Returns (extrinsics, intrinsics, extra_params, points3d, info) with
    ``info = {"cost": the cost after each iteration (max_iterations,),
    "initial_cost", "final_cost"}``. The call is the tracer's span
    ``ba.sparse``, each LM iteration a span ``ba.iter`` (utils/trace.py).
    """
    with trace.span("ba.sparse"):
        S = extrinsics.shape[0]
        P = points3d.shape[0]
        dev = points3d.device
        K = 0 if extra_params is None else extra_params.shape[-1]
        C = 7 + K
        dtype = torch.float32

        R0 = extrinsics[..., :3].to(dtype)
        t0 = extrinsics[..., 3].to(dtype)
        f0 = intrinsics[:, 0, 0].to(dtype)
        pp0 = intrinsics[:, :2, 2].to(dtype)
        k0 = (extra_params.to(dtype) if extra_params is not None
              else torch.zeros((S, 0), dtype=dtype, device=dev))
        X0 = points3d.to(dtype)
        of = obs_frame.long()
        op = obs_point.long()
        obs_xy = obs_xy.to(dtype)
        w_obs = obs_weight.to(dtype)

        if cfg.shared_intrinsics:
            # the tying projector acts on the step, so the values are unified
            # first; only frames with a plausible focal vote (the video runner
            # passes unregistered frames whose K rows are still zero)
            ok = (f0 > 1e-3).to(dtype)
            n_ok = torch.clamp(ok.sum(), min=1.0)
            logf = torch.where(ok > 0, torch.log(torch.clamp(f0, min=1e-6)),
                               0.0).sum() / n_ok
            f0 = torch.exp(logf).expand(S)
            pp0 = ((pp0 * ok[:, None]).sum(0, keepdim=True)
                   / n_ok).expand(S, 2)
            if K:
                k0 = ((k0 * ok[:, None]).sum(0, keepdim=True)
                      / n_ok).expand(S, K)

        if pose_free is None:
            pose_free = torch.arange(S, device=dev) != 0
        if intr_free is None:
            intr_free = torch.ones(S, dtype=torch.bool, device=dev)
        if point_free is None:
            point_free = torch.ones(P, dtype=torch.bool, device=dev)

        slot_mask = torch.cat([
            pose_free[:, None].to(dtype).expand(S, 6),
            intr_free[:, None].to(dtype).expand(S, 1 + K)], dim=1)
        if not cfg.refine_focal:
            slot_mask[:, 6] = 0.0
        if not cfg.refine_extra and K:
            slot_mask[:, 7:] = 0.0
        pmask = point_free.to(dtype)
        eye_c = torch.eye(C, dtype=dtype, device=dev)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        frozen = torch.diag_embed(1.0 - slot_mask)  # (S, C, C)

        def tie(x):
            """Orthogonal projection onto the shared-intrinsics subspace: the
            logf / extra step slots are one variable across frames, so CG with
            A -> tie(A(tie(x))) and rhs -> tie(rhs) solves the constrained
            normal equations on the tied subspace."""
            if not cfg.shared_intrinsics:
                return x
            m = x[:, 6:].mean(0, keepdim=True)
            return torch.cat([x[:, :6], m.expand(S, C - 6)], dim=1)

        def seg_f(x):
            s = _segment_sum(x, of, S)
            return s if group is None else group.all_reduce(s)

        def seg_p(x):
            s = _segment_sum(x, op, P)
            return s if group is None else group.all_reduce(s)

        def project(params):
            """Each observation through its camera, one row per observation:
            (pixels (O, 2), depth (O,), the Jacobian intermediates)."""
            R_, t_, f_, pp_, k_, X_ = params
            Y = torch.einsum("oij,oj->oi", R_[of], X_[op])[:, None]
            pix, z, inter = _project_rotated(Y, t_[of], f_[of], pp_[of],
                                             k_[of])
            return pix[:, 0], z[:, 0], inter

        def linearize(params):
            R_, _, f_, _, k_, _ = params
            pix, z, inter = project(params)
            r = pix - obs_xy
            valid = w_obs * (z > 0)
            sw = (_robust_sqrt_weight((r * r).sum(-1), cfg) * valid)[:, None]
            Jc, Jp = _jacobians(R_[of], f_[of], k_[of], inter, True)
            Jc = sw[..., None] * Jc[:, 0] * slot_mask[of][:, None, :]
            Jp = sw[..., None] * Jp[:, 0] * pmask[op][:, None, None]
            return sw * r, Jc, Jp

        def total_cost(params):
            pix, z, _ = project(params)
            r = pix - obs_xy
            # behind-camera observations must cost, not vanish (as in lm.py)
            sq = torch.where(
                z > 0, torch.clamp((r * r).sum(-1), max=_BEHIND_PENALTY_SQ),
                _BEHIND_PENALTY_SQ)
            c = (sq * _robust_sqrt_weight(sq, cfg) ** 2 * w_obs).sum()
            return c if group is None else group.all_reduce(c)

        def step(params, lam):
            """The damped step by implicit-Schur PCG: camera steps (S, C) and
            point steps (P, 3)."""
            r, Jc, Jp = linearize(params)
            U = seg_f(torch.einsum("oic,oid->ocd", Jc, Jc))  # (S, C, C)
            b_c = -seg_f(torch.einsum("oic,oi->oc", Jc, r))
            V = seg_p(torch.einsum("oia,oib->oab", Jp, Jp))  # (P, 3, 3)
            b_p = -seg_p(torch.einsum("oia,oi->oa", Jp, r))
            W = torch.einsum("oic,oia->oca", Jc, Jp)  # (O, C, 3)

            U_d = U + lam * U * eye_c + cfg.diag_eps * eye_c + frozen
            Vinv = _inv3x3(V + lam * V * eye3 + cfg.diag_eps * eye3)

            def schur_matvec(x):  # x (S, C)
                x = tie(x)
                t1 = torch.einsum("scd,sd->sc", U_d, x)
                z = seg_p(torch.einsum("oca,oc->oa", W, x[of]))  # (P, 3)
                z = torch.einsum("pab,pb->pa", Vinv, z)
                u = torch.einsum("oca,oa->oc", W, z[op])  # (O, C)
                return tie(t1 - seg_f(u))

            rhs = tie(b_c - seg_f(torch.einsum(
                "oca,oa->oc", W, torch.einsum("pab,pb->pa", Vinv, b_p)[op])))

            # block-Jacobi preconditioner from the damped camera blocks
            M_inv = _spd_inverse_small(U_d, cfg.diag_eps)

            def precond(v):
                return tie(torch.einsum("scd,sd->sc", M_inv, tie(v)))

            x = torch.zeros((S, C), dtype=dtype, device=dev)
            rr = rhs
            p = precond(rhs)
            rz = (rhs * p).sum()
            for _ in range(cfg.cg_iters):
                Ap = schur_matvec(p)
                denom = (p * Ap).sum()
                alpha = rz / torch.where(denom.abs() < 1e-20, 1e-20, denom)
                x = x + alpha * p
                rr = rr - alpha * Ap
                zz = precond(rr)
                rz_new = (rr * zz).sum()
                beta = rz_new / torch.where(rz.abs() < 1e-20, 1e-20, rz)
                p = zz + beta * p
                rz = rz_new
            dc = x * slot_mask

            # back-substitute the point steps
            wdc = seg_p(torch.einsum("oca,oc->oa", W, dc[of]))
            dX = torch.einsum("pab,pb->pa", Vinv, b_p - wdc) * pmask[:, None]
            return dc, dX

        def apply(params, dc, dX):
            R_, t_, f_, pp_, k_, X_ = params
            return (axis_angle_to_matrix(dc[:, :3]) @ R_, t_ + dc[:, 3:6],
                    f_ * torch.exp(dc[:, 6]), pp_, k_ + dc[:, 7:] if K else k_,
                    X_ + dX)

        params, info = lm_loop(step, apply, total_cost,
                               (R0, t0, f0, pp0, k0, X0), cfg, group)
        R_, t_, f_, pp_, k_, X_ = params
        intr = torch.zeros((S, 3, 3), dtype=dtype, device=dev)
        intr[:, 0, 0] = f_
        intr[:, 1, 1] = f_
        intr[:, :2, 2] = pp_
        intr[:, 2, 2] = 1.0
        return (torch.cat([R_, t_[..., None]], -1), intr,
                k_ if K else None, X_, info)
