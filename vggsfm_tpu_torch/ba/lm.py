"""Levenberg-Marquardt bundle adjustment with a Schur complement
(PyTorch). Counterpart of vggsfm_tpu/ba/lm.py (reference: the Ceres setup
of vggsfm/utils/triangulation_helpers.py:626-635 with pycolmap's
defaults: trivial loss by default, Huber and Cauchy available; focal and
distortion refined, never the principal point).

The normal equations have the arrow shape of bundle adjustment: camera
blocks U (C x C per frame), point blocks V (3 x 3 per track), coupling
blocks W. The points are eliminated (Schur complement), the small dense
reduced camera system is solved on the device, and the point steps are
back-substituted.

What differs from the JAX solver, by design:
  * the Jacobian is written in closed form, batched over (frame, track):
    the derivatives with respect to the rotation step ω (applied as
    exp(ω) R0), t, log f, the distortion terms and X. The JAX solver takes
    `jax.jacfwd` of a per-point residual (`_residual_one`, kept here as
    the reference the tests hold the closed form against);
  * the LM loop runs `max_iterations` masked steps: a `done` flag on the
    device stops every update once the solve has converged, which gives
    the `lax.while_loop`'s results exactly, and the host reads the flag
    every `_SYNC_EVERY` iterations to leave early;
  * all points are assembled in one pass (the JAX `point_chunk` bounds
    a TPU's memory; W is 12 x S x N x C bytes, 22 MB at 8 frames x
    32,768 points);
  * the reduced camera system is solved by `torch.linalg.solve_ex`, LU as
    `jnp.linalg.solve`, with no host check of its `info`.

Frozen parameters get zero Jacobian columns; tied (shared) intrinsics act
through the tying matrix T (solve Tᵀ A T z = Tᵀ b).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vggsfm_tpu_torch.geometry.distortion import (
    _distortion_jacobian,
    apply_distortion,
)
from vggsfm_tpu_torch.geometry.rotations import axis_angle_to_matrix
from vggsfm_tpu_torch.utils import mfu, trace
from vggsfm_tpu_torch.utils.precision import f32_matmuls

_EPS = 1e-12
# squared-pixel cost charged for a behind-camera observation (and the cap on
# any single observation's squared error): ~(100 px)^2
_BEHIND_PENALTY_SQ = 1e4
# the host reads the LM loop's `done` flag every this many iterations: one
# device-to-host sync each, at most ceil(max_iterations / 4) - 1 per solve
_SYNC_EVERY = 4


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """BA options (the JAX package's, without its TPU point chunk)."""

    max_iterations: int = 30
    refine_focal: bool = True
    refine_extra: bool = True
    shared_intrinsics: bool = False
    robust_loss: str = "trivial"  # trivial | huber | cauchy
    loss_scale: float = 1.0
    lambda_init: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-9
    lambda_max: float = 1e6
    diag_eps: float = 1e-8
    # stop when an accepted step's relative cost decrease falls below this
    # (Ceres' function_tolerance), or when a rejected step has driven
    # lambda to lambda_max
    function_tolerance: float = 1e-6
    # points frozen: the normal equations decouple per camera, no point
    # Schur blocks, no back-substitution (refine_poses)
    pose_only: bool = False


# ---------------------------------------------------------------------------
# the residual model
# ---------------------------------------------------------------------------


def _z_safe(z):
    return torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)


def _project_one(R, t, f, pp, k, X):
    """One world point (3,) through one camera -> (pixel (2,), depth)."""
    Xc = R @ X + t
    z = Xc[2]
    u, v = Xc[0] / _z_safe(z), Xc[1] / _z_safe(z)
    if k.shape[0]:
        u, v = apply_distortion(k, u[None], v[None])
        u, v = u[0], v[0]
    return f * torch.stack([u, v]) + pp, z


def _residual_one(delta_c, delta_p, R0, t0, f0, pp, k0, X0, obs):
    """The residual of one observation under a camera step
    [ω(3), dt(3), dlog f(1), dk(K)] and a point step (3,): the function
    the JAX solver differentiates with `jax.jacfwd`."""
    R = axis_angle_to_matrix(delta_c[:3]) @ R0
    t = t0 + delta_c[3:6]
    f = f0 * torch.exp(delta_c[6])
    k = k0 + delta_c[7:] if k0.shape[0] else k0
    proj, _ = _project_one(R, t, f, pp, k, X0 + delta_p)
    return proj - obs


def _project(R, t, f, pp, k, X):
    """Every point through every camera: R (S, 3, 3), t (S, 3), f (S,),
    pp (S, 2), k (S, K), X (N, 3) -> (pixels (S, N, 2), depth (S, N),
    and the intermediates of the Jacobian)."""
    return _project_rotated(torch.einsum("sij,nj->sni", R, X), t, f, pp, k)


def _project_rotated(Y, t, f, pp, k):
    """`_project` from the rotated points Y = R X (S, N, 3). The sparse
    solver passes one observation per row (S = observations, N = 1)."""
    Xc = Y + t[:, None]
    z = Xc[..., 2]
    z_safe = _z_safe(z)
    u, v = Xc[..., 0] / z_safe, Xc[..., 1] / z_safe
    ud, vd = apply_distortion(k, u, v) if k.shape[-1] else (u, v)
    pix = f[:, None, None] * torch.stack([ud, vd], -1) + pp[:, None]
    return pix, z, (Y, z, z_safe, u, v, ud, vd)


def _jacobians(R, f, k, inter, points: bool):
    """Closed-form Jacobians of the pixel residuals at zero step:
    camera (S, N, 2, C) with C = 7 + K, and with `points` the point
    Jacobian (S, N, 2, 3)."""
    Y, z, z_safe, u, v, ud, vd = inter
    inv = 1.0 / z_safe
    # the clamp is constant where it acts: no derivative through z there
    g = z.abs() >= 1e-6
    zero = torch.zeros_like(u)
    du = torch.stack([inv, zero, torch.where(g, -u * inv, 0.0)], -1)
    dv = torch.stack([zero, inv, torch.where(g, -v * inv, 0.0)], -1)
    K = k.shape[-1]
    cols = []
    if K:
        J00, J01, J10, J11 = _distortion_jacobian(k, u, v)
        du, dv = (J00[..., None] * du + J01[..., None] * dv,
                  J10[..., None] * du + J11[..., None] * dv)
        r2 = u * u + v * v
        cols = [(u * r2, v * r2)]
        if K >= 2:
            cols.append((u * r2 * r2, v * r2 * r2))
        if K == 4:
            cols += [(2.0 * u * v, r2 + 2.0 * v * v),
                     (r2 + 2.0 * u * u, 2.0 * u * v)]
    fs = f[:, None, None]
    dpix = fs[..., None] * torch.stack([du, dv], -2)  # (S, N, 2, 3) d/dXc
    # d(exp(ω) R X)/dω at ω = 0 is -[R X]x: row i of the product is
    # (R X) x dpix_i
    j_rot = torch.linalg.cross(Y[:, :, None, :].expand_as(dpix), dpix,
                               dim=-1)
    j_f = fs * torch.stack([ud, vd], -1)
    Jc = [j_rot, dpix, j_f[..., None]]
    if K:
        Jc.append(fs[..., None] * torch.stack(
            [torch.stack(c, -1) for c in cols], -1))
    Jc = torch.cat(Jc, -1)
    Jp = torch.einsum("snia,sab->snib", dpix, R) if points else None
    return Jc, Jp


def _robust_sqrt_weight(sq_norm, cfg: BAConfig):
    s = cfg.loss_scale
    if cfg.robust_loss == "trivial":
        return torch.ones_like(sq_norm)
    if cfg.robust_loss == "huber":
        return torch.where(sq_norm <= s * s, 1.0, torch.sqrt(
            s / torch.sqrt(torch.clamp(sq_norm, min=_EPS))))
    if cfg.robust_loss == "cauchy":
        return 1.0 / torch.sqrt(1.0 + sq_norm / (s * s))
    raise ValueError(f"unknown robust loss {cfg.robust_loss}")


def _inv3x3(M):
    """Closed-form batched 3x3 inverse by the adjugate."""
    a, b, c = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    r0 = torch.linalg.cross(b, c)
    r1 = torch.linalg.cross(c, a)
    r2 = torch.linalg.cross(a, b)
    det = (a * r0).sum(-1, keepdim=True)[..., None]
    det = torch.where(det.abs() < _EPS, _EPS, det)
    return torch.stack([r0, r1, r2], dim=-1) / det


def _tying_matrix(S: int, K: int, shared: bool) -> np.ndarray:
    """T: the stacked per-camera steps (S*C) from the free parameters.
    The pose blocks are always per camera; the intrinsic slots (log f,
    extra) are per camera or one shared block."""
    C = 7 + K
    ni = 1 + K
    if not shared:
        return np.eye(S * C, dtype=np.float32)
    T = np.zeros((S * C, S * 6 + ni), dtype=np.float32)
    for s in range(S):
        for i in range(6):
            T[s * C + i, s * 6 + i] = 1.0
        for i in range(ni):
            T[s * C + 6 + i, S * 6 + i] = 1.0
    return T


# ---------------------------------------------------------------------------
# the cost
# ---------------------------------------------------------------------------


@f32_matmuls
def reprojection_cost(extrinsics, focal, pp, extra, points3d, tracks, mask,
                      cfg: BAConfig = BAConfig(), group=None):
    """Total (robust) squared reprojection error: tracks (S, N, 2), mask
    (S, N). A behind-camera observation costs `_BEHIND_PENALTY_SQ`, which
    also caps every observation's squared error: were it to cost nothing,
    LM could flip a camera until every point is behind it. With `group`
    (a mesh `Axis`) the points are this rank's block and the cost is the
    sum over the group."""
    k = extra if extra is not None else focal.new_zeros(focal.shape[0], 0)
    pix, z, _ = _project(extrinsics[..., :3], extrinsics[..., 3], focal, pp,
                         k, points3d)
    r = pix - tracks
    sq = torch.clamp((r * r).sum(-1), max=_BEHIND_PENALTY_SQ)
    sq = torch.where(z > 0, sq, _BEHIND_PENALTY_SQ)
    w = _robust_sqrt_weight(sq, cfg) ** 2
    cost = torch.where(mask > 0, sq * w, 0.0).sum()
    return cost if group is None else group.all_reduce(cost)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def bundle_adjust(*args, **kwargs):
    """FLOP-ledger wrapper over the solver (utils/mfu.py), as in the JAX
    package: every call is recorded under ``ba_dense``. The arguments and
    the result are `_bundle_adjust`'s. The call is the tracer's span
    ``ba.dense``, each LM iteration a span ``ba.iter`` (utils/trace.py)."""
    with trace.span("ba.dense"):
        return mfu.timed_call("ba_dense", _bundle_adjust, args, kwargs)


@f32_matmuls
def _bundle_adjust(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                  points3d: torch.Tensor, tracks: torch.Tensor,
                  mask: torch.Tensor,
                  extra_params: torch.Tensor | None = None,
                  pose_free: torch.Tensor | None = None,
                  intr_free: torch.Tensor | None = None,
                  point_free: torch.Tensor | None = None,
                  cfg: BAConfig = BAConfig(), group=None):
    """Joint refinement of cameras and points by damped Gauss-Newton.

    extrinsics (S, 3, 4) world-to-camera [R | t]; intrinsics (S, 3, 3)
    (fx == fy, COLMAP SIMPLE_*); points3d (N, 3); tracks (S, N, 2)
    observed pixels; mask (S, N) observation validity; extra_params
    optional (S, K) radial distortion, K in {1, 2, 4}; pose_free (S,)
    bool, False freezes a camera's pose (default: frame 0 frozen);
    intr_free (S,) freezes intrinsics; point_free (N,) freezes points.

    With `group` (a mesh `Axis`), the points, tracks, mask and point_free
    are this rank's block of the points: the camera blocks, the Schur
    terms and the cost are summed over the group, the reduced camera
    system is solved on every rank alike, and the point steps stay local.
    Every rank leaves the loop at the same iteration (the flag is read
    from the summed cost).

    Returns (extrinsics, intrinsics, extra_params, points3d, info) with
    ``info = {"cost": the cost after each iteration (max_iterations,),
    "initial_cost", "final_cost"}``."""
    S, N = mask.shape
    dev = tracks.device
    K = 0 if extra_params is None else extra_params.shape[-1]
    C = 7 + K
    dtype = torch.float32

    tracks = tracks.to(dtype)
    m = mask.to(dtype)
    R = extrinsics[..., :3].to(dtype)
    t = extrinsics[..., 3].to(dtype)
    f = intrinsics[:, 0, 0].to(dtype)
    pp = intrinsics[:, :2, 2].to(dtype)
    k = (extra_params.to(dtype) if extra_params is not None
         else torch.zeros((S, 0), dtype=dtype, device=dev))
    X = points3d.to(dtype)

    if cfg.shared_intrinsics:
        # the tying acts on the step, so the values are unified first
        f = torch.exp(torch.log(torch.clamp(f, min=1e-6)).mean()).expand(S)
        pp = pp.mean(0, keepdim=True).expand(S, 2)
        if K:
            k = k.mean(0, keepdim=True).expand(S, K)

    if pose_free is None:
        pose_free = torch.arange(S, device=dev) != 0
    if intr_free is None:
        intr_free = torch.ones(S, dtype=torch.bool, device=dev)
    if point_free is None:
        point_free = torch.ones(N, dtype=torch.bool, device=dev)

    slot_mask = torch.cat([
        pose_free[:, None].to(dtype).expand(S, 6),
        intr_free[:, None].to(dtype).expand(S, 1 + K)], dim=1)
    if not cfg.refine_focal:
        slot_mask[:, 6] = 0.0
    if not cfg.refine_extra and K:
        slot_mask[:, 7:] = 0.0
    pmask = point_free.to(dtype)
    frozen = torch.diag(1.0 - slot_mask.reshape(-1))
    eye_c = torch.eye(C, dtype=dtype, device=dev)
    eye_s = torch.eye(S, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eps_sc = cfg.diag_eps * torch.eye(S * C, dtype=dtype, device=dev)
    T = (torch.as_tensor(_tying_matrix(S, K, True), device=dev)
         if cfg.shared_intrinsics else None)

    def step(params, lam):
        """The damped Gauss-Newton step at `params`: camera steps (S, C)
        and point steps (N, 3)."""
        R_, t_, f_, pp_, k_, X_ = params
        pix, z, inter = _project(R_, t_, f_, pp_, k_, X_)
        r = pix - tracks
        valid = m * (z > 0)
        sw = (_robust_sqrt_weight((r * r).sum(-1), cfg) * valid)[..., None]
        Jc, Jp = _jacobians(R_, f_, k_, inter, not cfg.pose_only)
        r = sw * r
        Jc = sw[..., None] * Jc * slot_mask[:, None, None, :]
        U = torch.einsum("snic,snid->scd", Jc, Jc)
        b_c = -torch.einsum("snic,sni->sc", Jc, r)
        U_d = U + lam * U * eye_c
        A = torch.einsum("scd,st->sctd", U_d, eye_s)
        if not cfg.pose_only:
            Jp = sw[..., None] * Jp * pmask[None, :, None, None]
            V = torch.einsum("snia,snib->nab", Jp, Jp)
            b_p = -torch.einsum("snia,sni->na", Jp, r)
            W = torch.einsum("snic,snia->snca", Jc, Jp)
            Vinv = _inv3x3(V + lam * V * eye3 + cfg.diag_eps * eye3)
            Y = torch.einsum("snca,nab->sncb", W, Vinv)
            A = A - torch.einsum("snca,tnda->sctd", Y, W)
            b_c = b_c - torch.einsum("snca,na->sc", Y, b_p)
        # frozen slots: a unit diagonal keeps the system regular, the step
        # stays 0
        if group is not None:
            # the points' shares of the reduced camera system, summed over
            # the ranks in one collective
            Ab = group.all_reduce(torch.cat(
                [A.reshape(-1), b_c.reshape(-1)]))
            A, b_c = Ab[:-S * C], Ab[-S * C:]
        A = A.reshape(S * C, S * C) + frozen + eps_sc
        rhs = b_c.reshape(S * C)
        if T is not None:
            A, rhs = T.T @ A @ T, T.T @ rhs
        sol = torch.linalg.solve_ex(A, rhs[:, None])[0][:, 0]
        if T is not None:
            sol = T @ sol
        dc = sol.reshape(S, C) * slot_mask
        if cfg.pose_only:
            return dc, None
        dX = torch.einsum("nab,nb->na", Vinv,
                          b_p - torch.einsum("snca,sc->na", W, dc))
        return dc, dX

    def apply(params, dc, dX):
        R_, t_, f_, pp_, k_, X_ = params
        return (axis_angle_to_matrix(dc[:, :3]) @ R_, t_ + dc[:, 3:6],
                f_ * torch.exp(dc[:, 6]), pp_, k_ + dc[:, 7:] if K else k_,
                X_ + dX * pmask[:, None] if dX is not None else X_)

    def total_cost(params):
        R_, t_, f_, pp_, k_, X_ = params
        return reprojection_cost(torch.cat([R_, t_[..., None]], -1), f_,
                                 pp_, k_ if K else None, X_, tracks, m, cfg,
                                 group)

    params = (R, t, f, pp, k, X)
    cost0 = total_cost(params)
    cost = cost0
    lam = torch.tensor(cfg.lambda_init, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hist = []
    live_at_start = []  # while the tracer records: ~done as each began
    for it in range(cfg.max_iterations):
        if it and it % _SYNC_EVERY == 0 and bool(done):
            break
        with trace.span("ba.iter"):
            dc, dX = step(params, lam)
            cand = apply(params, dc, dX)
            new_cost = total_cost(cand)
            better = new_cost < cost
            live = ~done
            if trace.ON:
                live_at_start.append(live)
            accept = better & live
            params = tuple(torch.where(accept, a, b)
                           for a, b in zip(cand, params))
            rel_dec = (cost - new_cost) / torch.clamp(cost, min=_EPS)
            cost = torch.where(accept, new_cost, cost)
            lam_new = torch.clamp(
                torch.where(better, lam * cfg.lambda_down,
                            lam * cfg.lambda_up),
                cfg.lambda_min, cfg.lambda_max)
            converged = ((better & (rel_dec < cfg.function_tolerance))
                         | (~better & (lam_new >= cfg.lambda_max)))
            lam = torch.where(done, lam, lam_new)
            done = done | converged
            hist.append(cost)
    if trace.ON:
        # the iterations run, and those begun before `done` was set (the
        # rest ran only until the host's next read of the flag)
        trace.count("ba.iters_run", len(hist))
        if live_at_start:
            trace.count("ba.iters_useful", torch.stack(live_at_start))
    # the iterations the loop did not run report the final cost, as the
    # while-loop's untouched history does
    hist += [cost] * (cfg.max_iterations - len(hist))

    R_, t_, f_, pp_, k_, X_ = params
    intr = torch.zeros((S, 3, 3), dtype=dtype, device=dev)
    intr[:, 0, 0] = f_
    intr[:, 1, 1] = f_
    intr[:, :2, 2] = pp_
    intr[:, 2, 2] = 1.0
    info = {"cost": torch.stack(hist) if hist else cost0.new_zeros(0),
            "initial_cost": cost0, "final_cost": cost}
    return (torch.cat([R_, t_[..., None]], -1), intr, k_ if K else None, X_,
            info)
