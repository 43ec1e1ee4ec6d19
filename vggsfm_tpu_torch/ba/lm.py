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
  * the LM loop (`lm_loop`, shared with ba/sparse_lm.py) runs
    `max_iterations` masked steps: a `done` flag on the device stops every
    update once the solve has converged, which gives the
    `lax.while_loop`'s results exactly, and the host reads the flag every
    `_SYNC_EVERY` iterations to leave early; on a CUDA device the
    iterations after the first are replayed from a CUDA graph;
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
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from vggsfm_tpu_torch.geometry.distortion import (
    _distortion_jacobian,
    apply_distortion,
)
from vggsfm_tpu_torch.geometry.rotations import axis_angle_to_matrix
from vggsfm_tpu_torch.utils import trace
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
# the LM loop (both solvers)
# ---------------------------------------------------------------------------


def _lm_iteration(step, apply, total_cost, cfg: BAConfig, params, cost, lam,
                  done):
    """One masked LM iteration: the step, the candidate's cost, then the
    accept / damping / convergence update. Returns the new (params, cost,
    lam, done) and ``live``, ~done as the iteration began."""
    dc, dX = step(params, lam)
    cand = apply(params, dc, dX)
    new_cost = total_cost(cand)
    better = new_cost < cost
    live = ~done
    accept = better & live
    params = tuple(torch.where(accept, a, b) for a, b in zip(cand, params))
    rel_dec = (cost - new_cost) / torch.clamp(cost, min=_EPS)
    cost = torch.where(accept, new_cost, cost)
    lam_new = torch.clamp(
        torch.where(better, lam * cfg.lambda_down, lam * cfg.lambda_up),
        cfg.lambda_min, cfg.lambda_max)
    converged = ((better & (rel_dec < cfg.function_tolerance))
                 | (~better & (lam_new >= cfg.lambda_max)))
    lam = torch.where(done, lam, lam_new)
    return params, cost, lam, done | converged, live


def _graphable(device: torch.device, group) -> bool:
    """Whether the LM loop on `device` (its initial cost's, so where every
    input is) can replay its iterations from a CUDA graph: a CUDA device,
    no process group (its collectives stay eager), no dispatch mode that
    must see each operation (the FLOP counter), and no capture already
    under way."""
    return (device.type == "cuda" and group is None
            and _get_current_dispatch_mode() is None
            and not torch.cuda.is_current_stream_capturing())


_CAPTURE: dict = {}  # device index -> (capture stream, the pool's keeper)


def _capture_pool(device: torch.device):
    """(the stream, the memory pool) the LM graphs on `device` are
    captured on and into, one of each for the process, so that each
    call's capture reuses the blocks of the last call's freed graph (the
    caching allocator reuses a block on the stream that freed it). A pool
    lives while a graph captured into it does, so a one-kernel graph,
    never replayed, keeps it; a pool of its own for each call would stay
    reserved, dead, until the card ran out of memory."""
    if device.index not in _CAPTURE:
        stream, keeper = torch.cuda.Stream(device), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            keeper.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keeper.capture_end()
        _CAPTURE[device.index] = (stream, keeper)
    stream, keeper = _CAPTURE[device.index]
    return stream, keeper.pool()


def lm_loop(step, apply, total_cost, params: tuple, cfg: BAConfig,
            group=None):
    """The LM loop of both solvers: up to `max_iterations` masked steps
    from `params` under a device `done` flag that the host reads every
    `_SYNC_EVERY` iterations. `step(params, lam)` gives the camera and
    point steps, `apply(params, dc, dX)` the candidate parameters,
    `total_cost(params)` the cost.

    Where `_graphable` holds, iteration 0 runs eagerly, warming up the
    library handles, the cached index tensors and the allocator; one
    iteration is then captured as a CUDA graph and replayed for the
    others: the same kernels at the same shapes, one launch an iteration.
    The graph lives for the call. Elsewhere every iteration runs eagerly.

    Returns (params, info) with ``info = {"cost": the cost after each
    iteration (max_iterations,), "initial_cost", "final_cost"}``; the
    iterations not run report the final cost, as the while-loop's
    untouched history does. While the tracer records, each iteration is a
    span ``ba.iter``, and the counters ``ba.iters_run``,
    ``ba.iters_useful`` (begun before `done` was set; the rest ran only
    until the host's next read of the flag) and ``ba.iters_graphed``
    (replayed from the graph) go to the enclosing span."""
    n = cfg.max_iterations
    cost0 = total_cost(params)
    dev = cost0.device
    lam = torch.tensor(cfg.lambda_init, dtype=cost0.dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iterate = functools.partial(_lm_iteration, step, apply, total_cost, cfg)

    if n > 1 and _graphable(dev, group):
        params, cost, hist, useful, n_run = _graphed_loop(
            iterate, (params, cost0, lam, done), n)
        n_graphed = n_run - 1
    else:
        cost, hist, lives = cost0, [], []
        for it in range(n):
            if it and it % _SYNC_EVERY == 0 and bool(done):
                break
            with trace.span("ba.iter"):
                params, cost, lam, done, live = iterate(params, cost, lam,
                                                        done)
            hist.append(cost)
            if trace.ON:
                lives.append(live)
        n_run, n_graphed = len(hist), 0
        useful = torch.stack(lives) if lives else None
        hist = (torch.stack(hist + [cost] * (n - n_run)) if n
                else cost0.new_zeros(0))
    if trace.ON:
        trace.count("ba.iters_run", n_run)
        trace.count("ba.iters_graphed", n_graphed)
        if useful is not None:
            trace.count("ba.iters_useful", useful)
    return params, {"cost": hist, "initial_cost": cost0, "final_cost": cost}


def _graphed_loop(iterate, state: tuple, n: int):
    """`lm_loop`'s iterations from `state` (params, cost, lam, done) on a
    CUDA device: iteration 0 eagerly, the others replayed from one
    captured iteration. The graph writes each iteration's cost and live
    flag into device buffers at a device counter. Returns (params, cost,
    the cost history (n,), the live flags of the iterations run while the
    tracer records, their count)."""
    dev = state[1].device
    hist = state[1].new_empty(n)
    live_at = torch.empty(n, dtype=torch.bool, device=dev)
    it = torch.zeros(1, dtype=torch.long, device=dev)

    def run(params, cost, lam, done):
        params, cost, lam, done, live = iterate(params, cost, lam, done)
        hist.index_copy_(0, it, cost.view(1))
        live_at.index_copy_(0, it, live.view(1))
        it.add_(1)
        return params, cost, lam, done

    with trace.span("ba.iter"):
        params, cost, lam, done = run(*state)
    # iteration 0's results are fresh tensors: the graph reads them and
    # writes each iteration's results over them
    static = (*params, cost, lam, done)
    graph = torch.cuda.CUDAGraph()
    stream, pool = _capture_pool(dev)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            new_params, *new = run(params, cost, lam, done)
            for s, v in zip(static, (*new_params, *new)):
                s.copy_(v)
            del new_params, new
        finally:
            graph.capture_end()
    n_run = 1
    while n_run < n and not (n_run % _SYNC_EVERY == 0 and bool(done)):
        with trace.span("ba.iter"):
            graph.replay()
        n_run += 1
    hist[n_run:] = cost
    return (params, cost, hist, live_at[:n_run] if trace.ON else None,
            n_run)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


@f32_matmuls
def bundle_adjust(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
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
    "initial_cost", "final_cost"}``. The call is the tracer's span
    ``ba.dense``, each LM iteration a span ``ba.iter`` (utils/trace.py)."""
    with trace.span("ba.dense"):
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
                                     pp_, k_ if K else None, X_, tracks, m,
                                     cfg, group)

        params, info = lm_loop(step, apply, total_cost, (R, t, f, pp, k, X),
                               cfg, group)
        R_, t_, f_, pp_, k_, X_ = params
        intr = torch.zeros((S, 3, 3), dtype=dtype, device=dev)
        intr[:, 0, 0] = f_
        intr[:, 1, 1] = f_
        intr[:, :2, 2] = pp_
        intr[:, 2, 2] = 1.0
        return (torch.cat([R_, t_[..., None]], -1), intr,
                k_ if K else None, X_, info)
