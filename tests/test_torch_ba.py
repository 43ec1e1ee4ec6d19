"""The port's bundle adjuster (vggsfm_tpu_torch/ba/lm.py) against the JAX
package's, on the same seeded scenes, on the CPU.

The port writes the Jacobian in closed form where the JAX solver takes
`jax.jacfwd`: it is held against `torch.func.jacfwd` of the same per-point
residual (relative 1e-5 of the largest entry: f32 sums in another
order). The solver is held against `vggsfm_tpu.ba.lm._bundle_adjust` at
S = 4 frames, N = 200 points, 5 LM iterations. These are f32 normal
equations of condition ~1e6 stopped before convergence, with a free
scale (only frame 0 is fixed), so one rounding moves the solution along
its weak directions; the tolerances are set from that: the cost history
within 1e-4 relative; the points reprojected through the cameras (a
gauge-free comparison) within 0.1 px; rotations within 2e-4,
translations within 1e-3 (up to 1.6 long), points within 2e-3 relative,
focal within 5e-4 relative, distortion within 1e-2 (OPENCV's tangential
terms are weakly constrained in 5 iterations; the reprojection bound
holds what they do to the pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from vggsfm_tpu.ba import lm as jlm
from vggsfm_tpu_torch.ba import lm as tlm
from vggsfm_tpu_torch.geometry.cameras import project_points


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_ba_scene(seed, S=4, N=200, K=0, noise=0.5, outlier_frac=0.05,
                  behind=0):
    """S views (focal 640, 640 x 480) of N points 6-10 in front, 0.5 px
    noise, 10% of the observations masked out, the first
    `outlier_frac` of the points 20-60 px off in frames >= 1. The
    cameras start with 3 cm translation noise and a 2% focal error, the
    points with 5 cm noise; `behind` points start behind frame 1."""
    rng = np.random.default_rng(seed)
    W, H, f = 640, 480, 640.0
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (N, 3))
    extr = np.zeros((S, 3, 4))
    intr = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]),
                   (S, 1, 1))
    for s in range(S):
        a = 0.1 * s
        extr[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        extr[s, :, 3] = [-0.5 * s, 0.02 * s, 0.03 * s]
    cam = np.einsum("sij,nj->sni", extr[:, :, :3], X) + extr[:, None, :, 3]
    tracks = cam[..., :2] / cam[..., 2:] * f + np.array([W / 2, H / 2])
    tracks += rng.normal(scale=noise, size=tracks.shape)
    mask = rng.uniform(size=(S, N)) > 0.1
    n_out = int(outlier_frac * N)
    tracks[1:, :n_out] += rng.uniform(20, 60, (S - 1, n_out, 2))
    extr0 = extr.copy()
    extr0[1:, :, 3] += rng.normal(scale=0.03, size=(S - 1, 3))
    X0 = X + rng.normal(scale=0.05, size=X.shape)
    X0[N - behind:, 2] = -X0[N - behind:, 2] - 20.0
    intr0 = intr.copy()
    intr0[:, 0, 0] *= 1.02
    intr0[:, 1, 1] *= 1.02
    extra = rng.normal(scale=0.01, size=(S, K)) if K else None
    out = [extr0, intr0, X0, tracks, mask, extra]
    return [None if a is None else a.astype(np.float32) for a in out]


def _run_both(scene, iters=5, **cfg):
    extr, intr, X, tracks, mask, extra = scene
    kw = {}
    if cfg.get("pose_only"):
        kw["point_free"] = np.zeros(X.shape[0], bool)
    j = jlm._bundle_adjust(
        jnp.asarray(extr), jnp.asarray(intr), jnp.asarray(X),
        jnp.asarray(tracks), jnp.asarray(mask),
        extra_params=None if extra is None else jnp.asarray(extra),
        cfg=jlm.BAConfig(max_iterations=iters, **cfg),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tlm.bundle_adjust(
        torch.from_numpy(extr), torch.from_numpy(intr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(mask),
        extra_params=None if extra is None else torch.from_numpy(extra),
        cfg=tlm.BAConfig(max_iterations=iters, **cfg),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    return j, t


def _assert_same_solve(j, t):
    je, ji, jk, jX = (None if a is None else torch.from_numpy(np.array(a))
                      for a in j[:4])
    te, ti, tk, tX, tinfo = t
    np.testing.assert_allclose(tinfo["cost"].numpy(),
                               np.asarray(j[4]["cost"]), rtol=1e-4)
    np.testing.assert_allclose(float(tinfo["initial_cost"]),
                               float(j[4]["initial_cost"]), rtol=1e-5)
    torch.testing.assert_close(project_points(tX, te, ti, tk),
                               project_points(jX, je, ji, jk), rtol=0,
                               atol=0.1)
    torch.testing.assert_close(te[..., :3], je[..., :3], rtol=0, atol=2e-4)
    torch.testing.assert_close(te[..., 3], je[..., 3], rtol=0, atol=1e-3)
    rel = (tX - jX).norm(dim=-1) / jX.norm(dim=-1)
    assert float(rel.max()) <= 2e-3, float(rel.max())
    torch.testing.assert_close(ti, ji, rtol=5e-4, atol=1e-4)
    if jk is None:
        assert tk is None
    else:
        torch.testing.assert_close(tk, jk, rtol=0, atol=1e-2)


@pytest.mark.parametrize("K", [0, 1, 2, 4])
def test_closed_form_jacobian_matches_jacfwd(K):
    """The closed-form camera and point Jacobians against forward-mode
    autodiff of `_residual_one` at the zero step, vmapped over (frame,
    point); a few points sit within the depth clamp (|z| < 1e-6), where
    the derivative through z vanishes."""
    g = torch.Generator().manual_seed(K)
    S, N = 3, 40
    R = tlm.axis_angle_to_matrix(0.3 * torch.randn(S, 3, generator=g))
    t = 0.3 * torch.randn(S, 3, generator=g)
    f = 300 + 300 * torch.rand(S, generator=g)
    pp = 200 + 100 * torch.rand(S, 2, generator=g)
    k = 0.05 * torch.randn(S, K, generator=g)
    X = torch.randn(N, 3, generator=g) + torch.tensor([0.0, 0.0, 5.0])
    # frame 0's camera puts the last two points at depth ~1e-7
    X[-2:] = torch.linalg.solve(R[0], torch.tensor(
        [[0.3, 0.2, 1e-7], [-0.1, 0.4, -1e-7]]).T - t[0][:, None]).T
    obs = 500 * torch.rand(S, N, 2, generator=g)

    pix, z, inter = tlm._project(R, t, f, pp, k, X)
    Jc, Jp = tlm._jacobians(R, f, k, inter, points=True)
    assert bool((z[0, -2:].abs() < 1e-6).all())

    zc, zp = torch.zeros(7 + K), torch.zeros(3)

    def per_obs(X0, o, R0, t0, f0, pp0, k0):
        return jacfwd(tlm._residual_one, argnums=(0, 1))(
            zc, zp, R0, t0, f0, pp0, k0, X0, o)

    def resid(X0, o, R0, t0, f0, pp0, k0):
        return tlm._residual_one(zc, zp, R0, t0, f0, pp0, k0, X0, o)

    over_pts = (0, 0, None, None, None, None, None)
    over_cams = (None, 0, 0, 0, 0, 0, 0)
    Jc_ref, Jp_ref = vmap(vmap(per_obs, over_pts), over_cams)(
        X, obs, R, t, f, pp, k)
    r_ref = vmap(vmap(resid, over_pts), over_cams)(X, obs, R, t, f, pp, k)
    for out, ref in ((Jc, Jc_ref), (Jp, Jp_ref), (pix - obs, r_ref)):
        assert out.shape == ref.shape
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("case", ["schur", "pose_only", "huber", "cauchy",
                                  "shared_radial", "opencv"])
def test_bundle_adjust_matches_jax(case):
    """The Schur path, the pose-only path, the robust losses, the shared
    intrinsics (with SIMPLE_RADIAL's distortion) and OPENCV's four
    distortion terms; three points start behind a camera (the penalty
    and the cap of the cost)."""
    cfg = {"schur": {}, "pose_only": {"pose_only": True},
           "huber": {"robust_loss": "huber", "loss_scale": 3.0},
           "cauchy": {"robust_loss": "cauchy", "loss_scale": 2.0},
           "shared_radial": {"shared_intrinsics": True},
           "opencv": {}}[case]
    K = {"shared_radial": 1, "opencv": 4}.get(case, 0)
    j, t = _run_both(make_ba_scene(1, K=K, behind=3), **cfg)
    _assert_same_solve(j, t)
    assert float(t[4]["final_cost"]) < float(t[4]["initial_cost"])


def test_bundle_adjust_stops_where_the_while_loop_stops():
    """With a loose function tolerance the JAX while-loop stops after a
    few of its 12 iterations: the port's masked loop keeps the same
    parameters and reports the same history, the final cost from the
    stop on (the port leaves at its next read of `done`)."""
    j, t = _run_both(make_ba_scene(2), iters=12, function_tolerance=0.05)
    _assert_same_solve(j, t)
    hist = np.asarray(j[4]["cost"])
    stop = int(np.argmax(hist == hist[-1]))
    assert 1 <= stop <= 6, hist
    assert (t[4]["cost"][stop:] == t[4]["final_cost"]).all()


def test_frozen_and_tied_parameters():
    """Frozen poses, intrinsics and points do not move; tied intrinsics
    end equal across frames."""
    extr, intr, X, tracks, mask, _ = make_ba_scene(3)
    S, N = mask.shape
    pose_free = torch.tensor([False, True, False, True])
    point_free = torch.arange(N) % 2 == 0
    e, i, _, Xo, _ = tlm.bundle_adjust(
        torch.from_numpy(extr), torch.from_numpy(intr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(mask),
        pose_free=pose_free, intr_free=torch.tensor([True] * 3 + [False]),
        point_free=point_free, cfg=tlm.BAConfig(max_iterations=3))
    assert torch.equal(e[~pose_free], torch.from_numpy(extr)[~pose_free])
    assert torch.equal(i[3], torch.from_numpy(intr)[3])
    assert torch.equal(Xo[~point_free], torch.from_numpy(X)[~point_free])
    assert not torch.equal(Xo[point_free], torch.from_numpy(X)[point_free])
    _, i, _, _, _ = tlm.bundle_adjust(
        torch.from_numpy(extr), torch.from_numpy(intr), torch.from_numpy(X),
        torch.from_numpy(tracks), torch.from_numpy(mask),
        cfg=tlm.BAConfig(max_iterations=3, shared_intrinsics=True))
    assert torch.equal(i[:, 0, 0], i[:1, 0, 0].expand(S))


def test_inv3x3_and_tying_matrix():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(50, 3, 3)).astype(np.float32)
    M[0] = 0.0  # singular: the determinant floor
    np.testing.assert_allclose(tlm._inv3x3(torch.from_numpy(M)).numpy(),
                               np.asarray(jlm._inv3x3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-5)
    for S, K, shared in ((3, 0, False), (3, 1, True), (4, 4, True)):
        np.testing.assert_array_equal(tlm._tying_matrix(S, K, shared),
                                      jlm._tying_matrix(S, K, shared))
