"""The port's video-pipeline solvers against the JAX package's, on the CPU:
the sparse implicit-Schur LM (ba/sparse_lm.py), the camera-set alignment
(geometry/alignment.py), the map filter (sfm/normalize.py
`filter_map_observations`), the multi-host map merge (parallel/merge.py)
and the per-window BA's freeze semantics (`VideoRunner._window_ba`).

Inputs are made with numpy from seeds (tests/test_ba.py's `make_bundle`,
tests/test_sparse_ba.py's problems). Tolerances, each stated where it is
used: the LM solvers sum in other orders (closed-form Jacobians against
`jax.jacfwd`, `index_add_` against `segment_sum`) and run a fixed count of
f32 PCG rounds, so their costs agree to 1e-3 relative, their iterates to
5e-4 on a well-conditioned problem and to 1e-2 where one shared focal
couples to depth; the numpy code (merge, filter) is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import make_bundle
from vggsfm_tpu.ba import SparseBAConfig as JSparseCfg
from vggsfm_tpu.ba import bundle_adjust_sparse as j_bas
from vggsfm_tpu.geometry import alignment as jalign
from vggsfm_tpu.geometry import quaternion_to_matrix
from vggsfm_tpu.parallel import merge as jmerge
from vggsfm_tpu.sfm import normalize as jnorm
from vggsfm_tpu.video.runner import MapRegistry as JMapRegistry
from vggsfm_tpu_torch.ba import BAConfig, SparseBAConfig, bundle_adjust
from vggsfm_tpu_torch.ba import bundle_adjust_sparse as t_bas
from vggsfm_tpu_torch.geometry import alignment as talign
from vggsfm_tpu_torch.parallel import merge as tmerge
from vggsfm_tpu_torch.sfm import normalize as tnorm
from vggsfm_tpu_torch.video.runner import MapRegistry, VideoConfig, \
    VideoRunner


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops: intra-op threads gain them nothing beside other
    test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def dense_to_obs(tracks, mask):
    """(S, N, 2) + (S, N) -> flat observation lists."""
    fr, pt = np.nonzero(mask)
    return (fr.astype(np.int32), pt.astype(np.int32),
            tracks[fr, pt].astype(np.float32), np.ones(len(fr), np.float32))


def both_sparse(extr, intr, X, obs, extra=None, pose_free=None, **cfg):
    """The same problem through both packages' sparse solvers."""
    fr, pt, xy, w = obs
    j = j_bas(jnp.asarray(extr, jnp.float32), jnp.asarray(intr, jnp.float32),
              jnp.asarray(X, jnp.float32), jnp.asarray(fr), jnp.asarray(pt),
              jnp.asarray(xy), jnp.asarray(w),
              extra_params=None if extra is None else jnp.asarray(extra),
              pose_free=None if pose_free is None else jnp.asarray(
                  pose_free), cfg=JSparseCfg(**cfg))
    t = t_bas(_t(extr), _t(intr), _t(X), _t(fr, torch.long),
              _t(pt, torch.long), _t(xy), _t(w),
              extra_params=None if extra is None else _t(extra),
              pose_free=None if pose_free is None else _t(pose_free,
                                                          torch.bool),
              cfg=SparseBAConfig(**cfg))
    return j, t


# --------------------------------------------------------------- sparse BA


@pytest.mark.parametrize("case", ["plain", "shared_unify", "radial_shared"])
def test_sparse_ba_matches_jax(case):
    """tests/test_sparse_ba.py's problems through both solvers, at the
    video joint BA's robust loss: per-frame focal perturbations (shared:
    unified by mean log over the frames whose focal > 1e-3, a zero-K
    unregistered frame among them), one radial term. Initial costs equal
    within 1e-5 relative (same residual model), final costs within 1e-3
    relative. Without tying the iterates agree to 5e-4 (poses, points in a
    10-unit-deep scene) and 5e-5 relative (focal). With one shared focal
    the solution lies in a shallow focal-depth valley (the final costs
    agree to 2e-4 while the parameters slide along it): poses within 1e-2,
    points within 5e-2, focals within 2e-3 relative, k within 1e-3."""
    rng = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng, S=5, N=200, noise_px=0.2)
    X_n = X + rng.normal(scale=0.03, size=X.shape)
    extra = None
    shared = case != "plain"
    if shared:
        intr[:, 0, 0] = intr[:, 1, 1] = intr[0, 0, 0] * np.array(
            [1.0, 1.08, 0.93, 1.04, 0.97])
        intr[4] = 0.0  # an unregistered video frame: zero K, no obs
        mask[4] = False
    if case == "radial_shared":
        extra = np.full((5, 1), 0.01, np.float32)
    j, t = both_sparse(extr, intr, X_n, dense_to_obs(tracks, mask),
                       extra=extra, max_iterations=8, refine_focal=True,
                       shared_intrinsics=shared, cg_iters=30,
                       robust_loss="cauchy", loss_scale=4.0)
    j0, t0 = float(j[4]["initial_cost"]), float(t[4]["initial_cost"])
    assert abs(t0 - j0) <= 1e-5 * j0
    jf, tf = float(j[4]["final_cost"]), float(t[4]["final_cost"])
    assert abs(tf - jf) <= 1e-3 * jf, (jf, tf)
    assert tf < 0.1 * t0
    pose_tol, point_tol, f_tol = ((1e-2, 5e-2, 2e-3) if shared
                                  else (5e-4, 5e-4, 5e-5))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=pose_tol)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]),
                               atol=point_tol)
    np.testing.assert_allclose(t[1][:4, 0, 0].numpy(),
                               np.asarray(j[1])[:4, 0, 0], rtol=f_tol)
    if shared:
        f = t[1][:, 0, 0].numpy()
        np.testing.assert_allclose(f, f[0], rtol=1e-6)
    if extra is not None:
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]),
                                   atol=1e-3)


def test_sparse_matches_dense_solver():
    """tests/test_sparse_ba.py::test_matches_dense_solver on the port:
    the sparse and dense solvers reach the same noise floor (final cost
    within 10%) and the same translations (5e-3)."""
    rng = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng, S=5, N=120, noise_px=0.3)
    extr_n = extr.copy()
    extr_n[1:, :, 3] += rng.normal(scale=0.03, size=(4, 3))
    X_n = X + rng.normal(scale=0.05, size=X.shape)
    d = bundle_adjust(_t(extr_n), _t(intr), _t(X_n), _t(tracks),
                      _t(mask, torch.bool),
                      cfg=BAConfig(max_iterations=10, refine_focal=False))
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    s = t_bas(_t(extr_n), _t(intr), _t(X_n), _t(fr, torch.long),
              _t(pt, torch.long), _t(xy), _t(w),
              cfg=SparseBAConfig(max_iterations=10, refine_focal=False,
                                 cg_iters=60))
    assert float(s[4]["final_cost"]) < 1.1 * float(d[4]["final_cost"]) + 1e-3
    np.testing.assert_allclose(s[0][:, :, 3].numpy(), d[0][:, :, 3].numpy(),
                               atol=5e-3)


def test_padded_observations_are_inert():
    """Weight-0 garbage observations change nothing (1e-6)."""
    rng = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng, S=4, N=60)
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    cfg = SparseBAConfig(max_iterations=5, refine_focal=False)

    def solve(fr, pt, xy, w):
        return t_bas(_t(extr), _t(intr), _t(X), _t(fr, torch.long),
                     _t(pt, torch.long), _t(xy), _t(w), cfg=cfg)

    pad = 37
    base = solve(fr, pt, xy, w)
    padded = solve(np.concatenate([fr, np.zeros(pad, np.int32)]),
                   np.concatenate([pt, np.zeros(pad, np.int32)]),
                   np.concatenate([xy, 1e4 * np.ones((pad, 2), np.float32)]),
                   np.concatenate([w, np.zeros(pad, np.float32)]))
    np.testing.assert_allclose(padded[3].numpy(), base[3].numpy(), atol=1e-6)


def test_shared_intrinsics_tying_recovers_focal():
    """One focal step for all frames: every frame's focal identical
    (1e-6) and a 5% mis-scale corrected to within 2%."""
    rng = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng, S=5, N=200, noise_px=0.2)
    f_true = intr[0, 0, 0]
    intr_n = intr.copy()
    intr_n[:, 0, 0] = intr_n[:, 1, 1] = f_true * 1.05
    X_n = X + rng.normal(scale=0.03, size=X.shape)
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    out = t_bas(_t(extr), _t(intr_n), _t(X_n), _t(fr, torch.long),
                _t(pt, torch.long), _t(xy), _t(w),
                cfg=SparseBAConfig(max_iterations=12, refine_focal=True,
                                   shared_intrinsics=True, cg_iters=60))
    f_out = out[1][:, 0, 0].numpy()
    np.testing.assert_allclose(f_out, f_out[0], rtol=1e-6)
    assert abs(f_out[0] - f_true) < 0.02 * f_true
    assert float(out[4]["final_cost"]) < 0.5 * float(out[4]["initial_cost"])


def test_behind_camera_cost_matches_jax():
    """A flipped camera must cost more than the truth, by the same amount
    in both packages (initial costs within 1e-5 relative)."""
    rng = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng, S=4, N=60)
    flipped = extr.copy()
    F = np.diag([1.0, -1.0, -1.0])
    flipped[1, :, :3] = F @ flipped[1, :, :3]
    flipped[1, :, 3] = F @ flipped[1, :, 3]
    obs = dense_to_obs(tracks, mask)
    costs = {}
    for name, e in (("truth", extr), ("flipped", flipped)):
        j, t = both_sparse(e, intr, X, obs, max_iterations=1,
                           refine_focal=False)
        costs[name] = float(t[4]["initial_cost"])
        jc = float(j[4]["initial_cost"])
        assert abs(costs[name] - jc) <= 1e-5 * max(jc, 1.0)
    assert costs["flipped"] > costs["truth"] + 1.0


# --------------------------------------------------------------- alignment


def _random_extrinsics(rng, B):
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(quaternion_to_matrix(jnp.asarray(q)))
    t = rng.normal(size=(B, 3))
    return np.concatenate([R, t[..., None]], axis=-1).astype(np.float32)


@pytest.mark.parametrize("n_anchor,estimate_scale", [(8, True), (8, False),
                                                     (1, True)])
def test_alignment_matches_jax(n_anchor, estimate_scale):
    """`align_camera_extrinsics` + `apply_transformation` on a
    similarity-moved noisy camera set: (R, T, s) and the aligned cameras
    within 1e-5 of the JAX package's (f32, TF32 off); with one anchor the
    scale is 1 in both."""
    rng = np.random.default_rng(n_anchor + 10 * estimate_scale)
    src = _random_extrinsics(rng, n_anchor)
    q = rng.normal(size=(1, 4))
    R_g = np.asarray(quaternion_to_matrix(jnp.asarray(q / np.linalg.norm(
        q))))[0].astype(np.float32)
    tgt = np.asarray(jalign.apply_transformation(
        jnp.asarray(src), jnp.asarray(R_g),
        jnp.asarray(rng.normal(size=3), jnp.float32), jnp.float32(1.6)))
    tgt = tgt + rng.normal(scale=1e-3, size=tgt.shape).astype(np.float32)
    jR, jT, js = jalign.align_camera_extrinsics(
        jnp.asarray(src), jnp.asarray(tgt), estimate_scale=estimate_scale)
    tR, tT, ts = talign.align_camera_extrinsics(
        _t(src), _t(tgt), estimate_scale=estimate_scale)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    np.testing.assert_allclose(float(ts), float(js), atol=1e-5)
    if n_anchor == 1 or not estimate_scale:
        assert float(ts) == 1.0
    ja = jalign.apply_transformation(jnp.asarray(src), jR, jT, js)
    ta = talign.apply_transformation(_t(src), tR, tT, ts)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)


# ------------------------------------------------------------------ filter


def _radial_registry(reg_cls, seed=0, P=60, S=6):
    """A map with a radial term: P points seen by S cameras on a baseline,
    observations through SIMPLE_RADIAL k = -0.05 plus 0.5 px noise, some
    gross outliers, one behind-camera point, one low-parallax far point
    and one point seen once."""
    rng = np.random.default_rng(seed)
    f, c, k = 120.0, 64.0, -0.05
    extr = np.zeros((S, 3, 4), np.float32)
    for s in range(S):
        extr[s, :, :3] = np.eye(3)
        extr[s, :, 3] = [-0.5 * s, 0, 0]
    pts = rng.uniform([-2, -2, 6], [2, 2, 10], size=(P, 3))
    pts[0] = [0.0, 0.0, 1000.0]  # low parallax
    pts[1] = [0.0, 0.0, -5.0]  # behind every camera
    of, op, oxy = [], [], []
    for p in range(P):
        frames = [0] if p == 2 else range(S)
        for s in frames:
            Xc = extr[s, :, :3] @ pts[p] + extr[s, :, 3]
            u, v = Xc[:2] / Xc[2]
            r2 = u * u + v * v
            of.append(s)
            op.append(p)
            oxy.append(f * np.array([u, v]) * (1 + k * r2) + c)
    oxy = np.asarray(oxy) + rng.normal(scale=0.5, size=(len(oxy), 2))
    bad = rng.choice(len(oxy), size=len(oxy) // 10, replace=False)
    oxy[bad] += rng.normal(scale=8.0, size=(len(bad), 2))
    reg = reg_cls()
    reg.add_points(pts.astype(np.float32))
    reg.add_observations(np.asarray(of), np.asarray(op), oxy)
    intr = np.tile(np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]], np.float32),
                   (S, 1, 1))
    return reg, extr, intr, np.full((S, 1), k, np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_map_observations_matches_jax(seed):
    """The same dropped counts, xyz, observations and remap, exactly, on
    a registry with a radial term (the per-point angle test is vectorized
    in the port; its decisions equal the JAX package's loop)."""
    jreg, extr, intr, extra = _radial_registry(JMapRegistry, seed)
    treg, _, _, _ = _radial_registry(MapRegistry, seed)
    js = jnorm.filter_map_observations(jreg, extr, intr, extra,
                                       max_reproj_error=2.0,
                                       min_tri_angle=1.5)
    ts = tnorm.filter_map_observations(treg, extr, intr, extra,
                                       max_reproj_error=2.0,
                                       min_tri_angle=1.5)
    assert ts == js
    assert js["dropped_obs"] > 0 and js["dropped_points"] >= 3
    for key in ("xyz", "obs_frame", "obs_point", "obs_xy"):
        np.testing.assert_array_equal(getattr(treg, key), getattr(jreg, key))


def test_max_pairwise_angles_match_the_per_point_pass():
    """The vectorized diameter pass against `_max_pairwise_angle_deg` per
    point, direction bundles with repeated rows (ties) included: within
    1e-5 degrees (the two sum the same terms in other orders)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(2, 9, size=400)
    sp = np.repeat(np.arange(400), counts)
    d = rng.normal(size=(len(sp), 3)) * 0.05 + [0.0, 0.0, 1.0]
    d[1::7] = d[0::7][:len(d[1::7])]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    starts = np.searchsorted(sp, np.arange(400))
    ends = np.searchsorted(sp, np.arange(400) + 1)
    got = tnorm._max_pairwise_angles_deg(d, sp, np.arange(400))
    want = [tnorm._max_pairwise_angle_deg(d[a:b]) for a, b in zip(starts,
                                                                 ends)]
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------------- merge


def test_frame_blocks_match_jax():
    """tests/test_merge.py's block cases: contiguous partition, a single
    host, fewer frames than hosts; equal to the JAX package's."""
    for T, S0, hosts in ((30, 4, 3), (20, 4, 1), (5, 4, 4), (144, 32, 2)):
        blocks = [tmerge.frame_block(T, S0, hosts, h) for h in range(hosts)]
        assert blocks == [jmerge.frame_block(T, S0, hosts, h)
                          for h in range(hosts)]
        covered = [f for b0, b1 in blocks for f in range(b0, b1)]
        assert covered == list(range(S0, T))


def _partial(host, T, P0, new_pts, block, obs, extr_val):
    """tests/test_merge.py's partial map of one host."""
    reg = MapRegistry()
    reg.add_points(np.arange(P0 * 3, dtype=np.float32).reshape(P0, 3))
    reg.add_points(new_pts)
    reg.add_observations(*obs)
    extr = np.zeros((T, 3, 4), np.float32)
    registered = np.zeros((T,), bool)
    registered[block[0]:block[1]] = True
    if host == 0:
        registered[:4] = True
    extr[registered] = extr_val
    return {"xyz": reg.xyz, "obs_frame": reg.obs_frame,
            "obs_point": reg.obs_point, "obs_xy": reg.obs_xy,
            "extrinsics": extr,
            "intrinsics": np.tile(np.eye(3, dtype=np.float32), (T, 1, 1)),
            "extra": np.zeros((0,)), "registered": registered,
            "shared_points": np.int64(P0),
            "block": np.asarray(block, np.int64)}


def test_merge_partials_offsets_ids_and_matches_jax():
    """Host 1's new points are offset past host 0's, its duplicate
    init-window observation is dropped, block poses come from the owner;
    every array equals the JAX merge's."""
    T, P0 = 12, 5
    p0 = _partial(0, T, P0, np.ones((2, 3), np.float32), (4, 8),
                  (np.array([0, 4, 5]), np.array([1, 0, P0]),
                   np.zeros((3, 2), np.float32)), 1.0)
    p1 = _partial(1, T, P0, np.full((3, 3), 7.0, np.float32), (8, 12),
                  (np.array([1, 8, 9]), np.array([1, 2, P0]),
                   np.ones((3, 2), np.float32)), 2.0)
    reg, extr, intr, extra, registered = tmerge.merge_partial_maps(
        [p0, p1], MapRegistry)
    jreg, jextr, _, jextra, jregd = jmerge.merge_partial_maps(
        [p0, p1], JMapRegistry)
    assert reg.num_points == P0 + 2 + 3 and registered.all()
    assert set(reg.obs_point.tolist()) == {1, 0, P0, 2, P0 + 2}
    assert (reg.obs_frame == 1).sum() == 0
    np.testing.assert_allclose(extr[8], 2.0)
    np.testing.assert_allclose(extr[4], 1.0)
    assert extra is None and jextra is None
    for key in ("xyz", "obs_frame", "obs_point", "obs_xy"):
        np.testing.assert_array_equal(getattr(reg, key), getattr(jreg, key))
    np.testing.assert_array_equal(extr, jextr)
    np.testing.assert_array_equal(registered, jregd)


def test_save_wait_roundtrip_and_timeout(tmp_path):
    """A published partial loads back (its shared-point count); a missing
    one times out with TimeoutError."""
    T, P0 = 8, 3
    reg = MapRegistry()
    reg.add_points(np.zeros((P0, 3), np.float32))
    tmerge.save_partial(str(tmp_path), 0, reg, np.zeros((T, 3, 4)),
                        np.zeros((T, 3, 3)), None, np.ones((T,), bool), P0,
                        (4, 8))
    parts = tmerge.wait_for_partials(str(tmp_path), 1, timeout_s=5)
    assert int(parts[0]["shared_points"]) == P0
    with pytest.raises(TimeoutError):
        tmerge.wait_for_partials(str(tmp_path), 2, timeout_s=0.2)


@pytest.mark.parametrize("case", ["coincident", "shared", "distant"])
def test_fuse_duplicate_points(case):
    """tests/test_merge.py's fusion cases: a coincident new pair fuses to
    one id (its observations re-targeted), shared points never fuse,
    distant points stay; the registry equals the JAX fusion's."""
    regs = []
    for cls in (MapRegistry, JMapRegistry):
        reg = cls()
        if case == "coincident":
            reg.add_points(np.zeros((2, 3), np.float32))
            reg.add_points(np.array([[1.0, 1.0, 1.0], [1.001, 1.0, 1.0],
                                     [5.0, 5.0, 5.0]], np.float32))
            reg.add_observations(np.array([0, 1, 2, 3]),
                                 np.array([2, 3, 4, 0]),
                                 np.zeros((4, 2), np.float32))
            shared, tol = 2, 0.02
        elif case == "shared":
            reg.add_points(np.zeros((3, 3), np.float32))
            shared, tol = 3, 1.0
        else:
            reg.add_points(np.zeros((1, 3), np.float32))
            reg.add_points(np.array([[1.0, 0, 0], [2.0, 0, 0]], np.float32))
            shared, tol = 1, 0.02
        fuse = (tmerge if cls is MapRegistry else jmerge).fuse_duplicate_points
        regs.append((fuse(reg, shared_points=shared, tol=tol), reg))
    (ts, treg), (js, jreg) = regs
    assert ts == js
    assert ts["fused"] == (1 if case == "coincident" else 0)
    for key in ("xyz", "obs_point"):
        np.testing.assert_array_equal(getattr(treg, key), getattr(jreg, key))
    if case == "coincident":
        assert treg.num_points == 4 and treg.obs_point[0] == treg.obs_point[1]


# --------------------------------------------------------------- window BA


@pytest.fixture(scope="module")
def window_problem():
    """tests/test_window_ba.py's window: 4 frames, 40 map points, 30
    fresh points, exact projections."""
    rng = np.random.default_rng(3)
    Sw, n_map, n_fresh = 4, 40, 30
    f, c = 120.0, 64.0
    K = np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]])
    X_map = rng.uniform([-2, -2, 6], [2, 2, 10],
                        size=(n_map, 3)).astype(np.float32)
    X_fresh = rng.uniform([-2, -2, 6], [2, 2, 10],
                          size=(n_fresh, 3)).astype(np.float32)
    extr_gt = np.zeros((Sw, 3, 4), np.float32)
    for s in range(Sw):
        a = 0.05 * s
        extr_gt[s, :, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                      [-np.sin(a), 0, np.cos(a)]])
        extr_gt[s, :, 3] = [-0.4 * s, 0.0, 0.0]

    def proj(extr, X):
        Xc = np.einsum("ij,pj->pi", extr[:, :3], X) + extr[:, 3]
        return f * Xc[:, :2] / Xc[:, 2:] + c

    return dict(Sw=Sw, K=K, X_map=X_map, X_fresh=X_fresh, extr_gt=extr_gt,
                map_tracks=np.stack([proj(e, X_map) for e in extr_gt]
                                    ).astype(np.float32),
                fresh_tracks=np.stack([proj(e, X_fresh) for e in extr_gt]
                                      ).astype(np.float32))


def _window_ba(problem, keep, pose_noise=0.02, point_noise=0.1):
    rng = np.random.default_rng(11)
    Sw = problem["Sw"]
    extr0 = problem["extr_gt"].copy()
    extr0[1:, :, 3] += rng.normal(scale=pose_noise,
                                  size=extr0[1:, :, 3].shape)
    pts0 = (problem["X_fresh"] + rng.normal(
        scale=point_noise, size=problem["X_fresh"].shape)).astype(np.float32)
    runner = VideoRunner.__new__(VideoRunner)
    runner.cfg = VideoConfig()
    runner.device = torch.device("cpu")
    n_map = len(problem["X_map"])
    extr_o, pts_o = runner._window_ba(
        extr0, np.tile(problem["K"], (Sw, 1, 1)).astype(np.float32), None,
        problem["X_map"], problem["map_tracks"],
        np.ones((Sw, n_map), bool), pts0, problem["fresh_tracks"],
        np.ones((Sw, len(pts0)), bool) & keep[None], keep)
    return extr0, pts0, extr_o, pts_o


def test_window_ba_freezes_query_pose_and_map(window_problem):
    """tests/test_window_ba.py on the port: the query pose does not move
    (1e-7), the new poses' and kept fresh points' errors fall below a
    fifth, only the fresh block comes back, and unkept fresh points stay
    put (1e-6)."""
    p = window_problem
    n_fresh = len(p["X_fresh"])
    extr0, pts0, extr_o, pts_o = _window_ba(p, np.ones((n_fresh,), bool))
    gt = p["extr_gt"]
    np.testing.assert_allclose(extr_o[0], extr0[0], atol=1e-7)
    assert (np.linalg.norm(extr_o[1:, :, 3] - gt[1:, :, 3])
            < 0.2 * np.linalg.norm(extr0[1:, :, 3] - gt[1:, :, 3]))
    assert (np.linalg.norm(pts_o - p["X_fresh"])
            < 0.2 * np.linalg.norm(pts0 - p["X_fresh"]))
    assert pts_o.shape == pts0.shape
    keep = np.ones((n_fresh,), bool)
    keep[:5] = False
    _, pts0, _, pts_o = _window_ba(p, keep)
    np.testing.assert_allclose(pts_o[:5], pts0[:5], atol=1e-6)
    assert (np.linalg.norm(pts_o[5:] - p["X_fresh"][5:])
            < np.linalg.norm(pts0[5:] - p["X_fresh"][5:]))
