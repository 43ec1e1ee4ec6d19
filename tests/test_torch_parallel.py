"""The port's multi-device pieces (parallel/mesh.py, parallel/multihost.py,
the `group` arguments of the attention, the coarse predictor and both
solvers) on a 2-rank gloo group on the CPU, against the same calls on one
rank and against the JAX package.

One 2-rank job (tests/torch_parallel_cases.py `parallel_job`) serves
every case of this module. Tolerances: the attention 1e-5 (f32, the
softmax's sums reassociated over two ranks); the coarse predictor after
one iteration 1e-4 px, after six a stated share of the coordinates within
1e-2 px (the flow embedding amplifies rounding-level differences from
one iteration to the next: at this flow head's scale a 1e-6 px nudge of
the queries moves the one-rank run's own tracks by up to 3e-3 px after six
iterations, at 5x the scale by 0.13 px); the dense BA with the group against
without: cameras 1e-4, cost 1e-5 relative; the sharded sparse BA against
the JAX `distributed_bundle_adjust` on a 2-device mesh at
tests/test_multihost.py's tolerances (extrinsics 2e-3, points 5e-3, cost
1e-3 relative) and inputs.
"""

import os
import sys

import numpy as np
import pytest
import torch

from vggsfm_tpu.ba import SparseBAConfig as JSparseCfg
from vggsfm_tpu.parallel.mesh import make_mesh as j_make_mesh
from vggsfm_tpu.parallel.multihost import (
    distributed_bundle_adjust as j_dist_ba,
)
from vggsfm_tpu.parallel.multihost import windows_for_host as j_windows
from vggsfm_tpu_torch.ba import BAConfig, bundle_adjust
from vggsfm_tpu_torch.models.layers import TorchMultiheadAttention
from vggsfm_tpu_torch.models.tracker import BaseTrackerPredictor, init_tracker_
from vggsfm_tpu_torch.parallel import mesh as tmesh
from vggsfm_tpu_torch.parallel.multihost import (
    distributed_bundle_adjust,
    init_multihost,
    windows_for_host,
)
from vggsfm_tpu_torch.video.runner import (
    MapRegistry,
    VideoConfig,
    VideoRunner,
)
from tests.test_ba import make_bundle
from tests.test_sparse_ba import dense_to_obs

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_cases as cases  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: beside the other test workers, more threads
    only oversubscribe the cores. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRED_KW = dict(stride=4, corr_levels=2, corr_radius=4, latent_dim=128,
               hidden_size=64, depth=2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _inputs():
    """Every case's inputs, made from seeds with numpy."""
    rng = np.random.default_rng(0)
    attn = TorchMultiheadAttention(32, 4)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(_t(rng.normal(scale=0.2, size=p.shape)))
    pred = BaseTrackerPredictor(**PRED_KW)
    init_tracker_(pred, torch.Generator().manual_seed(3))
    with torch.no_grad():  # a flow head that moves the tracks
        fh = pred.updateformer.flow_head.weight
        fh.copy_(_t(rng.normal(scale=0.002, size=fh.shape)))

    extr, intr, X, tracks, mask = make_bundle(rng, S=4, N=90, noise_px=0.3)
    extr_n = extr.copy()
    extr_n[1:, :, 3] += rng.normal(scale=0.02, size=(3, 3))
    X_n = X + rng.normal(scale=0.05, size=X.shape)
    mask[rng.uniform(size=mask.shape) < 0.1] = False
    ba = {"extr": _t(extr_n), "intr": _t(intr), "X": _t(X_n),
          "tracks": _t(tracks), "mask": _t(mask, torch.bool)}

    # tests/test_multihost.py's inputs (its rng draws, in its order)
    rng_m = np.random.default_rng(0)
    extr, intr, X, tracks, mask = make_bundle(rng_m, S=5, N=160,
                                              noise_px=0.3)
    extr_d = extr.copy()
    extr_d[1:, :, 3] += rng_m.normal(scale=0.03, size=(4, 3))
    X_d = X + rng_m.normal(scale=0.05, size=X.shape)
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    dist = {"extr": extr_d.astype(np.float32),
            "intr": intr.astype(np.float32), "X": X_d.astype(np.float32),
            "fr": fr, "pt": pt, "xy": xy, "w": w}
    extr, intr, X, tracks, mask = make_bundle(rng, S=3, N=61)
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    assert len(fr) % 2 != 0
    pad = {"extr": extr.astype(np.float32), "intr": intr.astype(np.float32),
           "X": X.astype(np.float32), "fr": fr, "pt": pt, "xy": xy, "w": w}

    extr, intr, X, tracks, mask = make_bundle(rng, S=6, N=150,
                                              noise_px=0.3)
    mask[rng.uniform(size=mask.shape) < 0.2] = False
    fr, pt, xy, _ = dense_to_obs(tracks, mask)
    video = {"extr": extr.astype(np.float64), "intr": intr.astype(np.float64),
             "xyz": (X + rng.normal(scale=0.03, size=X.shape)).astype(
                 np.float32),
             "fr": fr, "pt": pt, "xy": xy,
             "registered": np.ones(6, bool)}
    return {
        "attn_sd": attn.state_dict(),
        "attn_q": _t(rng.normal(size=(3, 5, 32))),
        "attn_kv": _t(rng.normal(size=(3, 12, 32))),
        "pred_kw": PRED_KW, "pred_sd": pred.state_dict(),
        "pred_q": _t(rng.uniform(10, 54, size=(1, 12, 2))),
        "pred_fmaps": _t(rng.normal(size=(1, 3, 8, 8, 128))),
        "ba": ba, "dist": dist, "pad": pad, "video": video,
    }


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank job's results, with its inputs."""
    inp = _inputs()
    res = cases.run_ranks("parallel_job", 2,
                          str(tmp_path_factory.mktemp("pg")), inp)
    return inp, res


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def test_mesh_on_two_ranks_and_block_gather_order(job):
    _, res = job
    for rank, r in enumerate(res):
        shape, p_idx, p_size, f_idx, f_size = r["mesh"]
        assert shape == {"frames": 1, "points": 2}
        assert (p_idx, p_size, f_idx, f_size) == (rank, 2, 0, 1)
        # 7 rows padded to 8, split, gathered back in order, trimmed
        _close(r["gathered"], torch.arange(21.0).reshape(7, 3), 0)


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (3, (1, 3)),
                                     (4, (2, 2)), (8, (2, 4))])
def test_mesh_shape_rule_matches_jax(n, shape):
    """The JAX layout rule (2 x n/2 for an even n >= 4) on 1-8 ranks, the
    coordinates of each rank as the JAX mesh's device grid places them."""
    assert tmesh.mesh_shape(n) == shape
    jm = j_make_mesh(n)
    assert (jm.shape["frames"], jm.shape["points"]) == shape
    ids = np.asarray([[d.id for d in row] for row in jm.devices])
    for rank in range(n):
        m = tmesh.Mesh(shape, rank, torch.device("cpu"))
        f, p = np.argwhere(ids == sorted(ids.ravel())[rank])[0]
        assert (m["frames"].index, m["points"].index) == (f, p)
        assert (m["frames"].size, m["points"].size) == shape


def test_world_size_one_without_a_process_group():
    """One rank needs no initialized group, as the JAX mesh runs on one
    device: every collective is a no-op, a block is the whole tensor."""
    assert not torch.distributed.is_initialized()
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"frames": 1, "points": 1} and m.size == 1
    x = torch.arange(6.0)
    assert m["points"].all_reduce(x.clone(), "max").equal(x)
    assert m["points"].all_gather(m["points"].block(x)).equal(x)
    assert m.broadcast(x.clone()).equal(x)
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(2, device="cpu")
    assert init_multihost(num_processes=1) is False


def test_attention_with_group_matches_without(job):
    inp, res = job
    attn = TorchMultiheadAttention(32, 4)
    attn.load_state_dict(inp["attn_sd"])
    with torch.no_grad():
        want = attn(inp["attn_q"], inp["attn_kv"], inp["attn_kv"])
    for r in res:
        _close(r["attn"], want, 1e-5)
    assert torch.equal(res[0]["attn"], res[1]["attn"])  # replicated


@pytest.fixture(scope="module")
def coarse_one_rank(job):
    inp, _ = job
    pred = BaseTrackerPredictor(**inp["pred_kw"])
    pred.load_state_dict(inp["pred_sd"])
    out = {}
    with torch.no_grad():
        for iters in (1, 6):
            preds, vis = pred.eval()(inp["pred_q"], inp["pred_fmaps"],
                                     iters=iters, down_ratio=2)
            out[iters] = (preds[-1], vis)
    return out


def test_coarse_predictor_two_ranks_one_iteration(job, coarse_one_rank):
    _, res = job
    want, vis = coarse_one_rank[1]
    assert (want[:, 1:] - want[:, :1]).abs().max() > 0.05  # tracks moved
    for r in res:
        _close(r["coarse1"], want, 1e-4)
        _close(r["coarse1_vis"], vis, 1e-5)


def test_coarse_predictor_two_ranks_six_iterations(job, coarse_one_rank):
    """After six iterations at least 90% of the coordinates within 1e-2
    px of the one-rank run (the flow embedding amplifies the reassociated
    sums from one iteration to the next; module docstring)."""
    _, res = job
    want, _ = coarse_one_rank[6]
    for r in res:
        d = (r["coarse6"] - want).abs()
        assert torch.isfinite(r["coarse6"]).all()
        assert float((d <= 1e-2).float().mean()) >= 0.9, d.max()
    assert torch.equal(res[0]["coarse6"], res[1]["coarse6"])


def test_bundle_adjust_with_group_matches_without(job):
    inp, res = job
    b = inp["ba"]
    extr, intr, _, X, info = bundle_adjust(
        b["extr"], b["intr"], b["X"], b["tracks"], b["mask"],
        cfg=BAConfig(max_iterations=6, refine_focal=True))
    assert float(info["final_cost"]) < 0.5 * float(info["initial_cost"])
    for r in res:
        e, i, x, cost, cost0 = r["ba"]
        _close(e, extr, 1e-4)
        _close(i, intr, 1e-2, 1e-6)
        _close(x, X, 1e-3)
        _close(cost, info["final_cost"], 0, 1e-5)
        _close(cost0, info["initial_cost"], 0, 1e-5)
    for a, b_ in zip(res[0]["ba"], res[1]["ba"]):
        assert torch.equal(a, b_)  # every rank the same cameras
    # with a group the LM loops stay eager: nothing replayed from a graph
    for r in res:
        for name in ("ba.dense", "ba.sparse"):
            c = r["lm_counts"][name]
            assert c["ba.iters_run"] > 1 and c["ba.iters_graphed"] == 0


def test_distributed_bundle_adjust_matches_jax(job):
    """The JAX `distributed_bundle_adjust` on a 2-device mesh (all on
    `points`), tests/test_multihost.py's inputs and tolerances."""
    inp, res = job
    d = inp["dist"]
    cfg = JSparseCfg(max_iterations=8, refine_focal=False, cg_iters=40)
    jmesh = j_make_mesh(2, frames_axis=1)
    je, _, _, jX, jcost = j_dist_ba(jmesh, d["extr"], d["intr"], d["X"],
                                    d["fr"], d["pt"], d["xy"], d["w"],
                                    cfg=cfg)
    for r in res:
        e, _, extra, X, cost = r["dist"]
        assert extra is None
        _close(e, je, 2e-3)
        _close(X, jX, 5e-3)
        assert abs(float(cost) - float(jcost)) \
            <= 1e-3 * max(1.0, float(jcost))
    for a, b in zip(res[0]["dist"], res[1]["dist"]):
        assert a is None or torch.equal(a, b)


def test_distributed_bundle_adjust_padding_is_inert(job):
    """An odd observation count over two ranks: the weight-0 row that pads
    it changes nothing; at the optimum the solve stays there."""
    inp, res = job
    p = inp["pad"]
    for r in res:
        e, _, _, X, _ = r["pad"]
        _close(e, p["extr"], 1e-4)
        _close(X, p["X"], 1e-3)


def test_single_rank_distributed_bundle_adjust_is_the_plain_solver():
    """On a one-rank mesh (no process group) the sharded solver is the
    plain one, bit for bit."""
    from vggsfm_tpu_torch.ba import SparseBAConfig, bundle_adjust_sparse

    rng = np.random.default_rng(5)
    extr, intr, X, tracks, mask = make_bundle(rng, S=3, N=40, noise_px=0.3)
    fr, pt, xy, w = dense_to_obs(tracks, mask)
    cfg = SparseBAConfig(max_iterations=3, refine_focal=False, cg_iters=10)
    mesh = tmesh.make_mesh(device="cpu")
    out = distributed_bundle_adjust(mesh, extr, intr, X, fr, pt, xy, w,
                                    cfg=cfg)
    ref = bundle_adjust_sparse(_t(extr), _t(intr), _t(X), _t(fr, torch.long),
                               _t(pt, torch.long), _t(xy), _t(w), cfg=cfg)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[3], ref[3])
    assert torch.equal(out[4], ref[4]["final_cost"])


def test_video_joint_ba_over_the_group_matches_the_plain_solver(job):
    """`VideoRunner._joint_ba` with `distributed_ba_devices` = 2 on the
    2-rank group takes `distributed_bundle_adjust`; here, without a group,
    the plain solver: the same normalized map within the sparse BA's
    reassociation tolerance, the same observations kept."""
    inp, res = job
    v = inp["video"]

    class _Sparse:
        device = torch.device("cpu")

    runner = VideoRunner(_Sparse(), VideoConfig(distributed_ba_devices=2))
    assert runner._device_count() == 1  # no group: the plain solver
    reg = MapRegistry()
    reg.xyz = v["xyz"].copy()
    reg.obs_frame, reg.obs_point = v["fr"].copy(), v["pt"].copy()
    reg.obs_xy = v["xy"].copy()
    extr, intr = v["extr"].copy(), v["intr"].copy()
    runner._joint_ba(extr, intr, reg, v["registered"].copy())
    for r in res:
        e, i, xyz, n_obs = r["video"]
        _close(e, extr, 2e-3)
        _close(i, intr, 0, 1e-3)
        # the shared focal's shallow valley: points slide along their rays
        # with the focal, so each within 1e-2 of its distance
        dist = np.linalg.norm(xyz - reg.xyz, axis=-1)
        assert (dist <= 1e-2 * np.linalg.norm(reg.xyz, axis=-1)).all()
        assert n_obs == len(reg.obs_frame)


@pytest.mark.parametrize("T,init,w,H", [(103, 16, 8, 4), (40, 32, 16, 3),
                                        (9, 16, 8, 2)])
def test_windows_for_host_matches_jax(T, init, w, H):
    for h in range(H):
        assert windows_for_host(T, init, w, H, h) == j_windows(T, init, w,
                                                               H, h)
