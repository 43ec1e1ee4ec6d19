"""Process-group jobs of the port's multi-device tests: ranks started with
`torch.multiprocessing` (spawn), a gloo group initialized from a file in
the test's temporary folder (no TCP port to collide between test
workers), torch on one thread in each rank. This module imports neither
JAX nor a test module, so the spawned ranks import only the port.

Each job reads its inputs from INPUTS (a `torch.save` dict), runs its
cases on every rank and saves each rank's results to OUT/rank{r}.pt;
the test compares them in its own process.
"""

from __future__ import annotations

import os
import time
import traceback

import torch


def run_ranks(job: str, world: int, folder: str, inputs: dict,
              timeout: float = 240.0) -> list:
    """Run job `job` of this module on `world` gloo ranks; returns each
    rank's results. A rank that fails or deadlocks fails the call (the
    ranks are joined with `timeout` and terminated past it)."""
    import torch.multiprocessing as mp

    os.makedirs(folder, exist_ok=True)
    inp = os.path.join(folder, "inputs.pt")
    torch.save(inputs, inp)
    init = os.path.join(folder, "pg")
    if os.path.exists(init):
        os.remove(init)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # inherited by the spawned ranks
    try:
        ctx = mp.start_processes(_entry, args=(world, job, init, inp, folder),
                                 nprocs=world, join=False,
                                 start_method="spawn")
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"job {job} on {world} ranks did not end "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, job, init, inp, folder):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        out = globals()[job](rank, world, torch.load(inp, weights_only=False))
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ jobs

def parallel_job(rank, world, inp) -> dict:
    """The cases of tests/test_torch_parallel.py on each rank."""
    from vggsfm_tpu_torch.ba import BAConfig, SparseBAConfig, bundle_adjust
    from vggsfm_tpu_torch.models.layers import TorchMultiheadAttention
    from vggsfm_tpu_torch.models.tracker import BaseTrackerPredictor
    from vggsfm_tpu_torch.parallel.mesh import make_mesh
    from vggsfm_tpu_torch.parallel.multihost import distributed_bundle_adjust
    from vggsfm_tpu_torch.utils import trace

    out = {}
    mesh = make_mesh(device="cpu")
    ax = mesh["points"]
    out["mesh"] = (dict(mesh.shape), ax.index, ax.size,
                   mesh["frames"].index, mesh["frames"].size)
    # block + all_gather round trip, padded (7 rows over the ranks)
    x = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    out["gathered"] = ax.all_gather(ax.block(x), 0, length=7)

    with torch.no_grad():
        attn = TorchMultiheadAttention(32, 4)
        attn.load_state_dict(inp["attn_sd"])
        q, kv = inp["attn_q"], inp["attn_kv"]
        out["attn"] = attn(q, ax.block(kv, 1), ax.block(kv, 1), group=ax)

        pred = BaseTrackerPredictor(**inp["pred_kw"])
        pred.load_state_dict(inp["pred_sd"])
        pred.eval()
        qb = ax.block(inp["pred_q"], 1)
        for iters in (1, 6):
            preds, vis = pred(qb, inp["pred_fmaps"], iters=iters,
                              down_ratio=2, group=ax)
            out[f"coarse{iters}"] = ax.all_gather(preds[-1], 2)
            out[f"coarse{iters}_vis"] = ax.all_gather(vis, 2)

    b = inp["ba"]
    N = b["X"].shape[0]
    blk = ax.block_size(N)
    sl = slice(rank * blk, (rank + 1) * blk)
    cfg = BAConfig(max_iterations=6, refine_focal=True)
    # the LM counters of the calls with a group: their loops stay eager
    with trace.recording() as rec:
        extr, intr, _, X, info = bundle_adjust(
            b["extr"], b["intr"], b["X"][sl], b["tracks"][:, sl],
            b["mask"][:, sl], cfg=cfg, group=ax)
        out["ba"] = (extr, intr, ax.all_gather(X, 0), info["final_cost"],
                     info["initial_cost"])

        d = inp["dist"]
        scfg = SparseBAConfig(max_iterations=8, refine_focal=False,
                              cg_iters=40)
        out["dist"] = distributed_bundle_adjust(
            mesh, d["extr"], d["intr"], d["X"], d["fr"], d["pt"], d["xy"],
            d["w"], cfg=scfg)
    out["lm_counts"] = {s["name"]: s["counters"] for s in rec.spans
                        if s["name"] in ("ba.dense", "ba.sparse")}
    p = inp["pad"]
    out["pad"] = distributed_bundle_adjust(
        mesh, p["extr"], p["intr"], p["X"], p["fr"], p["pt"], p["xy"],
        p["w"], cfg=SparseBAConfig(max_iterations=4, refine_focal=False))
    out["video"] = _video_joint_ba(inp["video"])
    return out


def _video_joint_ba(v: dict):
    """The video runner's joint BA on an oracle map with
    `distributed_ba_devices` = the group's size: the sharded branch."""
    from vggsfm_tpu_torch.video.runner import (
        MapRegistry,
        VideoConfig,
        VideoRunner,
    )

    class _Sparse:  # the joint BA reads only the device of the runner
        device = torch.device("cpu")

    import torch.distributed as dist

    runner = VideoRunner(_Sparse(), VideoConfig(
        distributed_ba_devices=dist.get_world_size()))
    reg = MapRegistry()
    reg.xyz = v["xyz"].copy()
    reg.obs_frame, reg.obs_point = v["fr"].copy(), v["pt"].copy()
    reg.obs_xy = v["xy"].copy()
    extr, intr = v["extr"].copy(), v["intr"].copy()
    runner._joint_ba(extr, intr, reg, v["registered"].copy())
    return extr, intr, reg.xyz, len(reg.obs_frame)


def sharded_job(rank, world, inp) -> dict:
    """`sharded_track_and_reconstruct` of tests/test_torch_sharded.py on
    each rank."""
    from vggsfm_tpu_torch.models.tracker import TrackerPredictor
    from vggsfm_tpu_torch.parallel.mesh import make_mesh
    from vggsfm_tpu_torch.parallel.sharded import (
        sharded_track_and_reconstruct,
    )

    tracker = TrackerPredictor()
    tracker.load_state_dict(inp["sd"])
    step = sharded_track_and_reconstruct(tracker.eval(),
                                         make_mesh(device="cpu"))
    res = step(inp["images"], max_query_pts=inp["n"],
               sample_idx=inp["sample_idx"])
    return {"step": res, "valid": step.valid_points}
