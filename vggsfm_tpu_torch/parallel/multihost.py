"""Multi-process scale-out: process-group init and the observation-sharded
joint bundle adjustment. Counterpart of vggsfm_tpu/parallel/multihost.py.

* `init_multihost()` initializes `torch.distributed`'s default group from
  arguments or the environment. After it, `make_mesh` lays its axes over
  the group's ranks, one card per process.
* `distributed_bundle_adjust` runs the joint sparse BA with the
  observation lists split over a mesh axis: cameras and points are
  replicated (broadcast from rank 0 first, so the ranks start from the
  same bits), each rank solves with its block and every reduction of the
  solver is summed over the axis (`bundle_adjust_sparse(group=...)`).

The sequence's windows split over hosts with `windows_for_host`; each host
tracks its own windows, and the map merge (parallel/merge.py) and the
joint BA are the only steps across hosts.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from vggsfm_tpu_torch.ba.sparse_lm import SparseBAConfig, bundle_adjust_sparse


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   device="cuda") -> bool:
    """Initialize the default process group from args or environment.

    Env fallbacks: VGGSFM_COORDINATOR (host:port), VGGSFM_NUM_PROCESSES,
    VGGSFM_PROCESS_ID, else torchrun's MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK (where the JAX package reads JAX_*). Backend
    `nccl` for a CUDA device, `gloo` where the caller asks for the CPU or
    for gloo. Returns True when a multi-process group was initialized (or
    already was), False for a single process.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coord = coordinator_address or env.get("VGGSFM_COORDINATOR")
    if coord is None and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    nproc = num_processes if num_processes is not None else int(
        env.get("VGGSFM_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    pid = process_id if process_id is not None else int(
        env.get("VGGSFM_PROCESS_ID", env.get("RANK", "0")))
    if coord is None or nproc <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=init, world_size=nproc,
                            rank=pid)
    return True


def windows_for_host(num_frames: int, init_window: int, window: int,
                     num_hosts: int, host_id: int) -> list[tuple[int, int]]:
    """Contiguous window ranges [(start, end), ...] owned by `host_id`.

    Frames after the initial window split into `window`-sized chunks that
    round-robin over hosts — each host tracks ~1/num_hosts of the video.
    """
    starts = list(range(init_window, num_frames, window))
    return [(s, min(s + window, num_frames))
            for i, s in enumerate(starts) if i % num_hosts == host_id]


def distributed_bundle_adjust(
    mesh,
    extrinsics,
    intrinsics,
    points3d,
    obs_frame,
    obs_point,
    obs_xy,
    obs_weight,
    extra_params=None,
    pose_free=None,
    cfg: SparseBAConfig = SparseBAConfig(),
    axis: str = "points",
):
    """Joint sparse BA with the observation lists sharded over `axis` of
    `mesh` (parallel/mesh.py).

    Every rank of the mesh calls it. Rank 0's inputs are broadcast to the
    mesh, so they are replicated even where the ranks' maps differ by the
    card's atomics; the observation lists are padded with weight-0 rows
    (inert) to a multiple of the axis size, each rank solves with its
    block and the group. Returns the replicated (extrinsics, intrinsics,
    extra | None, points3d, cost) on the mesh's device.
    """
    dev = mesh.device
    ax = mesh[axis]

    def rep(x, dtype):
        return mesh.broadcast(torch.as_tensor(
            np.asarray(x) if not torch.is_tensor(x) else x).to(
                dev, dtype).contiguous())

    extr = rep(extrinsics, torch.float32)
    intr = rep(intrinsics, torch.float32)
    X = rep(points3d, torch.float32)
    S = extr.shape[0]
    # the observation count first: the ranks' lists may differ in length
    n_obs = rep(torch.tensor([len(obs_frame)]), torch.long)
    O = int(n_obs.item())

    def obs(x, dtype, width=None):
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if t.shape[0] != O:
            # a rank whose list differs only receives rank 0's
            t = torch.zeros((O,) + ((width,) if width else ()), dtype=dtype)
        return ax.block(rep(t, dtype))

    of = obs(obs_frame, torch.long)
    op = obs(obs_point, torch.long)
    oxy = obs(obs_xy, torch.float32, 2)
    ow = obs(obs_weight, torch.float32)
    extra = None if extra_params is None else rep(extra_params, torch.float32)
    pf = None if pose_free is None else rep(
        torch.as_tensor(np.asarray(pose_free) if not torch.is_tensor(
            pose_free) else pose_free).to(torch.uint8), torch.uint8).bool()
    extr_o, intr_o, extra_o, X_o, info = bundle_adjust_sparse(
        extr, intr, X, of, op, oxy, ow, extra_params=extra, pose_free=pf,
        cfg=cfg, group=ax)
    return extr_o, intr_o, extra_o, X_o, info["final_cost"]
