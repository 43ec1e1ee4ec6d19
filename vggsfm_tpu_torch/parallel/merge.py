"""Multi-host map merge for the windowed video pipeline (host-side numpy).
Counterpart of vggsfm_tpu/parallel/merge.py, the same code: the port keeps
its own copy.

The sequential video runner's frame windows are the natural multi-host
axis. Each host processes a CONTIGUOUS block of frames against the shared
(frozen) initial-window map, and the two cross-host steps are (1) this
merge and (2) one global joint BA on host 0.

The merge is host-side bookkeeping: every host's partial registry shares
the initial map prefix [0, P0); its new points get id-offset into a single
store, observations re-index, and near-coincident new points from
different hosts fuse into one track (duplicate-track fusion). The exchange
is file-based (np.savez in a shared directory), so it needs no process
group.
"""

from __future__ import annotations

import os
import time

import numpy as np


def frame_block(num_frames: int, init_window: int, num_hosts: int,
                host_id: int) -> tuple[int, int]:
    """Contiguous frame block [start, end) owned by `host_id`.

    Frames after the shared initial window split into `num_hosts` nearly
    equal contiguous spans; contiguity keeps each host's window chaining
    (query = previous frame) intact, unlike a round-robin split.
    """
    rest = num_frames - init_window
    chunk = -(-rest // num_hosts) if rest > 0 else 0
    start = init_window + host_id * chunk
    end = min(init_window + (host_id + 1) * chunk, num_frames)
    return min(start, num_frames), end


def save_partial(path: str, host_id: int, reg, extrinsics, intrinsics,
                 extra, registered, shared_points: int,
                 block: tuple[int, int]) -> str:
    """Persist one host's partial map + cameras for the merge."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"partial_{host_id:03d}.npz")
    tmp = out + ".tmp.npz"
    np.savez_compressed(
        tmp, xyz=reg.xyz, obs_frame=reg.obs_frame,
        obs_point=reg.obs_point, obs_xy=reg.obs_xy,
        extrinsics=extrinsics, intrinsics=intrinsics,
        extra=(np.zeros((0,)) if extra is None else extra),
        registered=registered, shared_points=shared_points,
        block=np.asarray(block, np.int64))
    os.replace(tmp, out)  # atomic publish: readers never see a half-write
    return out


def wait_for_partials(path: str, num_hosts: int,
                      timeout_s: float = 1800.0,
                      poll_s: float = 0.5) -> list[dict]:
    """Block until every host's partial exists; load them in host order."""
    names = [os.path.join(path, f"partial_{h:03d}.npz")
             for h in range(num_hosts)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(n) for n in names):
        if time.time() > deadline:
            missing = [n for n in names if not os.path.exists(n)]
            raise TimeoutError(f"partial maps missing after {timeout_s}s: "
                               f"{missing}")
        time.sleep(poll_s)
    out = []
    for n in names:
        d = np.load(n)
        out.append({k: d[k] for k in d.files})
    return out


def merge_partial_maps(partials: list[dict], registry_cls):
    """Merge per-host partial maps into one registry + camera arrays.

    Invariants the block pipeline guarantees (video runner with
    joint_ba=False): the shared prefix [0, P0) is bit-identical on every
    host (frozen initial map — per-window BA holds map points constant and
    no local joint BA ran), and hosts register disjoint frame blocks plus
    the common initial window.

    Returns (reg, extrinsics, intrinsics, extra | None, registered).
    """
    p0 = partials[0]
    P0 = int(p0["shared_points"])
    T = p0["extrinsics"].shape[0]

    reg = registry_cls()
    reg.add_points(p0["xyz"][:P0])
    extrinsics = np.array(p0["extrinsics"], np.float32)
    intrinsics = np.array(p0["intrinsics"], np.float32)
    extra = (None if p0["extra"].size == 0
             else np.array(p0["extra"], np.float32))
    registered = np.array(p0["registered"], bool)

    init_end = int(p0["block"][0]) if len(partials) else 0
    for h, part in enumerate(partials):
        b0, b1 = int(part["block"][0]), int(part["block"][1])
        if h > 0:
            sel = np.zeros((T,), bool)
            sel[b0:b1] = part["registered"][b0:b1]
            extrinsics[sel] = part["extrinsics"][sel]
            intrinsics[sel] = part["intrinsics"][sel]
            if extra is not None and part["extra"].size:
                extra[sel] = part["extra"][sel]
            registered |= sel
        # this host's new points -> offset into the merged store
        new_ids = reg.add_points(part["xyz"][P0:])
        remap = np.concatenate([np.arange(P0, dtype=np.int64),
                                new_ids.astype(np.int64)])
        # contribute observations from frames this host OWNS: its block,
        # plus (host 0 only) the shared initial window — every host's
        # registry carries the same init-window observations, so only one
        # copy may survive
        of = part["obs_frame"]
        own = (of >= b0) & (of < b1)
        if h == 0:
            own |= of < init_end
        reg.add_observations(of[own],
                             remap[part["obs_point"][own]],
                             part["obs_xy"][own])
    return reg, extrinsics, intrinsics, extra, registered


def fuse_duplicate_points(reg, shared_points: int,
                          tol: float = 0.02) -> dict:
    """Fuse near-coincident NEW points into single tracks, in place.

    Different hosts independently triangulate support points; two hosts
    observing the same physical feature create duplicate 3D points with
    disjoint observation sets. Points (id >= shared_points) whose 3D
    positions quantize to the same `tol`-sized cell fuse to the lowest id;
    their observations re-target it. Cell quantization is deliberately
    conservative — a missed fusion only costs one redundant track, a wrong
    fusion corrupts two.

    Returns {"fused": int}.
    """
    P = reg.num_points
    if P <= shared_points:
        return {"fused": 0}
    ids = np.arange(P)
    cells = np.floor(reg.xyz / tol).astype(np.int64)
    # shared points never fuse (their ids must stay stable)
    key = [tuple(c) for c in cells]
    first: dict = {}
    remap = ids.copy()
    for i in range(shared_points, P):
        k = key[i]
        if k in first:
            remap[i] = first[k]
        else:
            first[k] = i
    fused = int((remap != ids).sum())
    if fused == 0:
        return {"fused": 0}
    keep = remap == ids
    new_id = np.cumsum(keep) - 1
    reg.xyz = reg.xyz[keep]
    reg.obs_point = new_id[remap[reg.obs_point]].astype(np.int32)
    return {"fused": fused}
