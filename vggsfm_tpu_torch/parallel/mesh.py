"""A (frames, points) mesh over the ranks of the default process group.
Counterpart of vggsfm_tpu/parallel/mesh.py.

The JAX package lays its devices out as a `jax.sharding.Mesh` and lets
GSPMD insert the collectives. Here one process drives one card, so the
mesh is laid over the ranks of `torch.distributed`'s default group: rank
r sits at (r // points, r % points), as the JAX mesh reshapes its device
list. Each axis carries an `Axis`: this rank's coordinate, the axis size
and the process group of the ranks that share the other coordinate. The
sharded code calls the collectives through it; an axis of size 1 without
a process group makes every collective a no-op, so world size 1 runs with
no group initialized, as the JAX mesh runs on one device.

`Axis.block` stands in for `shard_spec`: this rank's block of a tensor
along a dimension, padded to a multiple of the axis size, and
`Axis.all_gather` puts the blocks back in their original order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXIS_NAMES = ("frames", "points")

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Axis:
    """One mesh axis as seen from this rank: `size` ranks, this rank at
    `index`, their process group `group` (None: the axis has one rank and
    no group, so every collective returns its input)."""

    def __init__(self, name: str, size: int, index: int, group=None):
        self.name, self.size, self.index, self.group = name, size, index, group

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced over the axis (sum or max), in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   length: int | None = None) -> torch.Tensor:
        """The axis' blocks of `t` concatenated along `dim` in rank order,
        the padding of `block` trimmed to `length`."""
        if self.group is not None:
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            t = torch.cat(parts, dim=dim)
        if length is not None:
            t = t.narrow(dim, 0, length)
        return t

    def block_size(self, n: int) -> int:
        return -(-n // self.size)

    def block(self, t: torch.Tensor, dim: int = 0,
              pad_value: float = 0.0) -> torch.Tensor:
        """This rank's block of `t` along `dim`: `t` padded with
        `pad_value` to a multiple of the axis size, then split evenly."""
        n = t.shape[dim]
        b = self.block_size(n)
        pad = b * self.size - n
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_full(shape, pad_value)], dim=dim)
        return t.narrow(dim, self.index * b, b)


def mesh_shape(n: int, frames_axis: int | None = None) -> tuple:
    """The JAX layout rule: 2 x n/2 for an even n >= 4, else all on
    `points` (the dominant parallelism)."""
    if frames_axis is None:
        frames_axis = 2 if n >= 4 and n % 2 == 0 else 1
    return frames_axis, n // frames_axis


class Mesh:
    """(frames, points) mesh over the first `n` ranks of the default
    process group; `device` this rank's card. A rank outside the mesh
    (rank >= frames x points) holds no axis."""

    axis_names = AXIS_NAMES

    def __init__(self, shape: tuple, rank: int, device: torch.device,
                 groups: dict | None = None):
        self.shape = dict(zip(AXIS_NAMES, shape))
        self.rank, self.device = rank, device
        F, P = shape
        self.size = F * P
        idx = {"frames": rank // P, "points": rank % P}
        groups = groups or {}
        self.axes = {a: Axis(a, self.shape[a], idx[a], groups.get(a))
                     for a in AXIS_NAMES}
        self.world_group = groups.get("world")

    def __getitem__(self, axis: str) -> Axis:
        return self.axes[axis]

    def __repr__(self):
        return (f"Mesh(frames={self.shape['frames']}, "
                f"points={self.shape['points']}, rank={self.rank}, "
                f"device={self.device})")

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` from mesh rank `src` to every rank of the mesh, in place."""
        if self.world_group is not None:
            dist.broadcast(t, src=src, group=self.world_group)
        return t


def rank_device(rank: int, device="cuda") -> torch.device:
    """The card of `rank`: cuda:{rank % device_count}, so ranks beyond
    the cards share them (two gloo ranks on one card); the CPU when asked
    for."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vggsfm_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, frames_axis: int | None = None,
              device="cuda") -> Mesh:
    """A (frames, points) mesh over the first `n_devices` ranks of the
    default process group (all of them by default; 1 without one).

    With >= 4 ranks the mesh is 2D (2 x n/2 by default); otherwise all
    ranks go to the ``points`` axis. Every rank of the default group must
    call it, in the same order as its other collectives: the sub-groups
    are made collectively. Raises where the default group has fewer ranks
    than asked for, and never falls back to another backend or device.
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of "
                         f"at least {n}; this one has {world}")
    F, P = mesh_shape(n, frames_axis)
    if F * P != n:
        raise ValueError(f"{n} ranks do not split into frames_axis="
                         f"{frames_axis} rows")
    groups = {}
    if initialized:
        # dist.new_group is collective over the default group: every rank
        # makes every sub-group, in the same order
        groups["world"] = dist.new_group(list(range(n)))
        for f in range(F):
            g = dist.new_group([f * P + p for p in range(P)])
            if rank // P == f and rank < n:
                groups["points"] = g
        for p in range(P):
            g = dist.new_group([f * P + p for f in range(F)])
            if rank % P == p and rank < n:
                groups["frames"] = g
        if rank >= n:
            groups = {}
    return Mesh((F, P), rank, rank_device(rank, device), groups)
