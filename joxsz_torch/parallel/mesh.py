"""Device meshes for walker / cluster sharding, and their collectives.

Torch counterpart of ``joxsz_tpu/parallel/mesh.py``.  A mesh is a named
grid of ``torch.device``s, one per shard: ``walker`` shards cut an
ensemble's walkers, ``cluster`` shards cut a survey's clusters (no
traffic between them at all).  By default the shards are the visible
cards ``cuda:0 .. cuda:n-1``; an explicit ``devices`` list may name one
device several times, which is how a machine with one card, or the CPU,
spans several shards (each shard is then a block of its own on that
device, and the samplers run exactly the same code).

The JAX package's ``NamedSharding`` helpers have no counterpart: a shard
here is a tensor on its mesh device.  What the samplers need of a
sharding is the three collectives below — cut a tensor into per-shard
blocks, join blocks on one device, and give every shard the join of all
blocks (the all-gather of the coupled sampler); a sampler calls nothing
else to move data.

A mesh may span processes (``parallel.multihost.global_mesh``): every
shard has an owner rank, and a shard another process owns is a
``RemoteShard`` in the device list.  ``scatter`` then keeps only this
process's blocks (the tensor cut is one every process holds alike) and
puts None in the others' places; ``gather`` and ``all_gather`` over
such a list are collectives of the whole ``torch.distributed`` job,
which exchange host copies of the blocks (gloo, on the CPU and on cards
alike), so every process must make the same calls in the same order.
``local_blocks`` keeps the blocks this process holds.  In one process
every shard is the caller's and the collectives are copies between
devices.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RemoteShard:
    """A mesh shard that another process owns: its rank and its device as
    that process names it."""

    owner: int
    name: str


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` job, 0 without
    one."""
    import torch.distributed as dist

    return dist.get_rank() if (dist.is_available()
                               and dist.is_initialized()) else 0


def is_local(d) -> bool:
    """Whether a mesh device is one of this process's."""
    return not isinstance(d, RemoteShard)


class Mesh:
    """A grid of devices with named axes: ``shape[axis]`` shards along
    ``axis``; ``devices`` is the flat row-major list, one per shard
    (``RemoteShard`` for another process's); ``owners`` the rank of each
    shard's process (in one process: the caller's, for every shard)."""

    def __init__(self, devices, axis_names, shape, owners=None):
        self.devices = [d if isinstance(d, RemoteShard) else torch.device(d)
                        for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self._grid = np.arange(len(self.devices)).reshape(
            [self.shape[a] for a in self.axis_names])
        rank = process_rank()
        self.owners = ([rank] * len(self.devices) if owners is None
                       else [int(o) for o in owners])

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        line = np.moveaxis(self._grid, k, 0).reshape(self.shape[axis], -1)
        return [self.devices[i] for i in line[:, 0]]

    def sub(self, axis: str, index: int) -> list:
        """The devices at ``index`` along ``axis``, row-major over the
        other axes."""
        k = self.axis_names.index(axis)
        return [self.devices[i]
                for i in np.take(self._grid, index, axis=k).ravel()]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("walker",),
              shape: tuple[int, ...] | None = None,
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: the
    visible cards).  Asking for more devices than there are raises: a
    smaller mesh would make every walkers-per-device figure downstream
    (the statistical floors, the hybrid routing) wrong without a sign."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"make_mesh: {n_devices} devices requested but only "
                f"{len(devs)} available")
        devs = devs[:n_devices]
    n = len(devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(devs, axis_names, shape)


def on_device(device):
    """Context that makes ``device`` the current CUDA device, so that the
    launches and allocations inside go to it; nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def scatter(t: torch.Tensor, devices: list, dim: int = 0) -> list:
    """Cut ``t`` into ``len(devices)`` equal blocks along ``dim``; block s
    is a contiguous tensor of its own on ``devices[s]``, or None where
    another process owns shard s."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"axis of {t.shape[dim]} does not divide over "
                         f"{n} shards")
    return [torch.empty(b.shape, dtype=t.dtype, device=d).copy_(b)
            if is_local(d) else None
            for b, d in zip(t.chunk(n, dim=dim), devices)]


def local_blocks(blocks: list) -> list:
    """The blocks this process holds, in shard order."""
    return [b for b in blocks if b is not None]


def _exchange(blocks: list) -> list:
    """Every shard's block: this process's as they are, the others' as
    host copies from their owners (one ``all_gather_object`` of the job);
    no traffic where every block is here."""
    if all(b is not None for b in blocks):
        return blocks
    import torch.distributed as dist

    mine = {s: b.cpu() for s, b in enumerate(blocks) if b is not None}
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    out = list(blocks)
    for part in parts:
        for s, b in part.items():
            if out[s] is None:
                out[s] = b
    if any(b is None for b in out):
        raise ValueError("no process holds the blocks of shards "
                         f"{[s for s, b in enumerate(out) if b is None]}")
    return out


def gather(blocks: list, device, dim: int = 0) -> torch.Tensor:
    """The blocks joined along ``dim`` on ``device`` (a collective of
    the job where other processes hold some)."""
    return torch.cat([b.to(device) for b in _exchange(blocks)], dim=dim)


def all_gather(blocks: list, dim: int = 0) -> list:
    """For every shard of this process, the join of all shards' blocks
    along ``dim`` on that shard's device (shards that share a device
    share the copy); None for the others' shards."""
    full = _exchange(blocks)
    joined: dict = {}
    out = []
    for b in blocks:
        if b is not None and b.device not in joined:
            joined[b.device] = gather(full, b.device, dim).contiguous()
        out.append(None if b is None else joined[b.device])
    return out
