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
blocks (the all-gather of the coupled sampler).  They run in this
process, as copies between devices; a sampler calls nothing else to move
data, so an implementation across processes can replace them without
touching the samplers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Mesh:
    """A grid of devices with named axes: ``shape[axis]`` shards along
    ``axis``; ``devices`` is the flat row-major list, one per shard."""

    def __init__(self, devices, axis_names, shape):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self._grid = np.arange(len(self.devices)).reshape(
            [self.shape[a] for a in self.axis_names])

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
    is a contiguous tensor of its own on ``devices[s]``."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"axis of {t.shape[dim]} does not divide over "
                         f"{n} shards")
    return [torch.empty(b.shape, dtype=t.dtype, device=d).copy_(b)
            for b, d in zip(t.chunk(n, dim=dim), devices)]


def gather(blocks: list, device, dim: int = 0) -> torch.Tensor:
    """The blocks joined along ``dim`` on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def all_gather(blocks: list, dim: int = 0) -> list:
    """For every shard, the join of all shards' blocks along ``dim`` on
    that shard's device (shards that share a device share the copy)."""
    joined: dict = {}
    out = []
    for b in blocks:
        if b.device not in joined:
            joined[b.device] = gather(blocks, b.device, dim).contiguous()
        out.append(joined[b.device])
    return out
