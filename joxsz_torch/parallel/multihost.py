"""Multi-process survey parallelism on ``torch.distributed``.

Torch counterpart of ``joxsz_tpu/parallel/multihost.py``.  Cluster fits
are independent posteriors, so a survey shards its cluster axis over the
shards of EVERY process of one job:

  * every process holds the (small) survey inputs on the host and makes
    only the blocks of the shards it owns (``replicated_to_global``);
  * each process samples its own cluster blocks, with no traffic during
    the run;
  * each process keeps only its own block (``local_block``): chains never
    cross processes.  Only small per-cluster summaries are gathered at
    the end (``survey.py``).

The job is a ``torch.distributed`` process group on the gloo backend:
what crosses processes is host copies of summaries (and, for a walker
mesh, the coupled sampler's all-gathers: ``parallel.mesh``), and gloo
serves them from the CPU and from cards alike, also for several
processes on one card, which NCCL refuses.  A process's shards are its
visible cards, or ``cpu_devices`` CPU shards (the test mode).

Seeds follow the global shard index, never the rank: a run over P
processes of K shards each is, cluster by cluster and bit for bit, the
single-process run over a mesh of P*K shards
(``sampling.kernel.fit_multicluster_kernel``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import Mesh, RemoteShard, is_local, make_mesh

__all__ = [
    "MultihostInfo", "initialize", "finalize", "global_mesh",
    "GlobalArray", "replicated_to_global", "local_block",
    "run_multihost_multi_cluster", "place_multicluster_consts",
    "make_multihost_multicluster_step",
]

# the process's shard devices and every process's device names, set by
# ``initialize``
_JOB: dict = {}


@dataclasses.dataclass(frozen=True)
class MultihostInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, cpu_devices: int | None = None
               ) -> MultihostInfo:
    """Join a job of ``num_processes`` processes as ``process_id``: a gloo
    process group whose rendezvous is ``coordinator_address`` (HOST:PORT,
    or a ``tcp://`` / ``file://`` URL).  ``cpu_devices=K``: K CPU shards
    in this process (the test mode); otherwise the shards are the
    process's visible cards, and it raises without one.  The shard
    counts of every process are gathered (``global_devices``)."""
    import torch.distributed as dist

    if cpu_devices is not None:
        if cpu_devices < 1:
            raise ValueError(f"cpu_devices must be >= 1, got {cpu_devices}")
        local = [torch.device("cpu")] * cpu_devices
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA card visible to this process: a "
                               "multi-process job runs on cards, or pass "
                               "cpu_devices for CPU shards")
        local = [torch.device("cuda", i) for i in range(n)]
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id)
    names = [None] * num_processes
    dist.all_gather_object(names, [str(d) for d in local])
    _JOB.update(local=local, names=names)
    return MultihostInfo(process_id=process_id,
                         num_processes=num_processes,
                         local_devices=len(local),
                         global_devices=sum(len(n) for n in names))


def finalize():
    """Leave the job (after a last barrier), if one was joined."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _JOB.clear()


def global_mesh(axis_names: tuple[str, ...] = ("cluster",),
                shape: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every process's shards, in rank order: this process's
    as its devices, the others' as ``RemoteShard``s, each with its
    owner's rank (``Mesh.owners``)."""
    if not _JOB:
        raise RuntimeError("initialize() first")
    import torch.distributed as dist

    me = dist.get_rank()
    devices, owners = [], []
    for r, names in enumerate(_JOB["names"]):
        for k, name in enumerate(names):
            devices.append(_JOB["local"][k] if r == me
                           else RemoteShard(r, name))
            owners.append(r)
    mesh = make_mesh(axis_names=axis_names, shape=shape, devices=devices)
    mesh.owners = owners
    return mesh


@dataclasses.dataclass
class GlobalArray:
    """A tensor of ``shape`` laid over a mesh: ``shards`` holds this
    process's blocks as ``(shard index, start per axis, tensor on the
    shard's device)``."""

    shape: tuple
    shards: list

    def block_of(self, s: int):
        """The tensor of shard ``s``, or None where another process owns
        it."""
        for i, _, t in self.shards:
            if i == s:
                return t
        return None


def _shard_slices(shape, mesh: Mesh, spec, s: int) -> tuple:
    """The block of shard ``s`` as one slice per axis."""
    pos = dict(zip(mesh.axis_names,
                   np.unravel_index(s, mesh._grid.shape)))
    out = []
    for d, size in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append(slice(0, size))
            continue
        n = mesh.shape[ax]
        if size % n:
            raise ValueError(f"axis {d} of {size} does not divide over the "
                             f"mesh's {n} '{ax}' shards")
        b = size // n
        out.append(slice(int(pos[ax]) * b, (int(pos[ax]) + 1) * b))
    return tuple(out)


def replicated_to_global(x, mesh: Mesh, spec=None) -> GlobalArray:
    """A ``GlobalArray`` from host data that every process holds alike:
    only this process's shards are made, each a copy on its device.
    ``spec``: the mesh axis (or None) per leading axis of ``x``; None
    replicates ``x`` on every shard."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    spec = tuple(spec or ())
    shards = []
    for s, d in enumerate(mesh.devices):
        if not is_local(d):
            continue
        sl = _shard_slices(tuple(t.shape), mesh, spec, s)
        shards.append((s, tuple(v.start for v in sl),
                       t[sl].to(d).contiguous()))
    return GlobalArray(tuple(t.shape), shards)


def local_block(arr: GlobalArray, axis: int = 0):
    """This process's contiguous block of ``arr`` along ``axis``:
    ``(start, stop, np.ndarray)`` in global indices.  Blocks cut along
    other axes are joined, but must cover those axes whole (a process
    owns whole clusters); raises where the ``axis`` blocks leave a gap or
    another axis is covered only in part (replicated copies count once).
    """
    shards: dict[tuple[int, ...], np.ndarray] = {}
    for _, starts, t in arr.shards:
        if starts not in shards:
            shards[starts] = t.detach().cpu().numpy()
    if not shards:
        raise ValueError("this process holds no block of the array")
    ndim = len(arr.shape)
    starts_by_axis = [sorted({k[d] for k in shards}) for d in range(ndim)]

    def _size(d: int, st: int) -> int:
        k = next(k for k in shards if k[d] == st)
        return shards[k].shape[d]

    for d, starts in enumerate(starts_by_axis):
        stop = starts[0] if d == axis else 0
        for st in starts:
            if st != stop:
                raise ValueError(f"local shards not contiguous along axis "
                                 f"{d}: gap before index {st}")
            stop = st + _size(d, st)
        if d != axis and stop != arr.shape[d]:
            raise ValueError(
                f"local_block(axis={axis}): axis {d} only partially "
                f"covered locally ([0, {stop}) of {arr.shape[d]})")

    def _build(d: int, prefix: tuple[int, ...]):
        if d == ndim:
            if prefix not in shards:
                raise ValueError(f"local shard grid incomplete: missing "
                                 f"block at global start {prefix}")
            return shards[prefix]
        return np.concatenate([_build(d + 1, prefix + (st,))
                               for st in starts_by_axis[d]], axis=d)

    starts = starts_by_axis[axis]
    return starts[0], starts[-1] + _size(axis, starts[-1]), _build(0, ())


def run_multihost_multi_cluster(log_prob_batch_cluster, p0, n_steps: int,
                                gen: torch.Generator, mesh: Mesh,
                                thin: int = 1, n_burn: int = 0,
                                record: bool = False) -> dict:
    """Multi-process counterpart of ``parallel.run_multi_cluster``: ``p0``
    (C, W, D) and ``gen``'s state alike on every process, one likelihood
    per cluster block (None allowed for the others' blocks); this process
    samples its own blocks and returns only them, with their global
    ``cluster_range`` [c0, c1).  ``n_burn`` prepends unrecorded steps
    (acceptance reset after them); ``record`` adds the thinned sampling
    chain ``(n_saved, c1 - c0, W, D)`` and its log-probs.  At ``n_burn``
    0 each block is, bit for bit, ``run_multi_cluster``'s over the same
    mesh in one process."""
    from .sharded import cluster_blocks_sampler

    return cluster_blocks_sampler(log_prob_batch_cluster,
                                  torch.as_tensor(p0), n_steps, gen, mesh,
                                  thin, n_burn=n_burn, record=record)


def place_multicluster_consts(stack, mesh: Mesh, axis: str = "cluster"
                              ) -> list:
    """The constants of a stacked survey (``ops.joint_kernel.
    JointConstsStack``, every cluster's, which every process packs alike)
    cut over the mesh's ``axis``: this process's blocks on their devices,
    None for the others'.  Build once and pass to every
    ``make_multihost_multicluster_step`` of the survey."""
    from .kernel_sharded import cluster_blocks

    return cluster_blocks(stack, mesh.axis_devices(axis))


def make_multihost_multicluster_step(stack, mesh: Mesh, n_inner: int,
                                     thin: int | None = None,
                                     consts_global=None,
                                     axis: str = "cluster"):
    """The survey's kernel route across processes: kernel 4 on each of
    this process's shards, shard s on its block of C / n clusters, as
    ``parallel.kernel_sharded.make_sharded_multicluster_step`` runs it in
    one process.

    Returns ``fn(x, lp, acc, seeds (n,)) -> (x, lp, acc[, chain (C,
    n_keep, W, D), chain_lp])`` as ``GlobalArray``s cut along clusters:
    ``x``, ``lp``, ``acc`` are host tensors (C, ...) alike on every
    process, or a previous call's ``GlobalArray``s (burn, then sampling);
    ``local_block`` takes this process's clusters out.  ``consts_global``:
    ``place_multicluster_consts``'s blocks, shared by the calls."""
    from .kernel_sharded import cluster_block_steps

    if mesh.axis_names != (axis,):
        raise ValueError(f"need a mesh of the one axis '{axis}', got "
                         f"{mesh.axis_names}")
    devices = mesh.devices
    n_dev = len(devices)
    if stack.n_clusters % n_dev:
        raise ValueError(f"clusters ({stack.n_clusters}) must divide over "
                         f"the mesh's {n_dev} '{axis}' devices")
    if thin is not None and (thin <= 0 or n_inner % thin):
        raise ValueError(f"n_inner ({n_inner}) must be a positive multiple "
                         f"of thin ({thin})")
    blocks = (consts_global if consts_global is not None
              else place_multicluster_consts(stack, mesh, axis))
    step = cluster_block_steps(blocks, devices, n_inner, thin)
    spec = (axis,)

    def as_blocks(v) -> list:
        if not isinstance(v, GlobalArray):
            v = replicated_to_global(v, mesh, spec)
        # fresh copies: the kernel advances its blocks in place
        return [None if v.block_of(s) is None else v.block_of(s).clone()
                for s in range(n_dev)]

    def wrap(blocks_, shape) -> GlobalArray:
        c_loc = shape[0] // n_dev
        return GlobalArray(
            tuple(shape),
            [(s, (s * c_loc,) + (0,) * (len(shape) - 1), b)
             for s, b in enumerate(blocks_) if b is not None])

    def fn(x, lp, acc, seeds):
        seeds = np.asarray(seeds)
        if seeds.shape != (n_dev,):
            raise ValueError(f"seeds must be ({n_dev},), got {seeds.shape}")
        shape = tuple(x.shape)
        xs, ls, as_ = (as_blocks(v) for v in (x, lp, acc))
        frames = step(xs, ls, as_, seeds)
        out = (wrap(xs, shape), wrap(ls, shape[:2]), wrap(as_, shape[:2]))
        if thin is None:
            return out
        n_keep = n_inner // thin
        C, W, D = shape
        return out + (
            wrap([None if f is None else f[0] for f in frames],
                 (C, n_keep, W, D)),
            wrap([None if f is None else f[1] for f in frames],
                 (C, n_keep, W)))

    return fn
