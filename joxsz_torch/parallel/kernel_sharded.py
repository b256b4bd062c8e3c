"""Mesh sampling through the CUDA step kernels.

Torch counterpart of ``joxsz_tpu/parallel/kernel_sharded.py``.  Three
layouts of a walker mesh, and one of a cluster mesh:

* **independent ensembles** (``run_sharded_kernel_ensembles``,
  ``run_sharded_tempered_ensembles``): every shard advances its walker
  block as an ensemble of its own through the step kernel (one launch per
  chunk of steps), on its own Philox seed, with no traffic between
  shards.  The ensembles target the same posterior, so the joined chains
  are valid samples; below ``2*ndim+2`` walkers per shard the move cannot
  span the parameter space (``_guard_per_device_walkers``).
* **one coupled ensemble** (``run_coupled_sharded_ensemble``): a single
  ensemble of W walkers over the mesh.  Each step gathers half B to every
  shard, moves each shard's rows of half A through kernel 6
  (``ops.coupled_kernel``), gathers A and moves B: every walker's partner
  comes from the FULL other half, exactly the single-device move, and the
  chain does not depend on the number of shards, bit for bit, under
  either partner law (``partner``: 'onehot' by default, as the JAX
  runners'; the independent ensembles take the step kernel's 'auto' at
  their per-shard W, as ``make_step_kernel`` does).
* **hybrid** (``run_hybrid_coupled_ensemble``): windows of ``sync_every -
  1`` independent per-shard steps, then one coupled step that mixes the
  ensemble across shards.  Every move is a stretch move that leaves the
  posterior invariant, so the composition is a valid sampler.  Frames
  come from the windows only; the result declares their spacing.
* **cluster blocks** (``make_sharded_multicluster_step``): the survey's
  cluster-grid step kernel (kernel 4), one launch per call and shard on a
  block of C / n_dev clusters.  Clusters are independent posteriors:
  exact parallelism.

A shard is a set of tensors on its mesh device; data moves between
shards only through ``mesh.scatter`` / ``gather`` / ``all_gather``.  A
mesh may span processes (``parallel.multihost``): each process then runs
its own shards only, and the coupled and hybrid runners return this
process's walkers alone, with their global indices in
``EnsembleResult.walker_indices`` (chains never cross processes; the
independent runners' joins are collectives that return every walker).  Each
loop launches every shard's kernels of a step before it waits for any,
each on its device's current stream, so shards on different cards
overlap.  The constants are copied to each mesh device once per call.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .mesh import (Mesh, all_gather, gather, is_local, local_blocks,
                   on_device, scatter)
from ..ops.coupled_kernel import coupled_half
from ..ops.joint_kernel import JointConsts, JointConstsStack, joint_ll
from ..ops.multicluster_kernel import stretch_steps_multicluster
from ..ops.step_kernel import stretch_steps
from ..sampling.kernel import (chain_chunk_schedule, min_walkers_per_device,
                               rung_tensors)
from ..sampling.stretch import EnsembleResult
from ..sampling.tempered import TemperedResult

_SEED_MAX = 2 ** 31 - 1


def _guard_per_device_walkers(w_loc: int, ndim: int,
                              allow_small: bool = False):
    """Independent per-shard ensembles equal one large ensemble only when
    each is healthy by itself: error below 2*ndim+2 walkers (the move's
    span degenerates), warn below 64 (mixing per walker degrades).
    ``allow_small`` skips both, for tests of the plumbing."""
    if allow_small:
        return
    floor = min_walkers_per_device(ndim)
    if w_loc < floor:
        raise ValueError(
            f"walkers per device ({w_loc}) < 2*ndim+2 = {floor}: "
            f"a per-device Goodman-Weare ensemble this small cannot span "
            f"the parameter space — use fewer devices or more walkers "
            f"(pass allow_small=True only for plumbing tests)")
    if w_loc < 64:
        warnings.warn(
            f"only {w_loc} walkers per device: small independent "
            f"ensembles mix measurably worse per walker; prefer >= 64 per "
            f"device, or use run_hybrid_coupled_ensemble (mixing across "
            f"devices at near-independent cost)", stacklevel=3)


def _per_device_layout(W: int, n_dev: int):
    if W % n_dev:
        raise ValueError(f"walkers ({W}) must divide over {n_dev} devices")
    w_loc = W // n_dev
    if w_loc % 2:
        raise ValueError(f"walkers per device ({w_loc}) must be even")
    return w_loc


def _independent_steps(shards: list, betas, seeds, n_steps: int,
                       thin: int | None):
    """Advance every shard's ensemble (x (K, w_loc, D), lp, acc, sacc,
    consts on its device; None for another process's shard) in place by
    ``n_steps`` on ``seeds[s]``: one launch of the step kernel per shard,
    every shard's launched before any is waited for.  With ``thin``,
    returns the cold-rung frames per shard as device tensors ``[(chain
    (n_keep, w_loc, D), chain_lp (n_keep, w_loc))]`` (None for another
    process's shard)."""
    frames = []
    for s, sh in enumerate(shards):
        if sh is None:
            frames.append(None)
            continue
        x, lp, acc, sacc, consts = sh
        with on_device(x.device):
            frames.append(stretch_steps(x, lp, acc, sacc,
                                        *rung_tensors(betas, x.device),
                                        int(seeds[s]), n_steps, consts,
                                        thin=thin or 0))
    return frames


def _part(items: list, k: int) -> list:
    """Entry ``k`` of every shard's tuple, None for another process's."""
    return [None if it is None else it[k] for it in items]


def _run_independent(consts: JointConsts, x0: torch.Tensor, betas,
                     n_steps: int, rng: np.random.Generator, mesh: Mesh,
                     thin: int, axis: str, allow_small: bool):
    """Independent K-rung ensembles per shard from x0 (K, W, D).  Returns
    ``(x (K, W, D), lp, acc, sacc (K-1,) summed over shards, chain
    (n_saved, W, D), chain_lp)`` on the constants' device."""
    K, W, D = x0.shape
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    w_loc = _per_device_layout(W, n_dev)
    _guard_per_device_walkers(w_loc, D, allow_small)
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")
    home = consts.device
    x0 = x0.to(home, torch.float32).contiguous()
    lp0 = joint_ll(x0.reshape(K * W, D), consts).reshape(K, W)
    shards = []
    for xs, ls, dev in zip(scatter(x0, devices, dim=1),
                           scatter(lp0, devices, dim=1), devices):
        shards.append(None if xs is None else (
            xs, ls, torch.zeros_like(ls),
            torch.zeros(max(K - 1, 1), dtype=torch.int32, device=dev),
            consts.to(dev)))
    chains, chain_lps = [], []
    chunks = chain_chunk_schedule(n_steps, thin) if n_steps else []
    seeds = rng.integers(0, _SEED_MAX, size=(len(chunks), n_dev))
    for n_inner, row in zip(chunks, seeds):
        frames = _independent_steps(shards, betas, row, n_inner, thin)
        chains.append(gather(_part(frames, 0), home, dim=1))
        chain_lps.append(gather(_part(frames, 1), home, dim=1))
    x, lp, acc = (gather(_part(shards, k), home, dim=1) for k in range(3))
    sacc = gather([None if sh is None else sh[3][None] for sh in shards],
                  home).sum(0)[:K - 1]
    empty = torch.empty((0, W, D), device=home)
    return (x, lp, acc, sacc,
            torch.cat(chains) if chains else empty,
            torch.cat(chain_lps) if chains else empty[..., 0])


def run_sharded_kernel_ensembles(consts: JointConsts, p0: torch.Tensor,
                                 n_steps: int, rng: np.random.Generator,
                                 mesh: Mesh, thin: int = 1,
                                 axis: str = "walker",
                                 allow_small: bool = False) -> EnsembleResult:
    """Mesh counterpart of ``KernelSampler.run``: ``p0`` (W, D) with W
    divisible by the mesh's ``axis`` size and an even share per shard.
    The chain is (n_steps // thin, W, D) with each shard's ensemble in
    its walker block; chunk c of shard s runs on the seed at [c, s] of
    one grid drawn from ``rng``."""
    W, D = p0.shape
    x, lp, acc, _, chain, chain_lp = _run_independent(
        consts, p0[None], np.ones(1), n_steps, rng, mesh, thin, axis,
        allow_small)
    return EnsembleResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc[0] / max(n_steps, 1)).cpu().numpy(),
        final_state=(x[0], lp[0]))


def run_sharded_tempered_ensembles(consts: JointConsts, p0: torch.Tensor,
                                   betas, n_steps: int,
                                   rng: np.random.Generator, mesh: Mesh,
                                   thin: int = 1, axis: str = "walker",
                                   allow_small: bool = False
                                   ) -> TemperedResult:
    """Mesh counterpart of ``run_tempered_kernel``: an independent K-rung
    tempered ensemble per shard.  ``p0`` is (K, W, D), or (W, D)
    replicated to every rung; swap counts are summed over the shards."""
    betas = np.asarray(betas, dtype=np.float64)
    K = betas.size
    if p0.dim() == 2:
        p0 = p0[None].expand(K, *p0.shape)
    if p0.shape[0] != K:
        raise ValueError(f"p0 has {p0.shape[0]} rungs but {K} betas were "
                         f"given")
    W = p0.shape[1]
    x, lp, acc, sacc, chain, chain_lp = _run_independent(
        consts, p0, betas, n_steps, rng, mesh, thin, axis, allow_small)
    n = max(n_steps, 1)
    return TemperedResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / n).cpu().numpy(),
        swap_acceptance=sacc.cpu().numpy().astype(float) / float(n * W),
        final_state=(x, lp))


class _CoupledState:
    """One ensemble of W walkers cut for the coupled step: half A (rows
    0..H) and half B (rows H..W), each in blocks of H_loc rows, block s
    of both on shard s with that shard's copy of the constants
    (``consts[s]``, None for another process's shard)."""

    def __init__(self, devices: list, consts: list, x, lp, acc,
                 partner: str = "onehot"):
        H = x.shape[0] // 2
        self.home = x.device
        self.H, self.H_loc = H, H // len(devices)
        self.consts = consts
        self.partner = partner
        self.halves = [[scatter(t[h * H:(h + 1) * H], devices)
                        for t in (x, lp, acc)] for h in (0, 1)]

    def step(self, seed: int, i: int):
        """One coupled step: gather B, move A, gather A, move B."""
        for which in (0, 1):
            xm, lm, am = self.halves[which]
            fixed = all_gather(self.halves[1 - which][0])
            for s, c in enumerate(self.consts):
                if c is not None:
                    coupled_half(xm[s], lm[s], am[s], fixed[s], which, seed,
                                 i, s * self.H_loc, c, partner=self.partner)

    def joined(self, k: int) -> torch.Tensor:
        """Tensor k (0 x, 1 lp, 2 acc) of the whole ensemble, walker
        order [A; B], on the home device (a collective across
        processes)."""
        return gather(self.halves[0][k] + self.halves[1][k], self.home)

    def local(self, k: int) -> torch.Tensor:
        """Tensor k of this process's walkers, in the order of
        ``walker_indices``, on the home device."""
        return torch.cat([b.to(self.home) for b in local_blocks(
            self.halves[0][k] + self.halves[1][k])])

    def walker_indices(self) -> np.ndarray:
        """The global indices of ``local``'s walkers."""
        rows = np.concatenate([
            np.arange(s * self.H_loc, (s + 1) * self.H_loc)
            for s, c in enumerate(self.consts) if c is not None])
        return np.concatenate([rows, self.H + rows])


def _coupled_layout(W: int, n_dev: int) -> int:
    if W % 2:
        raise ValueError("need an even number of walkers")
    H = W // 2
    if H % n_dev:
        raise ValueError(f"half-ensemble ({H}) must divide over "
                         f"{n_dev} devices")
    return H


def _local_consts(consts: JointConsts, devices: list) -> list:
    """The constants on each of this process's mesh devices, None for
    another process's shard."""
    return [consts.to(d) if is_local(d) else None for d in devices]


def run_coupled_sharded_ensemble(consts: JointConsts, p0: torch.Tensor,
                                 n_steps: int, seed: int, mesh: Mesh,
                                 thin: int = 1, axis: str = "walker",
                                 partner: str = "onehot") -> EnsembleResult:
    """ONE ensemble of W walkers over the mesh's shards through kernel 6:
    ``p0`` (W, D), H = W / 2 divisible by the number of shards.  Step i
    draws at (seed, i); the result is, bit for bit, that of
    ``stretch_steps`` at K = 1 on the whole ensemble with the same seed,
    step numbers and partner law (``partner``), for any number of shards.
    It pays two launches and two gathers per shard and step, so it is
    meant for ensembles too small per shard for independent ones
    (``run_sharded_kernel_ensembles`` above 64 walkers per shard).  Over
    a mesh that spans processes, chain, acceptance and final state are
    this process's walkers (``walker_indices``: its half-row blocks in
    half A, then in half B)."""
    W, D = p0.shape
    devices = mesh.axis_devices(axis)
    _coupled_layout(W, len(devices))
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")
    home = consts.device
    x = p0.to(home, torch.float32).contiguous()
    lp = joint_ll(x, consts)
    st = _CoupledState(devices, _local_consts(consts, devices), x, lp,
                       torch.zeros_like(lp), partner)
    widx = st.walker_indices()
    n_keep = n_steps // thin
    chain = torch.empty((n_keep, widx.size, D), dtype=torch.float32,
                        device=home)
    chain_lp = torch.empty((n_keep, widx.size), dtype=torch.float32,
                           device=home)
    for i in range(n_steps):
        st.step(seed, i)
        if (i + 1) % thin == 0:
            chain[(i + 1) // thin - 1] = st.local(0)
            chain_lp[(i + 1) // thin - 1] = st.local(1)
    return EnsembleResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(st.local(2) / max(n_steps, 1)).cpu().numpy(),
        final_state=(st.local(0), st.local(1)),
        walker_indices=widx if mesh.spans_processes else None)


def run_hybrid_coupled_ensemble(consts: JointConsts, p0: torch.Tensor,
                                n_windows: int, sync_every: int, seed: int,
                                mesh: Mesh, thin: int = 1,
                                axis: str = "walker",
                                allow_small: bool = False,
                                partner: str = "onehot") -> EnsembleResult:
    """``n_windows`` windows, each ``sync_every - 1`` steps of independent
    per-shard ensembles (the step kernel, no traffic) and then one step of the
    whole ensemble coupled across the mesh (kernel 6, partners from the
    full other half).  The coupled step costs 2 launches and 2 gathers
    per shard once per window instead of every step.

    Frames are kept every ``thin`` steps inside the windows only; the
    coupled step is not recorded, so ``n_windows * sync_every`` steps
    spread over ``n_windows * (sync_every - 1) / thin`` frames and the
    result carries ``frame_spacing = thin * sync_every / (sync_every -
    1)``.  Window seeds and the coupled step's seed come from
    ``numpy.random.default_rng(seed)``, shard s of a window taking the
    window's s-th.  The walker guard applies as in the other runners;
    ``partner`` is the coupled step's partner law (the windows take the
    step kernel's 'auto' at their per-shard W).  Over a mesh that spans
    processes, chain and acceptance are this process's walker blocks
    (``walker_indices``) and the final state the whole ensemble."""
    W, D = p0.shape
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    if n_windows < 1:
        raise ValueError(f"n_windows ({n_windows}) must be >= 1")
    if sync_every < 2:
        raise ValueError("sync_every must be >= 2 (use "
                         "run_coupled_sharded_ensemble for every-step "
                         "coupling)")
    if W % (2 * n_dev) or (W // n_dev) % 2:
        raise ValueError(f"walkers ({W}) must give an even per-device "
                         f"share over {n_dev} devices")
    _guard_per_device_walkers(W // n_dev, D, allow_small)
    n_win_steps = sync_every - 1
    if n_win_steps % thin:
        raise ValueError(f"sync_every - 1 ({n_win_steps}) must be a "
                         f"multiple of thin ({thin})")
    home = consts.device
    x = p0.to(home, torch.float32).contiguous()
    lp = joint_ll(x, consts)
    acc = torch.zeros_like(lp)
    local = _local_consts(consts, devices)
    w_loc = W // n_dev
    widx = np.concatenate([np.arange(s * w_loc, (s + 1) * w_loc)
                           for s, c in enumerate(local) if c is not None])
    rng = np.random.default_rng(seed)
    chains, chain_lps = [], []
    for _ in range(n_windows):
        # walker blocks as ensembles of their own (a leading rung axis of 1)
        shards = [None if xs is None else (
            xs[None], ls[None], as_[None],
            torch.zeros(1, dtype=torch.int32, device=d), c)
            for xs, ls, as_, d, c in zip(
                scatter(x, devices), scatter(lp, devices),
                scatter(acc, devices), devices, local)]
        frames = _independent_steps(
            shards, np.ones(1), rng.integers(0, _SEED_MAX, size=n_dev),
            n_win_steps, thin)
        # this process's frames only; the state is joined whole
        chains.append(torch.cat([f.to(home) for f in local_blocks(
            _part(frames, 0))], dim=1))
        chain_lps.append(torch.cat([f.to(home) for f in local_blocks(
            _part(frames, 1))], dim=1))
        x, lp, acc = (gather([None if sh is None else sh[k][0]
                              for sh in shards], home) for k in range(3))
        # one step of the whole ensemble, cut by halves
        st = _CoupledState(devices, local, x, lp, acc, partner)
        st.step(int(rng.integers(0, _SEED_MAX)), 0)
        x, lp, acc = st.joined(0), st.joined(1), st.joined(2)
    return EnsembleResult(
        chain=torch.cat(chains).cpu().numpy(),
        log_prob=torch.cat(chain_lps).cpu().numpy(),
        acceptance_fraction=(acc[torch.as_tensor(widx, device=home)]
                             / float(n_windows * sync_every)).cpu().numpy(),
        final_state=(x, lp),
        frame_spacing=thin * sync_every / (sync_every - 1),
        walker_indices=widx if mesh.spans_processes else None)


def make_sharded_multicluster_step(stack: JointConstsStack, mesh: Mesh,
                                   n_inner: int, thin: int | None = None,
                                   axis: str = "cluster"):
    """The survey's cluster-grid step over a mesh: shard s advances its
    block of C / n_dev clusters through kernel 4 (one launch per call)
    against its block of the constants, with no traffic between shards.

    Returns ``fn(x (C, W, D), lp (C, W), acc (C, W), seeds (n_dev,)) ->
    (x, lp, acc[, chain (C, n_keep, W, D), chain_lp (C, n_keep, W)])``,
    ``n_inner`` steps on new tensors on the stack's device.  A cluster's
    Philox stream is (its shard's seed, its index within the block), so
    each block equals ``run_multicluster_steps`` on that block alone."""
    C = stack.n_clusters
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    if C % n_dev:
        raise ValueError(f"clusters ({C}) must divide over the mesh's "
                         f"{n_dev} '{axis}' devices")
    if thin is not None and (thin <= 0 or n_inner % thin):
        raise ValueError(f"n_inner ({n_inner}) must be a positive multiple "
                         f"of thin ({thin})")
    step = cluster_block_steps(cluster_blocks(stack, devices), devices,
                               n_inner, thin)
    home = stack.device

    def run(x, lp, acc, seeds):
        xs, ls, as_ = (scatter(t.to(home), devices) for t in (x, lp, acc))
        frames = step(xs, ls, as_, seeds)
        out = tuple(gather(t, home) for t in (xs, ls, as_))
        if thin is None:
            return out
        return out + (gather(_part(frames, 0), home),
                      gather(_part(frames, 1), home))

    return run


def cluster_blocks(stack: JointConstsStack, devices: list) -> list:
    """Shard s's block of the constants (clusters s C/n .. (s+1) C/n) on
    its device, None for another process's shard."""
    c_loc = stack.n_clusters // len(devices)
    return [stack.block(s * c_loc, (s + 1) * c_loc, d) if is_local(d)
            else None for s, d in enumerate(devices)]


def cluster_block_steps(blocks: list, devices: list, n_inner: int,
                        thin: int | None):
    """``fn(xs, ls, as_, seeds) -> frames``: ``n_inner`` steps of kernel 4
    for each of this process's shards, in place on its blocks (C / n, W,
    D) against ``blocks[s]`` on the seed ``seeds[s]``; frames per shard
    (``(chain, chain_lp)`` with ``thin``, None for another process's
    shard)."""
    def run(xs, ls, as_, seeds):
        frames = []
        for s, d in enumerate(devices):
            if blocks[s] is None:
                frames.append(None)
                continue
            with on_device(d):
                frames.append(stretch_steps_multicluster(
                    xs[s], ls[s], as_[s], int(seeds[s]), n_inner, blocks[s],
                    thin=thin or 0))
        return frames

    return run
