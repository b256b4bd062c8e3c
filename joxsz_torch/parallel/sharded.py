"""Mesh sampling on a batched likelihood: the plain samplers over shards.

Torch counterpart of ``joxsz_tpu/parallel/sharded.py``: ONE stretch-move
ensemble whose walkers are cut over a mesh's ``walker`` axis.  The move
and its random draws are those of ``sampling.stretch.run_ensemble`` (one
draw per step for the whole ensemble, on the generator's device), so the
chain equals the single-device sampler's; per half-step every shard gets
a copy of the complementary half (the all-gather) and evaluates the
likelihood of its own rows.  ``run_fit`` samples a mesh through it when
it has no step sampler (``step_sampler=None``, the plain route).

``run_multi_cluster`` does the same for C independent ensembles
(C, W, D) -> (C, W) with the walker axis cut; clusters never exchange
anything, so a ``cluster`` axis cuts them into blocks with a likelihood
per block.

The likelihood is one callable, called by every shard on tensors of that
shard's device, or a list with one callable per shard (a likelihood
bound to each device's copy of the data).
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_gather, gather, on_device, scatter
from ..sampling.stretch import (EnsembleResult, stretch_half_update,
                                validate_schedule)


def _per_shard(fn, n: int) -> list:
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * n
    if len(fns) != n:
        raise ValueError(f"{len(fns)} likelihoods for {n} shards")
    return fns


def _sharded_step(lp_fns: list, devices: list, x, lp, acc, u):
    """One stretch step of ensembles x (..., W, D) on the home device with
    the walker axis cut over ``devices``; ``u`` (2, ..., H, 3)."""
    H, D = x.shape[-2] // 2, x.shape[-1]
    home = x.device
    halves = [x[..., :H, :], x[..., H:, :]]
    lps = [lp[..., :H], lp[..., H:]]
    accs = [acc[..., :H], acc[..., H:]]
    for which in (0, 1):
        xm = scatter(halves[which], devices, dim=-2)
        lm = scatter(lps[which], devices, dim=-1)
        us = scatter(u[which], devices, dim=-2)
        fixed = all_gather(scatter(halves[1 - which], devices, dim=-2),
                           dim=-2)
        out = []
        for s, d in enumerate(devices):
            with on_device(d):
                out.append(stretch_half_update(
                    lambda th, s=s, d=d: lp_fns[s](th).to(d), us[s], xm[s],
                    lm[s], fixed[s], D, 1.0)[:3])
        halves[which] = gather([o[0] for o in out], home, dim=-2)
        lps[which] = gather([o[1] for o in out], home, dim=-1)
        accs[which] = accs[which] + gather(
            [o[2] for o in out], home, dim=-1).to(acc.dtype)
    return (torch.cat(halves, dim=-2), torch.cat(lps, dim=-1),
            torch.cat(accs, dim=-1))


def run_sharded_ensemble(log_prob_batch, p0: torch.Tensor, n_steps: int,
                         gen: torch.Generator, mesh: Mesh,
                         thin: int = 1) -> EnsembleResult:
    """``sampling.stretch.run_ensemble`` with the walkers of p0 (W, D) cut
    over the mesh's ``walker`` axis; H = W / 2 must divide over it."""
    W, D = p0.shape
    validate_schedule(n_steps, thin, W)
    devices = mesh.axis_devices("walker")
    fns = _per_shard(log_prob_batch, len(devices))
    x = p0.clone()
    lp = gather([f(b).to(b.device) for f, b in zip(fns, scatter(x, devices))],
                x.device)
    acc = torch.zeros(W, dtype=torch.float32, device=x.device)
    n_saved = n_steps // thin
    chain = torch.empty((n_saved, W, D), dtype=x.dtype, device=x.device)
    chain_lp = torch.empty((n_saved, W), dtype=lp.dtype, device=x.device)
    for i in range(n_steps):
        u = torch.rand((2, W // 2, 3), generator=gen, dtype=x.dtype,
                       device=x.device)
        x, lp, acc = _sharded_step(fns, devices, x, lp, acc, u)
        if (i + 1) % thin == 0:
            chain[(i + 1) // thin - 1] = x
            chain_lp[(i + 1) // thin - 1] = lp
    return EnsembleResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / n_steps).cpu().numpy(),
        final_state=(x, lp))


def run_multi_cluster(log_prob_batch_cluster, p0: torch.Tensor, n_steps: int,
                      gen: torch.Generator, mesh: Mesh, thin: int = 1) -> dict:
    """C independent ensembles from p0 (C, W, D) over a mesh with a
    ``walker`` and / or a ``cluster`` axis; the likelihood maps (c, n, D)
    -> (c, n).  With a ``cluster`` axis of more than one shard, pass a
    list with one likelihood per cluster block (of C / n clusters each).
    The draws are those of ``sampling.batched.run_batched_ensembles``.
    Returns ``{"positions", "log_prob", "acceptance_fraction"}`` as numpy
    (the final state; no chain is kept, as in the JAX package)."""
    C, W, D = p0.shape
    validate_schedule(n_steps, thin, W)
    n_c = mesh.shape.get("cluster", 1)
    if C % n_c:
        raise ValueError(f"clusters ({C}) must divide over the mesh's "
                         f"{n_c} 'cluster' devices")
    c_fns = _per_shard(log_prob_batch_cluster, n_c)
    if n_c > 1 and not isinstance(log_prob_batch_cluster, (list, tuple)):
        raise ValueError("a 'cluster' axis needs one likelihood per "
                         "cluster block")
    # cluster block b runs on the mesh's devices at index b of 'cluster'
    rows = [mesh.sub("cluster", b) if n_c > 1 else mesh.devices
            for b in range(n_c)]
    c_loc = C // n_c

    def flat(fn):
        # stretch_half_update hands over (c_loc * n, D) rows, cluster-major
        return lambda th: fn(th.reshape(c_loc, -1, D)).reshape(-1)

    home = p0.device
    xs = list(p0.chunk(n_c, dim=0))
    lps = [c_fns[b](xs[b].to(rows[b][0])).to(home) for b in range(n_c)]
    accs = [torch.zeros(l.shape, dtype=torch.float32, device=home)
            for l in lps]
    for _ in range(n_steps):
        u = torch.rand((2, C, W // 2, 3), generator=gen, dtype=p0.dtype,
                       device=home)
        for b in range(n_c):
            xs[b], lps[b], accs[b] = _sharded_step(
                [flat(c_fns[b])] * len(rows[b]), rows[b], xs[b], lps[b],
                accs[b], u[:, b * c_loc:(b + 1) * c_loc])
    return {"positions": torch.cat(xs).cpu().numpy(),
            "log_prob": torch.cat(lps).cpu().numpy(),
            "acceptance_fraction": (torch.cat(accs) / n_steps).cpu().numpy()}
