"""Production sampler over the CUDA kernels.

Torch counterpart of ``joxsz_tpu/sampling/kernel.py``: ``KernelSampler``
runs the plain stretch-move ensemble (K = 1: prelim rounds and burn-in)
and ``run_tempered_kernel`` the K-rung tempered ensemble (the sampling
phase and its auto-extensions), both as one launch of the step kernel
per chunk of steps (``ops.step_kernel.stretch_steps``: the two
half-steps and the K-1 swap boundaries of every step of the chunk), with
initial log-probs from kernel 1.  The kernel writes the cold rung's
frames every ``thin`` steps into a preallocated device tensor, fetched
once.  The partner law is the step kernel's ``partner`` ('auto' by
default: the hashed roll above 4096 walkers per rung, as the TPU
kernels' default).

``run_multicluster_steps`` runs the survey fit's C ensembles against C
sets of constants: one launch of the cluster-grid step kernel (kernel 4)
per call, one Philox seed per call; ``fit_multicluster_kernel`` is the
whole kernel route of a stacked fit (init, burn, sampling), which the
survey and SBC share.

``KernelSampler.run_sharded`` / ``run_tempered_sharded`` send a sampling
call over a device mesh (``parallel.kernel_sharded``): independent
ensembles per shard, or below 64 walkers per shard the hybrid of local
windows and one coupled step (kernel 6) per window;
``run_coupled_sharded`` runs one ensemble coupled at every step, for the
layouts those decline.

On CPU tensors the same loops run the kernels' plain versions (the
``--cpu`` path).  Each chunk of steps draws one Philox seed from the
caller's numpy generator; the step counter restarts at 0 per chunk, as
the TPU kernel's loop index did per call.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .stretch import EnsembleResult
from .tempered import TemperedResult
from ..ops.joint_kernel import (JointConsts, JointConstsStack, joint_ll,
                                pack_consts, pack_consts_stack)
from ..ops.multicluster_kernel import (multicluster_ll,
                                       stretch_steps_multicluster)
from ..ops.step_kernel import stretch_steps

_CHUNK_STEPS = 100      # steps per Philox seed


def chain_chunk_schedule(n_steps: int, thin: int) -> list[int]:
    """Chunk sizes (steps) that cover ``n_steps``: each a multiple of
    ``thin`` (so frames never straddle a seed) near ``_CHUNK_STEPS``."""
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")
    chunk = max(thin, (_CHUNK_STEPS // thin) * thin)
    full, rem = divmod(n_steps, chunk)
    return [chunk] * full + ([rem] if rem else [])


def _seeds(rng: np.random.Generator, n: int) -> list[int]:
    return [int(s) for s in rng.integers(0, 2 ** 31 - 1, size=n)]


def min_walkers_per_device(ndim: int) -> int:
    """Statistical floor of an independent per-shard Goodman-Weare
    ensemble: below 2*ndim+2 walkers the complementary half cannot span
    the parameter space and the move degenerates.  The one constant of
    the sampler's fallback test (``_sharded_layout_ok``) and the sharded
    runners' hard guard (``parallel.kernel_sharded``)."""
    return 2 * ndim + 2


def rung_differences(betas) -> list[float]:
    """beta_k - beta_k+1 per rung boundary, rounded to float32 as the
    swap sweep takes it."""
    return [float(np.float32(betas[k] - betas[k + 1]))
            for k in range(len(betas) - 1)]


def rung_tensors(betas, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(beta (K,), db (K-1,)) float32 on ``device``: what the step kernel
    takes for a ladder ``betas``, made once per call so that no launch
    waits on a copy."""
    beta = torch.as_tensor(np.asarray(betas, np.float64),
                           dtype=torch.float32, device=device)
    db = torch.tensor(rung_differences(betas), dtype=torch.float32,
                      device=device)
    return beta, db


class KernelSampler:
    """Kernel-driven sampler for one session; build with
    :func:`make_kernel_sampler`."""

    def __init__(self, consts: JointConsts, partner: str = "auto"):
        self.consts = consts
        self.device = consts.device
        # the step kernel's partner law ('auto', 'onehot' or 'roll')
        self.partner = partner
        # sub-64 routing of run_sharded per (W, n_dev, thin), sticky
        # within one logical run: a chunked or extended run must not mix
        # hybrid and independent-ensemble chunks in one chain
        self._hybrid_routes: dict = {}

    def new_run(self):
        """Start a new logical run: forget the sticky routing decisions.
        ``run_fit`` calls it once per fit; a continuation within a run
        must not."""
        self._hybrid_routes.clear()

    def log_prob_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        return joint_ll(thetas.to(self.device, torch.float32).contiguous(),
                        self.consts)

    def _steps(self, x, lp, acc, betas: np.ndarray, n_steps: int,
               rng: np.random.Generator, thin: int, store_chain: bool,
               partner: str | None = None):
        """Advance state x (K, W, D), lp/acc (K, W) in place by
        ``n_steps`` under ``partner`` (default: the sampler's); returns
        (chain, chain_lp, sacc) of the cold rung."""
        K, W, D = x.shape
        dev = self.device
        beta, db = rung_tensors(betas, dev)
        sacc = torch.zeros(max(K - 1, 1), dtype=torch.int32, device=dev)
        n_saved = n_steps // thin if store_chain else 0
        chain = torch.empty((n_saved, W, D), dtype=torch.float32, device=dev)
        chain_lp = torch.empty((n_saved, W), dtype=torch.float32,
                               device=dev)
        frame = 0
        chunks = chain_chunk_schedule(n_steps, thin)
        for n_inner, seed in zip(chunks, _seeds(rng, len(chunks))):
            n_keep = n_inner // thin if store_chain else 0
            stretch_steps(x, lp, acc, sacc, beta, db, seed, n_inner,
                          self.consts, thin=thin if store_chain else 0,
                          out=(chain[frame:frame + n_keep],
                               chain_lp[frame:frame + n_keep]),
                          partner=partner or self.partner)
            frame += n_keep
        return chain, chain_lp, sacc[:K - 1]

    def run(self, p0: torch.Tensor, n_steps: int, rng: np.random.Generator,
            thin: int = 1, store_chain: bool = True) -> EnsembleResult:
        """Plain stretch-move ensemble from p0 (W, D)."""
        W, D = p0.shape
        if W % 2:
            raise ValueError("need an even number of walkers")
        # a copy: the steps update their state in place, never the caller's
        x = p0.to(self.device, torch.float32).reshape(1, W, D).clone()
        lp = self.log_prob_batch(x[0]).reshape(1, W)
        acc = torch.zeros((1, W), dtype=torch.float32, device=self.device)
        chain, chain_lp, _ = self._steps(x, lp, acc, np.ones(1), n_steps,
                                         rng, thin, store_chain)
        return EnsembleResult(
            chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
            acceptance_fraction=(acc[0] / max(n_steps, 1)).cpu().numpy(),
            final_state=(x[0], lp[0]))

    def run_tempered(self, p0: torch.Tensor, betas, n_steps: int,
                     rng: np.random.Generator,
                     thin: int = 1) -> TemperedResult:
        return run_tempered_kernel(self, p0, betas, n_steps, rng, thin=thin)

    def _sharded_layout_ok(self, W: int, n_steps: int, thin: int, mesh,
                           axis: str = "walker") -> bool:
        """The per-shard runners' argument checks, made here so that a
        layout they would refuse sends the caller to another sampler
        (``run_coupled_sharded``), while a fault inside the sharded path
        still raises.  Below 2*ndim+2 walkers per shard independent
        ensembles are unsound: decline, with a warning."""
        n_dev = mesh.shape[axis]
        if W % n_dev or (W // n_dev) % 2 or n_steps % thin:
            return False
        floor = min_walkers_per_device(self.consts.ints["D"])
        if W // n_dev < floor:
            warnings.warn(
                f"{W // n_dev} walkers per device is below 2*ndim+2 = "
                f"{floor}: independent per-device kernel ensembles would "
                f"be unsound, falling back to a sampler that keeps the "
                f"ensemble whole", stacklevel=3)
            return False
        return True

    def run_sharded(self, p0: torch.Tensor, n_steps: int,
                    rng: np.random.Generator, mesh, thin: int = 1,
                    verbose: bool = False) -> EnsembleResult | None:
        """Plain sampling over a mesh: independent per-shard ensembles
        through the step kernel (``run_sharded_kernel_ensembles``).  Below
        64 walkers per shard, where such ensembles mix worse, the run goes
        to the hybrid coupled sampler instead (windows of local steps and
        one step coupled across the mesh, kernel 6), with ``sync_every``
        = 1 (mod thin) near 100, provided the run's first call is long
        enough for four windows.  That decision is sticky per (W, n_dev,
        thin) until ``new_run``.  The hybrid realises n_windows *
        sync_every ~ n_steps steps and declares its frame spacing on the
        result.  Returns None for a layout the runners refuse."""
        from ..parallel import kernel_sharded

        W = p0.shape[0]
        if not self._sharded_layout_ok(W, n_steps, thin, mesh):
            return None
        n_dev = mesh.shape["walker"]
        w_loc = W // n_dev
        if w_loc < 64:
            sync_every = thin * max(1, round(99 / thin)) + 1
            rkey = (W, n_dev, thin)
            use_hybrid = self._hybrid_routes.get(rkey)
            if use_hybrid is None:
                use_hybrid = n_steps >= 4 * sync_every
                self._hybrid_routes[rkey] = use_hybrid
                if use_hybrid and verbose:
                    print(f"note: {w_loc} walkers/device < 64 — using the "
                          f"hybrid coupled sampler (sync_every="
                          f"{sync_every})")
            if use_hybrid:
                # the floor was checked above; allow_small only silences
                # the runner's advisory sub-64 warning
                return kernel_sharded.run_hybrid_coupled_ensemble(
                    self.consts, p0, max(1, round(n_steps / sync_every)),
                    sync_every, _seeds(rng, 1)[0], mesh, thin=thin,
                    allow_small=True)
        return kernel_sharded.run_sharded_kernel_ensembles(
            self.consts, p0, n_steps, rng, mesh, thin=thin)

    def run_coupled_sharded(self, p0: torch.Tensor, n_steps: int,
                            rng: np.random.Generator, mesh,
                            thin: int = 1) -> EnsembleResult:
        """Plain sampling of ONE ensemble over the mesh, every step
        coupled across the shards (kernel 6): exact for any number of
        shards, at two launches and two gathers per shard and step.  The
        route for a layout ``run_sharded`` declines; the runner raises
        where the half-ensemble does not divide over the shards."""
        from ..parallel import kernel_sharded

        return kernel_sharded.run_coupled_sharded_ensemble(
            self.consts, p0, n_steps, _seeds(rng, 1)[0], mesh, thin=thin)

    def run_tempered_sharded(self, p0: torch.Tensor, betas, n_steps: int,
                             rng: np.random.Generator, mesh,
                             thin: int = 1) -> TemperedResult | None:
        """Tempered sampling over a mesh: independent K-rung ensembles
        per shard (the step kernel).  Returns None for a layout the runner
        refuses."""
        from ..parallel import kernel_sharded

        W = p0.shape[-2]
        if not self._sharded_layout_ok(W, n_steps, thin, mesh):
            return None
        return kernel_sharded.run_sharded_tempered_ensembles(
            self.consts, p0, betas, n_steps, rng, mesh, thin=thin)


def run_tempered_kernel(sampler: KernelSampler, p0: torch.Tensor, betas,
                        n_steps: int, rng: np.random.Generator,
                        thin: int = 1, partner: str | None = None,
                        store_chain: bool = True) -> TemperedResult:
    """K-rung tempered sampling from p0 (K, W, D), or (W, D) replicated
    to every rung, under the partner law ``partner`` (default: the
    sampler's, 'auto': the roll above 4096 walkers per rung).  Without
    ``store_chain`` no frame is kept (a burn-in): the chain is empty."""
    betas = np.asarray(betas, dtype=np.float64)
    K = betas.size
    if K < 2:
        raise ValueError(f"tempering needs at least 2 betas (got {K}); use "
                         "KernelSampler.run for a single rung")
    x = p0.to(sampler.device, torch.float32)
    if x.dim() == 2:
        x = x[None].expand(K, *x.shape)
    x = x.clone(memory_format=torch.contiguous_format)
    _, W, D = x.shape
    if W % 2:
        raise ValueError("need an even number of walkers")
    lp = sampler.log_prob_batch(x.reshape(K * W, D)).reshape(K, W)
    acc = torch.zeros((K, W), dtype=torch.float32, device=sampler.device)
    chain, chain_lp, sacc = sampler._steps(x, lp, acc, betas, n_steps, rng,
                                           thin, store_chain=store_chain,
                                           partner=partner)
    n = max(n_steps, 1)
    return TemperedResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / n).cpu().numpy(),
        swap_acceptance=sacc.cpu().numpy().astype(float) / float(n * W),
        final_state=(x, lp))


def make_kernel_sampler(sess) -> KernelSampler:
    """The kernel sampler of a session, on the session's device."""
    return KernelSampler(pack_consts(sess))


def run_multicluster_steps(stack: JointConstsStack, x: torch.Tensor,
                           lp: torch.Tensor, acc: torch.Tensor,
                           n_steps: int, seed: int, thin: int | None = None):
    """Advance the C ensembles x (C, W, D), lp/acc (C, W) in place by
    ``n_steps`` stretch steps, cluster c against ``stack.clusters[c]``;
    step i draws Philox bits at (seed, i); one launch of kernel 4.  With
    ``thin``, returns the frames kept every ``thin`` steps as device
    tensors ``(chain (C, n_keep, W, D), chain_lp (C, n_keep, W))``, else
    None."""
    if thin is not None and (thin <= 0 or n_steps % thin):
        raise ValueError(f"n_steps ({n_steps}) must be a positive "
                         f"multiple of thin ({thin})")
    frames = stretch_steps_multicluster(x, lp, acc, seed, n_steps, stack,
                                        thin=thin or 0)
    return frames if thin is not None else None


def multicluster_start(session, sz_stack, xray_stack, centers,
                       n_walkers: int, seed: int, init_spread: float):
    """The kernel route's start, the same on every process of a job: the
    constants of every cluster on the session's device, the walkers drawn
    from a generator seeded by ``seed`` (finite by kernel 1, per cluster)
    and their log-posteriors.  Returns ``(stack, x (C, W, D), lp (C, W),
    acc (C, W) zeros)``."""
    from .batched import batched_init

    dev = session.device
    stack = pack_consts_stack(session, sz_stack, xray_stack, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    x = batched_init(lambda th: multicluster_ll(th, stack), centers,
                     n_walkers, gen, device=dev, dtype=torch.float32,
                     spread=init_spread).contiguous()
    lp = multicluster_ll(x, stack)
    acc = torch.zeros(lp.shape, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return stack, x, lp, acc


def fit_multicluster_kernel(session, sz_stack, xray_stack, centers, *,
                            n_walkers, n_burn, n_steps, thin, seed,
                            init_spread, mesh=None):
    """C stacked ensembles fit on kernel 4 (the survey's and SBC's kernel
    route): one constants build shared by burn and sampling, init and
    lp0 through the joint-likelihood kernel per cluster, burn on Philox
    seed ``2 seed + 1`` and sampling on ``2 seed + 2``, acceptance reset
    after the burn.  Over a mesh with more than one ``cluster`` shard,
    shard s of n runs its cluster block on the call's seed ``* n + s``.
    Returns ``(chain (n_saved, C, W, D), lp_chain, acceptance,
    timings)``; raises ``StackMismatch`` for a stack outside the
    specialisation."""
    from .stretch import validate_schedule

    validate_schedule(n_steps, thin, n_walkers)
    t0 = time.time()
    stack, x, lp, acc = multicluster_start(session, sz_stack, xray_stack,
                                           centers, n_walkers, seed,
                                           init_spread)
    t_setup = time.time() - t0

    t0 = time.time()
    n_dev = mesh.shape.get("cluster", 1) if mesh is not None else 1
    if n_dev > 1:
        from ..parallel.kernel_sharded import make_sharded_multicluster_step

        def seeds(s):
            return [s * n_dev + d for d in range(n_dev)]

        if n_burn:
            x, lp, _ = make_sharded_multicluster_step(
                stack, mesh, n_burn)(x, lp, acc, seeds(2 * seed + 1))
        x, lp, acc, chain, chain_lp = make_sharded_multicluster_step(
            stack, mesh, n_steps, thin=thin)(x, lp, torch.zeros_like(acc),
                                             seeds(2 * seed + 2))
    else:
        if n_burn:
            run_multicluster_steps(stack, x, lp, acc, n_burn, 2 * seed + 1)
            acc.zero_()
        chain, chain_lp = run_multicluster_steps(stack, x, lp, acc, n_steps,
                                                 2 * seed + 2, thin=thin)
    chain = chain.permute(1, 0, 2, 3).cpu().numpy()
    chain_lp = chain_lp.permute(1, 0, 2).cpu().numpy()
    acc = (acc / float(n_steps)).cpu().numpy()
    t_sampling = time.time() - t0
    return chain, chain_lp, acc, {"setup_s": t_setup,
                                  "sampling_s": t_sampling}
