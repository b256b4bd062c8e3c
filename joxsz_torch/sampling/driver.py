"""High-level fit driver: MLE -> walker init -> preliminary -> burn ->
tempered sampling -> convergence-driven extension.

Torch counterpart of ``joxsz_tpu/sampling/driver.py::run_fit`` (phase
structure of the reference ``mcmc_run``, joxsz_funcs.py:572-635).  With a
step sampler (``sampling.kernel.KernelSampler``, the default of the CLI)
the phases run through the CUDA kernels as numbered below; without one
they run through the plain samplers ``run_ensemble`` /
``run_tempered_ensemble`` on ``log_like_batch`` (the model's own, or the
fused one of ``JointModel.log_like_batch_fused``):

  1. MLE warm start on the plain float64 likelihood, on the host CPU as
     the JAX package runs it (``sampling.mle``);
  2. walker initialisation around the MLE, rejection-redrawn to finite
     log-probabilities (kernel 1);
  3. "preliminary" rounds of ``prelim_iterations`` plain steps repeated
     while the best log-probability still improves (kernel 1, the step
     kernel);
  4. ``nburn`` plain burn-in steps (the step kernel);
  5. ``nsteps`` sampling steps thinned by ``nthin``, K-rung tempered when
     ``n_temper_rungs > 1`` (the step kernel), else plain;
  6. auto-extend: further ``nsteps`` chunks from the final state (the
     full replica ladder) until the cold chain spans >= 20 x the worst
     integrated autocorrelation time and its tau-thinned split-R-hat is
     <= ``target_rhat``, or ``auto_extend`` chunks are spent; where the
     length rule passes and only the trailing half certifies, the head is
     promoted to burn-in (``timings["extra_burn_steps"]``) instead.

With a ``mesh`` (``parallel.make_mesh``) only the sampling phase is
sharded: through the step sampler's ``run_sharded`` /
``run_tempered_sharded`` (independent per-shard kernel ensembles, or
below 64 walkers per shard the hybrid coupled sampler); a layout that
sampler declines (fewer than 2*ndim+2 walkers per shard, or a walker
count that does not divide) runs as ONE ensemble coupled across the mesh
(``parallel.kernel_sharded.run_coupled_sharded_ensemble``, kernel 6),
which is exact for any number of shards, and raises where the half
ensemble does not divide over them.  Without a step sampler the mesh
runs the plain sampler ``parallel.sharded.run_sharded_ensemble``.  Prelim
rounds and burn-in stay on one device.  A result may declare its own frame spacing (the
hybrid's frames lie slightly more than ``nthin`` steps apart); every
saved-frame to raw-step conversion reads it.

Around the phases, as the JAX package's ``run_fit``: the MLE may come
from a self-validating disk cache (``mle_cache``); a resume
(``resume_from``, a state file of an earlier run) skips the MLE, init,
prelim and burn-in and continues the saved walkers — the whole (K, W, D)
replica ladder when its rung count matches — on a generator seeded from
the state's unconsumed draw, folded once; the chain goes to
``chain_path`` (emcee's HDF5 layout, or its ``.npz`` twin), flushed every
``checkpoint_every`` saved frames on the plain path and after every
auto-extend round; ``best_path`` gets ``fit.dat`` and ``state_path`` the
resume point.  ``move`` 'de' / 'snooker' (emcee's differential-evolution
moves) run on the plain sampler only.  Per-phase wall times land in
``FitResult.timings``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .kernel import KernelSampler
from .mle import find_mle, find_mle_cached, mle_device
from .stretch import (MOVES, EnsembleResult, generate_init_positions,
                      run_ensemble)
from .tempered import default_betas, run_tempered_ensemble
from ..io.checkpoint import (load_state, save_best_fit, save_chain,
                             save_state)
from ..postproc.summary import integrated_autocorr_time, convergence_rhat

_DIAG_WALKERS = 256      # walker sequences the stopping rule watches


@dataclasses.dataclass
class FitResult:
    chain: np.ndarray             # (n_saved, n_walkers, ndim)
    log_prob: np.ndarray          # (n_saved, n_walkers)
    acceptance_fraction: np.ndarray
    mle_theta: np.ndarray
    mle_loglike: float
    param_names: list[str]
    timings: dict
    final_state: tuple = ()       # (x, lp) of the sampled rung(s)

    @property
    def flat_chain(self) -> np.ndarray:
        """((n_saved*n_walkers), ndim), walker-major like the reference's
        order='F' reshape (joxsz_main.py:213-214)."""
        n_saved, n_w, ndim = self.chain.shape
        return np.transpose(self.chain, (1, 0, 2)).reshape(-1, ndim)

    def cube_chain(self) -> np.ndarray:
        """(n_walkers, n_saved, ndim) — the reference's mcmc.chain layout."""
        return np.transpose(self.chain, (1, 0, 2))

    def summary_rows(self, units: list[str] | None = None):
        med = np.median(self.flat_chain, axis=0)
        std = np.std(self.flat_chain, axis=0)
        units = units or ["."] * len(self.param_names)
        return list(zip(self.param_names, med, std, units))

    def print_summary(self, units: list[str] | None = None):
        print(f"{'':>18}|{'Median':>10} |{'Sd':>9} |{'Unit':>13}")
        print("-" * 53)
        for name, med, std, unit in self.summary_rows(units):
            print(f"{name:>17} |{med:>9.3f} |{std:>8.3f} |{unit:>13}")


def _diag_chain(c: np.ndarray) -> np.ndarray:
    """A strided subset of at most _DIAG_WALKERS walker sequences: tau is
    a property of the move, and 256 sequences are ample for split-R-hat."""
    w = c.shape[1]
    if w <= _DIAG_WALKERS:
        return c
    return c[:, :: max(1, w // _DIAG_WALKERS)][:, :_DIAG_WALKERS]


def convergence(chain: np.ndarray, thin: float) -> tuple[float, float]:
    """(worst integrated autocorrelation time in raw steps, tau-thinned
    max split-R-hat) of a saved chain; (inf, inf) below 8 frames."""
    if chain.shape[0] < 8:
        return np.inf, np.inf
    dc = _diag_chain(chain)
    tau_saved = float(np.max(np.maximum(integrated_autocorr_time(dc), 1.0)))
    return tau_saved * thin, convergence_rhat(dc, tau_saved=tau_saved)


_SEED_MAX = 2 ** 63 - 1


def resumed_generator(key) -> np.random.Generator:
    """The generator of a run resumed from a state file's ``key`` (the
    unconsumed draw its run saved), folded once — ``jax.random.fold_in(
    key, 1)`` in the JAX package — so the resume starts a stream of its
    own rather than replaying the saved one."""
    return np.random.default_rng([int(k) for k in np.ravel(key)] + [1])


def run_fit(model, step_sampler: KernelSampler | None, theta0: np.ndarray,
            lo: np.ndarray, hi: np.ndarray, param_names: list[str], *,
            log_like_batch=None,
            nwalkers: int = 30, nburn: int = 2000, nsteps: int = 5000,
            nthin: int = 5, seed: int | None = None,
            initspread: float = 0.1, prelim_iterations: int = 1000,
            max_prelim_rounds: int = 10, n_temper_rungs: int = 0,
            auto_extend: int = 0, target_rhat: float = 1.01,
            do_mle: bool = True, mesh=None,
            chain_path: str | None = None, state_path: str | None = None,
            best_path: str | None = None, resume_from: str | None = None,
            checkpoint_every: int = 500, mle_cache: str | None = None,
            move: str = "stretch", verbose: bool = True) -> FitResult:
    """Full fit of ``model`` (a ``JointModel``).

    ``step_sampler``: the kernel sampler, or None for the plain samplers.
    ``log_like_batch``: an explicit batched log-posterior (N, D) -> (N,);
    when given it judges the walker initialisation, and it is what the
    plain samplers evaluate.  It defaults to the step sampler's kernel-1
    likelihood, else to ``model.log_like_batch``
    (``joxsz_tpu/sampling/driver.py:181-183``).  ``do_mle=False`` starts
    the walkers around ``theta0`` itself.  ``mesh``: shard the sampling
    phase over its ``walker`` axis (stretch moves only; the hybrid
    realises n_windows * sync_every ~ nsteps steps).

    ``mle_cache``: a JSON file for ``find_mle_cached``.  ``resume_from``:
    a state file written by ``state_path`` of an earlier run.
    ``chain_path``: the chain file (``.hdf5``, or ``.npz`` where h5py is
    missing), written with burn ``nburn`` plus any head promoted to
    burn-in.  ``move``: 'stretch', 'de' or 'snooker'; the step kernels,
    the mesh and the tempered paths take the stretch move only, and
    refuse another rather than downgrade it."""
    if move not in MOVES:
        raise ValueError(f"unknown move {move!r}: expected one of {MOVES}")
    if move != "stretch":
        if step_sampler is not None:
            raise ValueError(
                f"move={move!r} is not available through the step kernels "
                "(stretch only); sample on the plain sampler "
                "(step_sampler=None, --no-step-kernel) or use "
                "move='stretch'")
        if mesh is not None or n_temper_rungs > 1:
            raise ValueError(
                f"move={move!r} is not available on the mesh/tempered "
                "paths (stretch only)")
    dev = (step_sampler.device if step_sampler is not None
           else model.sz_data.L.device)
    # the kernels' state is float32; the plain samplers work in the
    # session's dtype
    dtype = (torch.float32 if step_sampler is not None
             else model.sz_data.L.dtype)
    if log_like_batch is None:
        log_like_batch = (step_sampler.log_prob_batch
                          if step_sampler is not None
                          else model.log_like_batch)
    timings: dict = {}
    resumed = None
    if resume_from is not None:
        resumed = load_state(resume_from)
        rng = resumed_generator(resumed["key"])
        if verbose:
            print(f"resuming from {resume_from} "
                  f"({resumed['positions'].shape[0]} walkers)")
    else:
        rng = np.random.default_rng(0 if seed is None else seed)
    if nsteps % nthin:
        nsteps -= nsteps % nthin
        if verbose:
            print(f"note: nsteps rounded down to {nsteps} "
                  f"(multiple of thin={nthin})")

    if mesh is not None and step_sampler is not None:
        # a fit is one logical run: forget a reused sampler's sticky
        # routing (hybrid or independent ensembles) of an earlier fit
        step_sampler.new_run()
        if verbose:
            print("note: mesh run — the sampling phase uses per-device "
                  "kernel ensembles; prelim and burn-in stay on one device")

    # 1. MLE on the plain float64 likelihood, on the host CPU
    t0 = time.time()
    ran_mle = do_mle and resumed is None
    if resumed is not None:
        mle_theta = resumed["positions"][np.argmax(resumed["log_probs"])]
        mle_ll = float(np.max(resumed["log_probs"]))
    elif do_mle:
        if verbose:
            print(f"MLE warm start (float64 on {mle_device(dev).type})...")
        if mle_cache is not None:
            mle_theta, mle_ll, hit = find_mle_cached(
                model, theta0, lo, hi, mle_cache, device=dev,
                verbose=verbose)
            timings["mle_cached"] = hit
        else:
            mle_theta, mle_ll = find_mle(model, theta0, lo, hi, device=dev,
                                         verbose=verbose)
    else:
        mle_theta = np.asarray(theta0, dtype=np.float64)
        with torch.no_grad():
            mle_ll = float(model.log_like(torch.as_tensor(
                mle_theta, dtype=model.sz_data.L.dtype, device=dev)))
    timings["mle_s"] = time.time() - t0
    timings["mle_device"] = mle_device(dev).type if ran_mle else "none"

    # 2. walker init
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, _SEED_MAX)))
    if resumed is not None:
        p0 = torch.as_tensor(resumed["positions"], dtype=dtype, device=dev)
        nwalkers = p0.shape[0]
    else:
        p0 = generate_init_positions(log_like_batch, mle_theta, nwalkers,
                                     gen, device=dev, dtype=dtype,
                                     spread=initspread, lo=lo, hi=hi)

    def plain_run(state, n, thin=1, store_chain=True):
        """``n`` plain (untempered) steps through the configured route."""
        if step_sampler is not None:
            return step_sampler.run(state, n, rng, thin=thin,
                                    store_chain=store_chain)
        with torch.no_grad():
            return run_ensemble(log_like_batch, state, n, gen, thin=thin,
                                store_chain=store_chain, move=move)

    timings["init_s"] = time.time() - t0

    # 3. preliminary rounds (reference joxsz_funcs.py:589-598)
    t0 = time.time()
    best = mle_ll
    rounds = 0
    while resumed is None and rounds < max_prelim_rounds:
        res = plain_run(p0, prelim_iterations, store_chain=False)
        p0 = res.final_state[0]
        newbest = float(res.final_state[1].max())
        rounds += 1
        if verbose:
            print(f"preliminary round {rounds}: best ll {newbest:.2f}")
        if newbest < best:
            break
        best = newbest
    timings["prelim_s"] = time.time() - t0
    timings["prelim_rounds"] = rounds

    # 4. burn-in
    t0 = time.time()
    p1 = (plain_run(p0, nburn, store_chain=False).final_state[0]
          if nburn and resumed is None else p0)
    timings["burn_s"] = time.time() - t0

    # 5. sampling
    t0 = time.time()
    swap_rounds = []
    mesh_note = [verbose]

    def declined(to: str):
        if mesh_note[0]:
            mesh_note[0] = False
            print(f"note: sharded kernel sampler declined; running {to}")

    def mesh_run(state, n):
        """One untempered sampling call over the mesh.  With a step
        sampler every route goes through the kernels: per-shard ensembles
        or the hybrid, else one ensemble coupled across the mesh (it
        raises for a half-ensemble that does not divide).  Without one,
        the plain mesh sampler on ``log_like_batch``."""
        if step_sampler is None:
            from ..parallel.sharded import run_sharded_ensemble

            with torch.no_grad():
                return run_sharded_ensemble(log_like_batch, state, n, gen,
                                            mesh, thin=nthin)
        r = step_sampler.run_sharded(state, n, rng, mesh, thin=nthin,
                                     verbose=verbose)
        if r is None:
            declined("one ensemble coupled across the mesh")
            r = step_sampler.run_coupled_sharded(state, n, rng, mesh,
                                                 thin=nthin)
        return r

    tempered = n_temper_rungs > 1
    if tempered:
        betas = default_betas(n_temper_rungs)

        def sample(state, n):
            r = None
            if mesh is not None and step_sampler is not None:
                r = step_sampler.run_tempered_sharded(
                    state, betas, n, rng, mesh, thin=nthin)
                if r is None:
                    declined("the single-device tempered kernel sampler")
            if r is None and step_sampler is not None:
                r = step_sampler.run_tempered(state, betas, n, rng,
                                              thin=nthin)
            if r is None:
                with torch.no_grad():
                    r = run_tempered_ensemble(log_like_batch, state, betas,
                                              n, gen, thin=nthin)
            swap_rounds.append(r.swap_acceptance)
            if verbose:
                print("swap acceptance per rung boundary: "
                      f"{np.round(r.swap_acceptance, 3)}")
            return EnsembleResult(
                chain=r.chain, log_prob=r.log_prob,
                acceptance_fraction=r.acceptance_fraction[0],
                final_state=r.final_state)

        # a resume continues the saved equilibrated replica ladder when the
        # state carries one with a matching rung count; otherwise the
        # runner replicates the cold rung (and says so)
        if resumed is not None and "temper_state" in resumed:
            ts = np.asarray(resumed["temper_state"])
            if ts.shape[0] == n_temper_rungs:
                p1 = torch.as_tensor(ts, dtype=dtype, device=dev)
                if verbose:
                    print(f"resuming the full {ts.shape[0]}-rung replica "
                          "ladder from the saved state")
            elif verbose:
                print(f"note: saved ladder has {ts.shape[0]} rungs but "
                      f"--temper {n_temper_rungs} was requested; "
                      "restarting the ladder from a replicated cold rung")
    elif mesh is not None:
        sample = mesh_run
    else:
        def sample(state, n):
            return plain_run(state, n, thin=nthin)

    def spacing(r) -> float:
        """Raw steps per saved frame of this result: ``nthin`` unless the
        sampler declared otherwise."""
        return float(r.frame_spacing or nthin)

    def save_key() -> np.ndarray:
        """An unconsumed draw for a resume's generator."""
        return rng.integers(0, _SEED_MAX, size=1)

    meta = {"param_names": list(param_names), "nburn": nburn,
            "nthin": nthin, "seed": seed}
    if not tempered and chain_path and nsteps // nthin > checkpoint_every:
        # incremental persistence (the reference's HDF backend writes the
        # chain as it goes): sample in chunks of checkpoint_every frames,
        # flushing the chain and the resume state after each
        parts, part_lps, acc_total, done, x = [], [], 0.0, 0, p1
        while done < nsteps:
            n = min(checkpoint_every * nthin, nsteps - done)
            r = sample(x, n)
            parts.append(r.chain)
            part_lps.append(r.log_prob)
            acc_total = acc_total + r.acceptance_fraction * n
            x = r.final_state[0]
            done += n
            save_chain(chain_path, np.concatenate(parts),
                       np.concatenate(part_lps), acc_total / done,
                       param_names, nburn, nthin,
                       frame_spacing=spacing(r))
            if state_path:
                save_state(state_path, x.detach().cpu().numpy(),
                           r.final_state[1].detach().cpu().numpy(),
                           save_key(), {**meta, "steps_done": done})
        res = EnsembleResult(
            chain=np.concatenate(parts), log_prob=np.concatenate(part_lps),
            acceptance_fraction=acc_total / done,
            final_state=(x, r.final_state[1]), frame_spacing=r.frame_spacing)
    else:
        res = sample(p1, nsteps)
    chains, lps, accs = [res.chain], [res.log_prob], [res.acceptance_fraction]
    state = res.final_state[0]

    # 6. convergence-driven extension
    steps = nsteps
    ext = 0
    diag_s = 0.0
    td = time.time()
    tau, rh = convergence(res.chain, spacing(res))
    diag_s += time.time() - td
    chain_steps = res.chain.shape[0] * spacing(res)
    extra_burn = 0
    while ext < auto_extend and not (chain_steps >= 20 * tau
                                     and rh <= target_rhat):
        # the warmup-aware fallback of joxsz_tpu/sampling/driver.py:489-
        # 528: an insufficient burn-in leaves a transient at the head of
        # the accumulated chain that holds split-R-hat above the bar however
        # long the run extends; where the length rule passes and the
        # trailing half certifies on both rules, the head is promoted to
        # burn-in instead
        full = np.concatenate(chains)
        n0 = full.shape[0] // 2
        if n0 >= 8 and chain_steps >= 20 * tau:
            td = time.time()
            tau2, rh2 = convergence(full[n0:], spacing(res))
            diag_s += time.time() - td
            if (full.shape[0] - n0) * spacing(res) >= 20 * tau2 \
                    and rh2 <= target_rhat:
                extra_burn += int(round(n0 * spacing(res)))
                chains, lps = [full[n0:]], [np.concatenate(lps)[n0:]]
                tau, rh = tau2, rh2
                if verbose:
                    kept = (full.shape[0] - n0) * spacing(res)
                    print(f"auto-extend: head transient — promoted the "
                          f"first {extra_burn} sampled steps to burn-in; "
                          f"the trailing {kept:.0f} certify (split-Rhat "
                          f"{rh2:.3f} <= {target_rhat})")
                break
        if verbose:
            need = (f"steps {chain_steps:.0f} < 20*tau {20 * tau:.0f}"
                    if chain_steps < 20 * tau else f"split-Rhat {rh:.3f} > "
                    f"{target_rhat}")
            print(f"auto-extend round {ext + 1}/{auto_extend}: {need} — "
                  f"sampling {nsteps} more steps")
        res = sample(state, nsteps)
        state = res.final_state[0]
        chains.append(res.chain)
        lps.append(res.log_prob)
        accs.append(res.acceptance_fraction)
        steps += nsteps
        ext += 1
        td = time.time()
        # the sticky routing keeps every round on one sampling law, so one
        # spacing describes the whole chain
        tau, rh = convergence(np.concatenate(chains), spacing(res))
        diag_s += time.time() - td
        chain_steps = sum(c.shape[0] for c in chains) * spacing(res)
        if chain_path:      # flush progress like the chunked path
            save_chain(chain_path, np.concatenate(chains),
                       np.concatenate(lps), np.mean(accs, axis=0),
                       param_names, nburn, nthin, frame_spacing=spacing(res))
    timings["sample_s"] = time.time() - t0
    timings["sample_diag_s"] = diag_s
    timings["auto_extend_rounds"] = ext
    timings["extra_burn_steps"] = extra_burn
    timings["tau_steps"] = tau
    timings["split_rhat"] = rh
    timings["frame_spacing"] = spacing(res)
    if swap_rounds:
        timings["swap_acceptance"] = np.mean(swap_rounds, axis=0).tolist()

    chain = np.concatenate(chains)
    log_prob = np.concatenate(lps)
    acc = np.mean(accs, axis=0)
    # a resumed run skips burn-in: its throughput counts no phantom evals
    burn_evals = 0 if resumed is not None else nburn
    n_evals = (rounds * prelim_iterations + burn_evals
               + steps * max(n_temper_rungs, 1)) * nwalkers
    total_s = timings["prelim_s"] + timings["burn_s"] + timings["sample_s"]
    timings["likelihood_evals"] = n_evals
    timings["evals_per_s"] = n_evals / total_s if total_s > 0 else np.nan
    if verbose:
        print(f"acceptance fraction: {float(np.mean(acc)):.3f}")
        print(f"throughput: {timings['evals_per_s']:.0f} likelihood evals/s "
              f"over {n_evals} evals")
        print(f"split-Rhat max {rh:.4f} (tau ~{tau:.0f} steps over {steps} "
              "sampled steps)")
        if rh > target_rhat:
            print(f"WARNING: split-Rhat max {rh:.3f} > {target_rhat} — "
                  "sequences disagree (more burn-in or steps needed)")

    # 7. outputs
    final_state = tuple(t.detach().cpu().numpy() for t in res.final_state)
    if best_path:
        save_best_fit(best_path, chain, log_prob, mle_theta, mle_ll,
                      param_names)
    if chain_path:
        # steps the auto-extend fallback promoted from the chain head to
        # burn-in are burn-in on disk too
        save_chain(chain_path, chain, log_prob, acc, param_names,
                   nburn + extra_burn, nthin, frame_spacing=spacing(res))
    if state_path:
        x, lp = final_state
        cold = (x[0], lp[0]) if x.ndim == 3 else (x, lp)
        save_state(state_path, *cold, save_key(),
                   {**meta, "nburn": nburn + extra_burn},
                   temper_state=x if x.ndim == 3 else None)
    return FitResult(chain=chain, log_prob=log_prob,
                     acceptance_fraction=acc, mle_theta=mle_theta,
                     mle_loglike=mle_ll, param_names=list(param_names),
                     timings=timings, final_state=final_state)
