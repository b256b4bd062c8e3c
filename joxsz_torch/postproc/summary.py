"""Posterior summaries: tables, equal-tailed intervals, autocorrelation,
split-R-hat.

Counterpart of ``joxsz_tpu/postproc/summary.py`` (numpy/scipy): the
reference's posterior table (joxsz_main.py:217-223) as a JSON summary,
the windowed integrated autocorrelation time (the reference's
commented-out ``mcmc.acor``, joxsz_main.py:212) and the split-R-hat the
fit driver's auto-extend stopping rule reads.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from .profiles import equal_tailed


def autocorr_function(x: np.ndarray) -> np.ndarray:
    """Normalised autocorrelation of a 1-D series via FFT."""
    x = np.asarray(x, dtype=float)
    n = x.size
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acf = np.fft.irfft(f * np.conjugate(f), m)[:n]
    if acf[0] == 0:
        return np.zeros(n)
    return acf / acf[0]


def integrated_autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per parameter.

    chain: (n_steps, n_walkers, ndim).  Walker-averaged ACF with Sokal's
    automatic windowing (the emcee v3 estimator): tau = 1 + 2 sum rho(t),
    truncated at the smallest M with M >= c * tau(M).

    The per-walker ACFs are computed in row-chunked FFT batches
    (pocketfft applies the identical 1-D transform per row).  Float32
    chains (everything fetched from the device) run the FFTs in float32,
    a float32-eps-class relative tau perturbation; float64 input keeps
    float64 FFTs.  The whole pass is chunk-wise (mean-subtract, FFT,
    normalise, walker-sum accumulate per <=256-walker block), so peak
    extra memory is O(chunk * n_steps) instead of ~3x the chain."""
    chain = np.asarray(chain)
    n_steps, n_walkers, ndim = chain.shape
    m = 1 << (2 * n_steps - 1).bit_length()
    fdtype = (np.float32 if chain.dtype == np.float32 else np.float64)

    # chunk of 256 series per FFT batch: one giant batch falls out of cache
    chunk = 256
    acf = np.zeros((ndim, n_steps), dtype=np.float64)
    for d in range(ndim):
        for w0 in range(0, n_walkers, chunk):
            # (block, n_steps) walker-series block for one parameter —
            # the only float64 materialisation is this block
            blk = np.ascontiguousarray(
                chain[:, w0:w0 + chunk, d].T).astype(np.float64)
            # exact constant-series detection BEFORE mean subtraction:
            # the scalar guard (acf[0] == 0) is rounding-luck-dependent
            # — a batched mean can leave an O(eps) residual on a
            # constant series whose ACF then normalises to rho = 1
            const = (blk == blk[:, :1]).all(axis=1, keepdims=True)
            # mean subtraction stays float64: a float32 subtract of a
            # large common offset would eat the fluctuation's mantissa
            x = (blk - blk.mean(axis=1, keepdims=True)).astype(fdtype)
            f = np.fft.rfft(x, m, axis=1)
            acf_blk = np.fft.irfft(
                f.real**2 + f.imag**2, m, axis=1)[:, :n_steps]
            a0 = acf_blk[:, :1]
            dead = const | (a0 == 0)
            acf[d] += np.where(
                dead, 0.0, acf_blk / np.where(dead, 1.0, a0)).sum(
                    axis=0, dtype=np.float64)
    acf /= n_walkers

    taus = np.empty(ndim)
    steps = np.arange(n_steps)
    for d in range(ndim):
        tau_run = 2.0 * np.cumsum(acf[d]) - 1.0
        window = steps < c * tau_run
        if window.all():
            mi = n_steps - 1
        else:
            mi = int(np.argmin(window))
        taus[d] = tau_run[max(mi, 1)]
    return taus


def effective_samples(chain: np.ndarray) -> np.ndarray:
    """N_eff per parameter = total samples / tau."""
    n_steps, n_walkers, _ = chain.shape
    tau = integrated_autocorr_time(chain)
    return n_steps * n_walkers / np.maximum(tau, 1.0)


def chain_tau_steps(sub: np.ndarray, thin: float) -> np.ndarray:
    """Per-parameter integrated autocorrelation in RAW sampler steps from
    a thinned chain slice.

    ``thin`` is the frame spacing in raw steps and may be fractional: the
    hybrid coupled sampler saves frames thin*sync_every/(sync_every-1)
    steps apart (the chain file's ``frame_spacing`` attr /
    ``EnsembleResult.frame_spacing``) — pass that spacing, not the
    nominal thin.  The window must be long (chain length >> 5*tau_saved,
    the caller's responsibility); tau_saved is clamped >= 1 (a noisy ACF
    can return a negative tau for an uncorrelated parameter); reduce
    with tau.max(), never (n/tau).min()."""
    tau_saved = np.maximum(
        np.asarray(integrated_autocorr_time(sub)), 1.0)
    return tau_saved * thin


def collect_kernel_subchain(run_chunk, n_chunks: int, *, n_sub: int = 64,
                            ndim: int | None = None) -> np.ndarray:
    """Chunked thinned-chain collection for tau measurements.

    ``run_chunk(i)`` advances the caller's sampler state by one call and
    returns that chunk's thinned chain block as a tensor ``(n_keep,
    n_walkers, >= ndim)``; chunks must be continuous (each from the
    previous chunk's final state).  Only a ``(:, :n_sub, :ndim)`` slice
    is fetched to the host — tau is a property of the move, not of which
    walkers are watched — and the fetches start after every chunk is
    dispatched.  Returns the concatenated numpy subchain ``(n_saved,
    n_sub, ndim)`` for ``chain_tau_steps``."""
    subs = [run_chunk(i)[:, :n_sub, :ndim] for i in range(n_chunks)]
    return np.concatenate([s.detach().cpu().numpy() if hasattr(s, "detach")
                           else np.asarray(s) for s in subs])


def chain_diagnostics_from_file(path: str) -> dict:
    """Convergence diagnostics straight from a saved chain file (HDF5 or
    its ``.npz`` twin, ``io.checkpoint.load_chain``), reading its
    ``frame_spacing`` attr — the self-correcting way to get raw-step
    tau/length numbers whichever sampler produced the chain.

    Returns ``{"tau_steps": (ndim,) raw-step tau, "rhat": max split-R-hat,
    "chain_steps": raw steps spanned, "frame_spacing": spacing,
    "param_names": names}``."""
    from ..io.checkpoint import load_chain

    d = load_chain(path)
    spacing = d["frame_spacing"]
    chain = d["chain"]
    return {
        "tau_steps": chain_tau_steps(chain, spacing),
        "rhat": convergence_rhat(chain),
        "chain_steps": chain.shape[0] * spacing,
        "frame_spacing": spacing,
        "param_names": d["param_names"],
    }


def split_rhat(chain: np.ndarray, rank_normalize: bool = True) -> np.ndarray:
    """Split-R̂ convergence diagnostic per parameter (Gelman-Rubin with
    the split-chain + rank-normalization refinements of Vehtari et al.
    2021, "Rank-normalization, folding, and localization").

    chain: (n_steps, n_sequences, ndim).  Each sequence is split in half
    (m doubles, stationarity within a sequence shows up as between-half
    variance); with ``rank_normalize`` the draws are replaced by normal
    scores of their pooled ranks per parameter, making the statistic
    robust to heavy tails.  Converged: R̂ ≈ 1 (< 1.01 is the standard
    threshold); R̂ >> 1 means the sequences have not mixed into the same
    distribution.

    Statistical caveat for ensemble samplers: walkers within ONE
    Goodman-Weare ensemble interact, so walker-sequences are not
    independent and within-ensemble R̂ is mildly optimistic — still a
    useful stuck-walker/multimodality alarm.  Across INDEPENDENT
    ensembles (the multi-chip layout of
    ``parallel.run_sharded_kernel_ensembles``, or separate seeded fits)
    the sequences are truly independent and R̂ has its textbook meaning.
    The reference has no convergence diagnostic at all (SURVEY §5.5 —
    print-only observability)."""
    chain = np.asarray(chain, dtype=float)
    if chain.ndim != 3:
        raise ValueError(f"chain must be (n_steps, n_seq, ndim), "
                         f"got shape {chain.shape}")
    n, m, d = chain.shape
    if n < 4:
        raise ValueError(f"need >= 4 steps for split-Rhat, got {n}")
    half = n // 2
    # split each sequence into first/last halves (odd middle draw dropped)
    seqs = np.concatenate([chain[:half], chain[n - half:]], axis=1)
    if rank_normalize:
        from scipy.special import ndtri
        from scipy.stats import rankdata

        flat = seqs.reshape(half * 2 * m, d)
        r = rankdata(flat, axis=0, method="average")
        # Blom offset keeps the normal scores finite at the extremes
        seqs = ndtri((r - 0.375) / (flat.shape[0] + 0.25)).reshape(
            half, 2 * m, d)
    seq_mean = seqs.mean(axis=0)                  # (2m, d)
    seq_var = seqs.var(axis=0, ddof=1)            # (2m, d)
    w = seq_var.mean(axis=0)                      # within-sequence
    b = half * seq_mean.var(axis=0, ddof=1)       # between-sequence
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / w)
    # a parameter constant across all draws carries no mixing signal
    return np.where(w > 0, rhat, 1.0)


def convergence_rhat(chain: np.ndarray,
                     tau_saved: float | None = None) -> float:
    """Max split-R̂ over parameters on tau-thinned draws — the form used
    by stopping rules (``run_fit`` warnings and ``auto_extend``).

    Raw split-R̂ over autocorrelated sequences is biased HIGH: the
    between-half variance of a correlated sequence exceeds what its
    within-half variance predicts at finite n/tau, so a perfectly
    converged chain sits above 1 by O(tau/n) (measured here: 1.015 raw
    vs 1.010 thinned on a converged 16-walker x 2000-step Gaussian GW
    chain).  Thinning the saved chain by the worst-parameter integrated
    autocorrelation time makes the draws ~independent, so the textbook
    1.01 threshold (Vehtari et al. 2021) is meaningful.  Falls back to
    the raw statistic when thinning would leave < 8 draws — such chains
    are far under the 20*tau length bar anyway, so the stopping rule
    keeps extending regardless.

    ``tau_saved``: worst-parameter tau in SAVED-draw units, if the
    caller already computed it (the full-chain ACF pass is expensive —
    don't pay it twice per stopping-rule round).
    Chains with < 4 saved draws cannot be assessed at all and return
    +inf (i.e. "not converged"), never raise."""
    chain = np.asarray(chain, dtype=float)
    if chain.shape[0] < 4:
        return float(np.inf)
    if tau_saved is None:
        tau_saved = float(np.max(np.maximum(
            np.asarray(integrated_autocorr_time(chain)), 1.0)))
    k = max(int(np.ceil(tau_saved)), 1)
    thinned = chain[::k]
    if thinned.shape[0] < 8:
        thinned = chain
    return float(np.max(split_rhat(thinned)))


def summary_dict(flat_chain: np.ndarray, param_names: list[str],
                 units: list[str] | None = None, ci: float = 95.0,
                 chain_3d: np.ndarray | None = None) -> dict:
    """The posterior table as a dict: per parameter median, std and the
    equal-tailed ``ci`` interval, and with ``chain_3d`` (n_saved, W, D)
    the autocorrelation time, N_eff and split-R-hat."""
    lo, med, hi = equal_tailed(flat_chain, ci)
    std = np.std(flat_chain, axis=0)
    out = {"ci": ci, "parameters": {}}
    units = units or ["."] * len(param_names)
    taus = neff = rhats = None
    if chain_3d is not None:
        taus = integrated_autocorr_time(chain_3d)
        neff = effective_samples(chain_3d)
        if chain_3d.shape[0] >= 4:
            rhats = split_rhat(chain_3d)
    for i, name in enumerate(param_names):
        entry = {
            "median": float(med[i]),
            "std": float(std[i]),
            "ci_low": float(lo[i]),
            "ci_high": float(hi[i]),
            "unit": units[i],
        }
        if taus is not None:
            entry["autocorr_time"] = float(taus[i])
            entry["n_eff"] = float(neff[i])
        if rhats is not None:
            entry["rhat"] = float(rhats[i])
        out["parameters"][name] = entry
    return out


def save_summary(path: str, summary: dict):
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(json.dumps(summary, indent=2))
