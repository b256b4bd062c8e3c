"""Prior-measure utilities: exact draws from the normalized joint prior
and a Monte-Carlo estimate of its log-normalization.

Torch counterpart of ``joxsz_tpu/sampling/priors.py``.  The prior
(``ParamSet.log_prior`` plus the structural vetoes of
``JointModel.log_prior_only``: the density's r_c <= r_s prior and the
physical-mass veto, reference joxsz_funcs.py:397-407 and :522-525) is
unnormalized: box parameters contribute 0 inside [lo, hi], Gaussian ones
-0.5 z^2 without their constant, and the vetoes are {0, -inf}.

With the product proposal q = prod_box U(lo, hi) x prod_gauss N(mu,
sigma) the ratio exp(log_prior - log q) is constant wherever the prior
is finite, so rejection on support gives exact prior draws, and

    log Z_prior = sum_box log(hi - lo) + sum_gauss log(sqrt(2 pi) sigma)
                  + log E_q[1{support}].

The draws come from a numpy ``Generator`` in the JAX package's order of
calls, so one seed gives the same draws bit for bit in both packages.
``log_prior_batch`` maps a float64 (N, D) numpy array to (N,) values;
``model_log_prior`` makes one from a ``JointModel`` that evaluates a
float64 copy of the model in chunks on a device, so a row near a veto
cannot flip between float32 and float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_product_proposal(params) -> float:
    """Validate that the product proposal covers the prior and return
    its analytic log-constant (the support-free part of log Z_prior)."""
    lo, hi = np.asarray(params.lo, float), np.asarray(params.hi, float)
    is_g = np.asarray(params.is_gauss, bool)
    sigma = np.asarray(params.sigma, float)
    box = ~is_g
    if not (np.all(np.isfinite(lo[box])) and np.all(np.isfinite(hi[box]))):
        raise ValueError(
            "box-prior parameters must have finite bounds to sample the "
            "prior (an improper uniform prior has no normalization)")
    if np.any(hi[box] <= lo[box]):
        raise ValueError("box-prior parameter with hi <= lo")
    return float(np.sum(np.log(hi[box] - lo[box]))
                 + np.sum(np.log(np.sqrt(2 * np.pi) * sigma[is_g])))


def product_prior_draws(params, n: int, rng: np.random.Generator,
                        dtype=np.float64) -> np.ndarray:
    """(n, ndim) draws from the product proposal q: uniform on each box
    parameter, untruncated N(mu, sigma) on each Gaussian-prior one.  Not
    yet prior draws (the vetoes still need rejection): ``sample_prior``
    gives exact ones."""
    _check_product_proposal(params)
    lo, hi = np.asarray(params.lo, float), np.asarray(params.hi, float)
    is_g = np.asarray(params.is_gauss, bool)
    out = np.empty((n, params.ndim), dtype=dtype)
    box = ~is_g
    out[:, box] = rng.uniform(lo[box], hi[box], size=(n, int(box.sum())))
    out[:, is_g] = rng.normal(np.asarray(params.mu, float)[is_g],
                              np.asarray(params.sigma, float)[is_g],
                              size=(n, int(is_g.sum())))
    return out


# rows of one float64 prior evaluation (200 000 draws in 25 chunks)
PRIOR_CHUNK = 8192


def model_log_prior(model, device=None):
    """``log_prior_batch`` of a ``JointModel``: its ``log_prior_only`` on
    a float64 copy on ``device`` (default: the model's), PRIOR_CHUNK rows
    at a time; numpy (N, D) in, numpy (N,) out."""
    dev = model.sz_data.L.device if device is None else torch.device(device)
    m64 = model.to(dev, torch.float64)

    def log_prior_batch(thetas) -> np.ndarray:
        th = np.asarray(thetas, dtype=np.float64)
        out = np.empty(th.shape[0])
        with torch.no_grad():
            for i in range(0, th.shape[0], PRIOR_CHUNK):
                out[i:i + PRIOR_CHUNK] = m64.log_prior_only(torch.as_tensor(
                    th[i:i + PRIOR_CHUNK], device=dev)).cpu().numpy()
        return out

    return log_prior_batch


def sample_prior(log_prior_batch, params, n: int,
                 rng: np.random.Generator, max_tries: int = 64,
                 batch: int | None = None, dtype=np.float64) -> np.ndarray:
    """(n, ndim) exact draws from the normalized (veto-restricted) prior
    by rejection on finiteness of ``log_prior_batch`` (for a JointModel,
    ``model_log_prior(model)``)."""
    if n <= 0:
        raise ValueError(f"n ({n}) must be positive")
    _check_product_proposal(params)
    batch = max(n, 256) if batch is None else batch
    kept: list[np.ndarray] = []
    have = 0
    for _ in range(max_tries):
        cand = product_prior_draws(params, batch, rng, dtype=dtype)
        finite = np.isfinite(np.asarray(log_prior_batch(cand)))
        if finite.any():
            kept.append(cand[finite])
            have += int(finite.sum())
        if have >= n:
            return np.concatenate(kept, axis=0)[:n]
    raise RuntimeError(
        f"prior rejection sampling got {have}/{n} draws in {max_tries} "
        f"batches of {batch}: the vetoes leave a tiny support fraction — "
        "raise max_tries/batch or check the prior configuration")


def prior_log_norm(log_prior_batch, params, n_samples: int,
                   rng: np.random.Generator) -> tuple[float, float]:
    """Monte-Carlo log Z_prior = log of the integral of exp(log_prior),
    with its standard error on the log, ``(log_norm, log_norm_err)``: the
    analytic product constant plus the log of the support acceptance
    rate p, err = sqrt((1 - p) / (n p))."""
    if n_samples <= 0:
        raise ValueError(f"n_samples ({n_samples}) must be positive")
    const = _check_product_proposal(params)
    cand = product_prior_draws(params, n_samples, rng)
    n_ok = int(np.isfinite(np.asarray(log_prior_batch(cand))).sum())
    if n_ok == 0:
        return float("-inf"), float("inf")
    p = n_ok / n_samples
    return const + float(np.log(p)), float(np.sqrt((1 - p) / n_ok))
