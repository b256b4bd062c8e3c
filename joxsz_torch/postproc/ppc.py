"""Posterior-predictive model checking.

Torch counterpart of ``joxsz_tpu/postproc/ppc.py``: Bayesian p-values for
the joint fit.  For each posterior draw theta_s the dataset is replicated
through the likelihood's own noise model (SZ Gaussian with the real
per-point errors, X-ray Poisson) and a discrepancy T(data, theta_s) of
the replicated data is compared with the observed data's at the SAME
theta_s:

    p = P[ T(data_rep, theta) >= T(data_obs, theta) | data_obs ]

p near 0 or 1 flags misfit the posterior cannot absorb (Gelman et al.,
"Bayesian Data Analysis" ch. 6).  The discrepancies are the likelihoods'
own: the SZ chi^2 (whose -1/2 is the SZ log-likelihood) and the X-ray
Poisson deviance 2*sum(m - d + d*ln(d/m)) over unmasked annuli.

The model profiles come from one batched evaluation on the model's
device; the replicated data from the caller's numpy ``Generator`` in the
JAX package's order (``rng.normal`` for SZ, then ``rng.poisson`` for
X-ray), so the same draws and seed give the JAX package's p-values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PPCResult:
    """Per-probe Bayesian p-values and the discrepancy samples behind
    them (for histogram/scatter diagnostics)."""
    p_sz: float | None           # P(chi2_rep >= chi2_obs)
    p_xray: float | None         # P(dev_rep >= dev_obs)
    sz_obs: np.ndarray | None    # (S,) observed-data chi^2 at each draw
    sz_rep: np.ndarray | None    # (S,) replicated-data chi^2
    xray_obs: np.ndarray | None  # (S,) observed-data deviance
    xray_rep: np.ndarray | None  # (S,) replicated-data deviance


def _poisson_deviance(counts, pred, mask):
    """2*sum(m - d + d*ln(d/m)) with 0*ln(0) = 0, masked cells dropped."""
    d = counts
    with np.errstate(divide="ignore", invalid="ignore"):
        dlog = np.where(d > 0, d * np.log(np.where(d > 0, d, 1.0) / pred),
                        0.0)
    return 2.0 * np.sum(mask * (pred - d + dlog), axis=(-2, -1))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def posterior_predictive_pvalues(model, thetas, rng) -> PPCResult:
    """Posterior-predictive p-values from posterior draws.

    ``model``: ``JointModel`` with the OBSERVED data bound.  ``thetas``:
    (S, ndim) posterior sample (thinned to near-independence; S ~ a few
    hundred is plenty).  ``rng``: numpy Generator for the replicated
    draws (one replicated dataset per posterior draw).

    Draws with a non-positive predicted X-ray profile (outside the
    likelihood's support — the Cash veto gives them zero likelihood)
    raise."""
    thetas = np.atleast_2d(np.asarray(thetas, dtype=float))
    L = model.sz_data.L
    tt = torch.as_tensor(thetas, dtype=L.dtype, device=L.device)

    p_sz = p_x = None
    sz_obs = sz_rep = xr_obs = xr_rep = None

    if model.sz_data is not None:
        sz = model.sz_data
        with torch.no_grad():
            prof = _host(model.sz_profile(tt))                      # (S, np)
        mu = prof @ _host(sz.G).T                                   # (S, nd)
        err = _host(sz.flux_err)
        flux = _host(sz.flux)
        rep = mu + rng.normal(size=mu.shape) * err
        # the SZ likelihood masks NaN flux points (nansum): the replicated
        # chi^2 drops the SAME points, or each masked point adds a
        # ~chi2(1) term to the replicated side only and p_sz inflates
        valid = np.isfinite(flux) & np.isfinite(err)
        sz_obs = np.nansum(
            np.where(valid, ((flux - mu) / err) ** 2, 0.0), axis=1)
        sz_rep = np.nansum(
            np.where(valid, ((rep - mu) / err) ** 2, 0.0), axis=1)
        p_sz = float(np.mean(sz_rep >= sz_obs))

    if model.xray_data is not None:
        xr = model.xray_data
        with torch.no_grad():
            pred = _host(model.xray_profiles(tt))
        if np.any(pred <= 0):
            raise ValueError(
                "non-positive predicted X-ray counts at a supplied draw — "
                "these are not posterior samples of this model (the Cash "
                "positivity veto gives them zero likelihood)")
        mask = _host(xr.counts_mask)
        counts = _host(xr.counts_filled)
        rep = rng.poisson(pred).astype(float)
        xr_obs = _poisson_deviance(counts, pred, mask)
        xr_rep = _poisson_deviance(rep, pred, mask)
        p_x = float(np.mean(xr_rep >= xr_obs))

    return PPCResult(p_sz=p_sz, p_xray=p_x, sz_obs=sz_obs, sz_rep=sz_rep,
                     xray_obs=xr_obs, xray_rep=xr_rep)
