"""Laplace approximation: MAP + exact autograd Hessian -> Gaussian
posterior summary and a closed-form evidence estimate.

Torch counterpart of ``joxsz_tpu/sampling/laplace.py``.  The Hessian of
the joint log-posterior at the MAP comes from ``torch.autograd.
functional.hessian`` on a float64 copy of the model (``JointModel.to``)
on the device asked for — the card under ``run --laplace`` — and gives

* covariance / error-bar estimates before any MCMC,
* a Laplace log-evidence
  log Z ~= log p(MAP) + D/2 log(2 pi) - 1/2 log det(-H)
  that cross-checks the stepping-stone ladder (``sampling/evidence.py``).

``JointModel.log_like_batch`` is the unnormalized posterior density (box
priors contribute 0 inside their bounds), so ``log_z`` integrates that
measure; ``model_laplace`` subtracts the prior's log-normalization
(``sampling/priors.py``) for a ``log_z_normalized`` comparable to the
ladder's.

A MAP pinned at a box bound or a veto edge makes -H indefinite or
singular: the eigenvalues of -H and a per-parameter ``at_boundary`` mask
are reported, and ``ok`` is False when the Gaussian is improper, with
``cov``/``log_z`` NaN rather than pseudo-inverted; ``sd_conditional``
holds the error bars of the interior block, conditional on the pinned
values.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .mle import find_mle


@dataclasses.dataclass
class LaplaceResult:
    theta_map: np.ndarray          # (D,) posterior mode
    log_post_map: float            # unnormalized log-posterior at the mode
    hessian: np.ndarray            # (D, D) of the log-posterior at the mode
    eigenvalues: np.ndarray        # of -H, ascending (all > 0 iff proper)
    cov: np.ndarray                # (D, D) inv(-H); NaN if not ok
    sd: np.ndarray                 # (D,) sqrt(diag cov); NaN if not ok
    log_z: float                   # Laplace evidence, same measure as log_post
    ok: bool                       # -H positive definite
    at_boundary: np.ndarray        # (D,) bool: mode within rtol of a box bound
    sd_conditional: np.ndarray = None   # (D,) interior-block sd, boundary NaN
    log_z_normalized: float | None = None   # vs the normalized prior
    prior_log_norm: float | None = None
    prior_log_norm_err: float | None = None

    @property
    def correlation(self) -> np.ndarray:
        d = np.sqrt(np.diag(self.cov))
        return self.cov / np.outer(d, d)


def laplace_approximation(log_post, theta_map, lo=None, hi=None,
                          boundary_rtol: float = 1e-4) -> LaplaceResult:
    """Laplace approximation around a known mode ``theta_map``.

    ``log_post``: a differentiable scalar function of a (D,) tensor (for
    a JointModel, ``model.log_like``); ``theta_map`` a (D,) tensor, whose
    dtype and device the Hessian is taken in (a numpy array becomes a
    float64 tensor on the CPU).  Run it in float64: a second derivative
    through the whole forward model loses most of its digits below."""
    if not torch.is_tensor(theta_map):
        theta_map = torch.as_tensor(np.asarray(theta_map, dtype=np.float64))
    if theta_map.dtype != torch.float64:
        warnings.warn("laplace_approximation on a non-float64 vector: "
                      "the Hessian of the full forward model loses most "
                      "of its digits below f64", stacklevel=2)
    D = theta_map.shape[0]
    with torch.no_grad():
        lp_map = float(log_post(theta_map))
    if not np.isfinite(lp_map):
        raise ValueError("log_post(theta_map) is not finite — the mode "
                         "must lie inside the prior support")
    H = torch.autograd.functional.hessian(log_post, theta_map)
    H = H.detach().cpu().numpy().astype(float)
    H = 0.5 * (H + H.T)                       # symmetrize roundoff
    eigvals = np.linalg.eigvalsh(-H)          # ascending
    ok = bool(np.all(np.isfinite(eigvals)) and eigvals[0] > 0.0)

    if ok:
        cov = np.linalg.inv(-H)
        cov = 0.5 * (cov + cov.T)
        sd = np.sqrt(np.diag(cov))
        log_z = lp_map + 0.5 * D * np.log(2 * np.pi) \
            - 0.5 * float(np.sum(np.log(eigvals)))
    else:
        cov = np.full((D, D), np.nan)
        sd = np.full((D,), np.nan)
        log_z = float("nan")

    tm = theta_map.detach().cpu().numpy().astype(float)
    at_boundary = np.zeros((D,), dtype=bool)
    if lo is not None and hi is not None:
        lo = np.asarray(lo, float)
        hi = np.asarray(hi, float)
        span = np.where(np.isfinite(hi - lo), hi - lo,
                        np.maximum(np.abs(tm), 1.0))
        tol = boundary_rtol * span
        at_boundary = ((np.isfinite(lo) & (tm - lo < tol))
                       | (np.isfinite(hi) & (hi - tm < tol)))

    # conditional error bars on the interior block: a pinned mode makes
    # the full -H indefinite, while the curvature restricted to the free
    # directions (the pinned values held) is typically proper
    sd_cond = np.full((D,), np.nan)
    interior = ~at_boundary
    if ok:
        sd_cond = sd.copy()
    elif interior.any():
        Hi = -H[np.ix_(interior, interior)]
        ev = np.linalg.eigvalsh(Hi)
        if np.all(np.isfinite(ev)) and ev[0] > 0.0:
            sd_cond[interior] = np.sqrt(np.diag(np.linalg.inv(Hi)))

    return LaplaceResult(
        theta_map=tm, log_post_map=lp_map, hessian=H, eigenvalues=eigvals,
        cov=cov, sd=sd, log_z=log_z, ok=ok, at_boundary=at_boundary,
        sd_conditional=sd_cond)


def laplace_fit(model, theta0, lo, hi, *, device=None, verbose: bool = False,
                **mle_kwargs) -> LaplaceResult:
    """MAP search (``sampling/mle.py::find_mle``) and the Laplace
    approximation at the found mode.

    ``model``: a ``JointModel`` (the Hessian on its float64 copy on
    ``device``, default the model's device) or a batched log-probability
    (N, D) -> (N,) on ``device`` (the Hessian in the dtype of ``theta0``
    there).  The MAP is polished: the sampler warm start's stall rule
    (``restart_tol`` 0.3) leaves the mode rough enough to flip interior
    directions non-PD, so ``restart_tol`` defaults to 1e-4 here."""
    mle_kwargs.setdefault("restart_tol", 1e-4)
    is_model = hasattr(model, "log_like_batch")
    if device is None:
        device = model.sz_data.L.device if is_model else "cpu"
    device = torch.device(device)
    theta_map, _ = find_mle(model, np.asarray(theta0, float),
                            np.asarray(lo, float), np.asarray(hi, float),
                            device=device, verbose=verbose, **mle_kwargs)
    if is_model:
        log_post = model.to(device, torch.float64).log_like
        dtype = torch.float64
    else:
        def log_post(t):
            return model(t[None])[0]
        dtype = torch.as_tensor(np.asarray(theta0)).dtype
    theta = torch.as_tensor(np.asarray(theta_map), dtype=dtype, device=device)
    return laplace_approximation(log_post, theta, lo=lo, hi=hi)


def model_laplace(model, theta0=None, n_prior_samples: int = 200_000,
                  seed: int = 0, verbose: bool = False, device=None,
                  **mle_kwargs) -> LaplaceResult:
    """Laplace approximation of a JointModel's posterior on ``device``
    (default the model's), with the prior log-normalization estimated by
    MC over ``n_prior_samples`` draws (``sampling/priors.py``), so
    ``log_z_normalized`` compares with ``model_evidence(model).log_z``
    (both against the normalized, veto-restricted prior)."""
    from .priors import model_log_prior, prior_log_norm

    if theta0 is None:
        theta0 = model.params.thawed_values()
    res = laplace_fit(model, theta0, model.params.lo, model.params.hi,
                      device=device, verbose=verbose, **mle_kwargs)
    ln, ln_err = prior_log_norm(model_log_prior(model, device),
                                model.params, n_prior_samples,
                                np.random.default_rng(seed))
    res.prior_log_norm = ln
    res.prior_log_norm_err = ln_err
    res.log_z_normalized = res.log_z - ln
    return res
