"""Hierarchical population inference over a fitted survey.

Torch counterpart of ``joxsz_tpu/sampling/population.py``.  Given
per-cluster posterior samples from ``survey.fit_survey`` (drawn under the
per-cluster "interim" priors of ``models/params.py``), infer
hyperparameters ``phi = (mu, sigma)`` of a population distribution for
one thawed parameter (e.g. is the gNFW ``P_0`` of these clusters drawn
from a common log-normal? with what intrinsic scatter?).

Method: the two-stage importance-reweighting hyper-likelihood (Hogg,
Myers & Bovy 2010, ApJ 725, 2166 eq. 9-13)

    L(phi) = prod_c  (1/S) sum_s  p(theta_cs | phi) / p0(theta_cs)

where theta_cs are stage-1 posterior samples of cluster c and p0 is the
interim prior they were drawn under.  The priors factorise per parameter,
so the ratio reduces to the modelled coordinate's 1-D marginal.  The
population density is truncated and renormalised to the parameter's box
support.

The (C, S) sample matrix lives on the device (the card unless the caller
asks for the CPU), the hyper-likelihood of a batch of phi is one
logsumexp over it in float64, and phi is sampled by the plain stretch
ensemble of ``sampling/stretch.py`` over the 2-D hyper-posterior.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch


@dataclasses.dataclass
class PopulationModel:
    """Population distribution for one thawed parameter.

    ``family``: 'gaussian' (population normal in theta) or 'lognormal'
    (normal in ln theta, for positive scale parameters like P_0).
    ``support``: the parameter's interim box (lo, hi); the population
    density is truncated and renormalised to it.  ``interim``: None for a
    flat interim prior, or (mu0, sigma0) when the stage-1 prior on this
    parameter was Gaussian (unnormalised -z^2/2, which is all the ratio
    needs)."""

    param: str
    family: str = "gaussian"
    support: tuple[float, float] = (-np.inf, np.inf)
    interim: tuple[float, float] | None = None

    def __post_init__(self):
        if self.family not in ("gaussian", "lognormal"):
            raise ValueError(f"family must be 'gaussian' or 'lognormal', "
                             f"got {self.family!r}")
        if self.family == "lognormal" and self.support[0] < 0:
            raise ValueError("lognormal population needs a positive "
                             f"support, got lo={self.support[0]}")


_LOG_SQRT_2PI = float(0.5 * np.log(2.0 * np.pi))


def _check_positive(samples, model: PopulationModel):
    """A lognormal family with a sample at 0 would give NaN densities
    that poison every phi through the logsumexp: refuse it."""
    if model.family == "lognormal" and float(np.min(samples)) <= 0:
        raise ValueError(
            f"lognormal population for {model.param!r} needs strictly "
            f"positive stage-1 samples (min {float(np.min(samples)):g}); "
            f"posteriors piling at 0 want family='gaussian'")


def _norm_logcdf_diff(lo, hi, mu, sigma):
    """log( Phi((hi-mu)/sig) - Phi((lo-mu)/sig) ), stable in both tails:
    through log_ndtr and log1p, on the survival side when most mass lies
    above the interval."""
    alpha = (lo - mu) / sigma
    beta = (hi - mu) / sigma
    flip = alpha > -beta
    a = torch.where(flip, -beta, alpha)
    b = torch.where(flip, -alpha, beta)
    lcb = torch.special.log_ndtr(b)
    lca = torch.special.log_ndtr(a)
    # a < b always (lo < hi), so the ratio is < 1 and log1p is safe
    return lcb + torch.log1p(-torch.exp(torch.clamp(lca - lcb, max=-1e-7)))


def make_population_log_like(samples, model: PopulationModel,
                             interim_logp=None, device=None,
                             dtype=torch.float64):
    """Hyper-likelihood builder.

    ``samples``: (C, S) stage-1 posterior draws of the modelled parameter
    (same S per cluster).  ``interim_logp``: (C, S) log p0 at each draw,
    up to per-cluster constants; derived from ``model.interim`` when
    None.  Returns ``log_like(phi (W, 2)) -> (W,)`` with ``phi = (mu,
    log sigma)``, on ``device`` (default: the card) in ``dtype``."""
    from ..device import resolve_device

    _check_positive(samples, model)
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(samples, np.float64), dtype=dtype,
                        device=dev)
    C, S = x.shape
    lo, hi = model.support
    if model.family == "lognormal":
        y = torch.log(x)
        jac = -torch.log(x)          # dN(ln x)/dx = N(ln x) / x
        ylo = -math.inf if lo <= 0 else float(np.log(lo))
        yhi = math.inf if not np.isfinite(hi) else float(np.log(hi))
    else:
        y, jac = x, torch.zeros_like(x)
        ylo, yhi = float(lo), float(hi)

    if interim_logp is None:
        if model.interim is None:
            lp0 = torch.zeros_like(x)        # flat box: x-independent
        else:
            m0, s0 = model.interim
            lp0 = -0.5 * ((x - m0) / s0) ** 2
    else:
        lp0 = torch.as_tensor(np.asarray(interim_logp, np.float64),
                              dtype=dtype, device=dev)
        if lp0.shape != x.shape:
            raise ValueError(f"interim_logp shape {tuple(lp0.shape)} != "
                             f"samples shape {tuple(x.shape)}")
    base = jac - lp0
    ylo_t = torch.tensor(ylo, dtype=dtype, device=dev)
    yhi_t = torch.tensor(yhi, dtype=dtype, device=dev)
    log_s = float(np.log(S))

    def log_like(phi: torch.Tensor) -> torch.Tensor:
        phi = torch.as_tensor(phi, dtype=dtype, device=dev)
        phi = phi.reshape(-1, 2)
        mu, lsig = phi[:, 0:1], phi[:, 1:2]               # (W, 1)
        sig = torch.exp(lsig)
        trunc = _norm_logcdf_diff(ylo_t, yhi_t, mu, sig)  # (W, 1)
        z = (y[None] - mu[:, :, None]) / sig[:, :, None]  # (W, C, S)
        lw = (-0.5 * z * z - (lsig + _LOG_SQRT_2PI + trunc)[:, :, None]
              + base[None])
        return torch.logsumexp(lw, dim=2).sum(dim=1) - C * log_s

    return log_like


def weight_n_eff(samples, model: PopulationModel, phi,
                 interim_logp=None) -> np.ndarray:
    """Per-cluster effective sample size of the importance weights at
    hyperparameters ``phi`` — (sum w)^2 / sum w^2, in [1, S].  Small
    values mean the population density barely overlaps that cluster's
    stage-1 posterior."""
    _check_positive(samples, model)
    x = np.asarray(samples, float)
    mu, lsig = float(phi[0]), float(phi[1])
    sig = np.exp(lsig)
    if model.family == "lognormal":
        y, jac = np.log(x), -np.log(x)
    else:
        y, jac = x, 0.0
    lw = -0.5 * ((y - mu) / sig) ** 2 + jac
    if interim_logp is not None:
        lw = lw - np.asarray(interim_logp, float)
    elif model.interim is not None:
        m0, s0 = model.interim
        lw = lw + 0.5 * ((x - m0) / s0) ** 2
    lw = lw - lw.max(axis=1, keepdims=True)
    w = np.exp(lw)
    return (w.sum(axis=1) ** 2) / (w ** 2).sum(axis=1)


@dataclasses.dataclass
class PopulationResult:
    model: PopulationModel
    chain: np.ndarray            # (n_saved, W, 2) of (mu, log sigma)
    log_prob: np.ndarray
    acceptance: np.ndarray
    mu: float                    # posterior medians
    mu_sd: float
    sigma: float
    sigma_sd: float
    n_eff_weights: np.ndarray    # per cluster, at the posterior median
    n_samples: int = 0           # stage-1 draws per cluster (n_eff cap)

    def flat_chain(self) -> np.ndarray:
        return self.chain.reshape(-1, 2)

    def to_dict(self) -> dict:
        return {
            "param": self.model.param,
            "family": self.model.family,
            "mu": self.mu, "mu_sd": self.mu_sd,
            "sigma": self.sigma, "sigma_sd": self.sigma_sd,
            "acceptance": float(self.acceptance.mean()),
            "n_samples": self.n_samples,
            "weight_n_eff_min": float(self.n_eff_weights.min()),
            "weight_n_eff": self.n_eff_weights.tolist(),
        }


def fit_population(samples, model: PopulationModel, *,
                   interim_logp=None, n_walkers: int = 64,
                   n_burn: int = 500, n_steps: int = 1000,
                   thin: int = 5, seed: int = 0,
                   mu_bounds=None, log_sigma_bounds=None,
                   warn_n_eff: float = 10.0, device=None) -> PopulationResult:
    """Sample the population posterior from stage-1 draws, on ``device``
    (default: the card).

    Hyperpriors: flat on mu over ``mu_bounds``, flat on log sigma over
    ``log_sigma_bounds``.  Defaults bracket the data: mu spans the
    per-cluster means +- 5x their spread, sigma spans [spread/100, 10x
    spread] (in ln-theta space for lognormal)."""
    from ..device import resolve_device
    from .stretch import run_ensemble

    x = np.asarray(samples, float)
    if x.ndim != 2:
        raise ValueError(f"samples must be (C, S), got {x.shape}")
    if x.shape[0] < 2:
        raise ValueError(
            "population inference needs >= 2 clusters (with one, the "
            "population mean and intrinsic scatter are degenerate with "
            "the cluster's own posterior)")
    dev = resolve_device(device)
    y = np.log(x) if model.family == "lognormal" else x
    cm = y.mean(axis=1)
    spread = max(float(cm.std()), float(y.std(axis=1).mean()), 1e-6)
    if mu_bounds is None:
        mu_bounds = (float(cm.min() - 5 * spread),
                     float(cm.max() + 5 * spread))
    if log_sigma_bounds is None:
        log_sigma_bounds = (float(np.log(spread / 100.0)),
                            float(np.log(10.0 * spread)))
    lo = torch.tensor([mu_bounds[0], log_sigma_bounds[0]],
                      dtype=torch.float64, device=dev)
    hi = torch.tensor([mu_bounds[1], log_sigma_bounds[1]],
                      dtype=torch.float64, device=dev)

    ll = make_population_log_like(x, model, interim_logp=interim_logp,
                                  device=dev)

    def log_prob(phi: torch.Tensor) -> torch.Tensor:
        inside = ((phi >= lo) & (phi <= hi)).all(dim=1)
        return torch.where(inside, ll(phi),
                           torch.full_like(phi[:, 0], -math.inf))

    rng = np.random.default_rng(seed)
    # widen the mu init beyond the cluster-mean range: equal means would
    # otherwise freeze the coordinate (stretch proposals cannot leave a
    # degenerate subspace)
    p0 = np.column_stack([
        rng.uniform(cm.min() - 0.5 * spread, cm.max() + 0.5 * spread,
                    n_walkers),
        np.log(spread) + 0.2 * rng.standard_normal(n_walkers),
    ])
    p0 = np.clip(p0, lo.cpu().numpy() + 1e-9, hi.cpu().numpy() - 1e-9)
    p0 = torch.tensor(p0, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        if n_burn:
            p0 = run_ensemble(log_prob, p0, n_burn, gen, thin=n_burn,
                              store_chain=False).final_state[0]
        res = run_ensemble(log_prob, p0, n_steps, gen, thin=thin)
    flat = res.chain.reshape(-1, 2)
    med = np.median(flat, axis=0)
    n_eff = weight_n_eff(x, model, med, interim_logp=interim_logp)
    if n_eff.min() < warn_n_eff:
        warnings.warn(
            f"population importance weights are thin for cluster(s) "
            f"{np.nonzero(n_eff < warn_n_eff)[0].tolist()} "
            f"(n_eff min {n_eff.min():.1f} of {x.shape[1]} samples): "
            f"the population density barely overlaps their stage-1 "
            f"posteriors; draw more stage-1 samples or widen the model",
            stacklevel=2)
    sig_flat = np.exp(flat[:, 1])
    return PopulationResult(
        model=model, chain=res.chain, log_prob=res.log_prob,
        acceptance=res.acceptance_fraction,
        mu=float(med[0]), mu_sd=float(flat[:, 0].std()),
        sigma=float(np.median(sig_flat)), sigma_sd=float(sig_flat.std()),
        n_eff_weights=n_eff, n_samples=int(x.shape[1]))


def population_from_survey(result, params, param: str,
                           family: str = "lognormal", *,
                           max_samples: int = 2048,
                           seed: int = 0, **kw) -> PopulationResult:
    """Stage 2 straight from a ``survey.SurveyResult``.

    ``params``: the shared ParamSet (``FitSession.params``), which gives
    the modelled parameter's box support and Gaussian interim prior, if
    any.  Each cluster's flat chain is subsampled to ``max_samples``
    draws; ``kw`` goes to ``fit_population`` (``device=`` among them)."""
    names = list(result.param_names)
    if param not in names:
        raise ValueError(f"{param!r} not in fitted parameters {names}")
    j = names.index(param)
    thawed = list(params.thawed)
    if thawed != names:
        raise ValueError("params.thawed does not match the survey's "
                         f"parameter vector: {thawed} vs {names}")
    support = (float(params.lo[j]), float(params.hi[j]))
    interim = None
    if bool(np.asarray(params.is_gauss)[j]):
        interim = (float(params.mu[j]), float(params.sigma[j]))
    model = PopulationModel(param=param, family=family, support=support,
                            interim=interim)

    C = len(result.cluster_names)
    rng = np.random.default_rng(seed)
    cols = []
    for c in range(C):
        draws = result.flat_chain(c)[:, j]
        if draws.size > max_samples:
            draws = rng.choice(draws, size=max_samples, replace=False)
        cols.append(draws)
    S = min(len(d) for d in cols)
    # equalise counts by a random subsample, never d[:S]: the flat chain
    # is frame-major, so a head slice keeps the most autocorrelated block
    samples = np.stack([
        d if len(d) == S else rng.choice(d, size=S, replace=False)
        for d in cols])
    return fit_population(samples, model, seed=seed, **kw)
