"""Bayesian model evidence via an inverse-temperature ladder.

Torch counterpart of ``joxsz_tpu/sampling/evidence.py``.  With several
model families on the same data (gNFW vs knot pressure, single vs double
density), the quantity that ranks them is the evidence Z = integral of
prior(theta) L(theta).  The ladder samples the melting path p_beta prop.
prior * L^beta, beta in [0, 1]: rung 0 the prior, rung K-1 the
posterior, adjacent rungs exchanging states.  MCMC never needs the
prior's normalization, so both estimators give the evidence against the
normalized (veto-restricted) prior even for an unnormalized
``log_prior_batch``.

Two estimators from one run, both functions of the saved (n_saved, K, W)
log-likelihood array alone (``ladder_estimates``):

* stepping-stone (Xie et al. 2011): log Z = sum_k [logsumexp((beta_{k+1}
  - beta_k) logL^{(k)}) - log n] over the samples of rung k; robust to
  zero-likelihood prior regions.  The headline estimate, with a
  leave-one-walker-out jackknife error;
* thermodynamic integration (Friel & Pettitt 2008): the trapezoid of
  E_beta[log L] over the ladder, -inf when the prior carries mass where
  L = 0.  A cross-check only: with diffuse priors and a sharp likelihood
  its integrand near beta = 0 is astronomically negative.

``power_betas`` (beta_k = (k/(K-1))^p, p ~ 5) crowds the rungs near
beta = 0 where both estimators need them.

The half-updates are ``stretch.stretch_half_update`` with the (prior,
likelihood) pair carried as aux; the swap sweep pairs the walkers of
adjacent rungs by a random permutation (an ``argsort`` of uniforms), not
the rotation of ``tempered.py``.  Everything runs on the device and in
the dtype of ``p0``, with draws from an explicit ``torch.Generator``
there; the likelihood is the plain torch model (as the JAX ladder runs
XLA, not a Pallas kernel).  The stretch scale is the port's a = 2 (the
JAX function's ``a`` argument, which no caller sets, is not kept).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .stretch import stretch_half_update, validate_schedule


@dataclasses.dataclass
class EvidenceResult:
    log_z: float                   # stepping-stone estimate (headline)
    log_z_ti: float                # thermodynamic-integration cross-check
    log_z_err: float               # stepping-stone jackknife error (walkers)
    betas: np.ndarray              # (K,) ascending, 0 .. 1
    mean_log_like: np.ndarray      # (K,) E_beta[log L] (TI integrand)
    ss_terms: np.ndarray           # (K-1,) per-bridge log contributions
    acceptance_fraction: np.ndarray  # (K, W)
    swap_acceptance: np.ndarray    # (K-1,)
    log_like_samples: np.ndarray   # (n_saved, K, W)
    final_state: tuple             # (x, prior, lik) tensors


def power_betas(n_rungs: int, power: float = 5.0) -> np.ndarray:
    """Ascending ladder beta_k = (k/(K-1))**power, 0 .. 1 (Xie et al.
    2011; p = 5 is in their recommended range)."""
    if n_rungs < 2:
        raise ValueError("need at least 2 rungs (prior and posterior)")
    return (np.arange(n_rungs) / (n_rungs - 1.0)) ** power


def _target(pri, lik, beta):
    """log p_beta up to a constant; beta = 0 ignores lik entirely
    (0 * (-inf) would poison the prior rung with NaNs)."""
    return pri + torch.where(beta > 0.0, beta * lik, torch.zeros_like(lik))


def _logmeanexp(v: np.ndarray) -> float:
    """log(mean(exp(v))) with -inf entries contributing zero mass."""
    m = np.max(v)
    if not np.isfinite(m):
        return float(m)                      # all -inf (or an inf blow-up)
    return float(m + np.log(np.mean(np.exp(v - m))))


def ladder_estimates(lik_samples: np.ndarray, betas) -> dict:
    """The estimators of a ladder run from its saved log-likelihoods
    ``lik_samples`` (n_saved, K, W) and ``betas`` (K,): ``log_z``
    (stepping-stone), ``log_z_err`` (leave-one-walker-out jackknife,
    which keeps each walker's autocorrelation intact), ``log_z_ti``,
    ``mean_log_like`` (K,) and ``ss_terms`` (K-1,)."""
    lik_np = np.asarray(lik_samples)
    betas_np = np.asarray(betas, dtype=float)
    K = betas_np.shape[0]
    dbeta = np.diff(betas_np)
    # stepping stone: bridge k uses the samples of rung k (the lower beta)
    samp = lik_np.transpose(1, 0, 2).reshape(K, -1)   # (K, n_saved*W)
    ss_terms = np.array([_logmeanexp(dbeta[k] * samp[k])
                         for k in range(K - 1)])
    jk = np.empty(lik_np.shape[2])
    for w in range(lik_np.shape[2]):
        sub = np.delete(lik_np, w, axis=2).transpose(1, 0, 2).reshape(K, -1)
        jk[w] = sum(_logmeanexp(dbeta[k] * sub[k]) for k in range(K - 1))
    nw = jk.size
    log_z_err = float(np.sqrt((nw - 1) / nw * ((jk - jk.mean()) ** 2).sum()))
    with np.errstate(invalid="ignore"):
        mean_ll = samp.mean(axis=1)                   # -inf/NaN propagate
    log_z_ti = float(np.trapezoid(mean_ll, betas_np)) \
        if np.isfinite(mean_ll).all() else float("-inf")
    return {"log_z": float(ss_terms.sum()), "log_z_err": log_z_err,
            "log_z_ti": log_z_ti, "mean_log_like": mean_ll,
            "ss_terms": ss_terms}


def _swap_sweep(x, pri, lik, betas, gen, sacc):
    """Exchange states between adjacent rungs, in place, low to high:
    walker j of rung k against walker perm_k[j] of rung k+1 (a random
    pairing); the priors cancel in the ratio, only log L enters, and a
    pair vetoed on both sides does not move."""
    K, W = lik.shape
    kw = dict(generator=gen, dtype=lik.dtype, device=lik.device)
    jidx = torch.argsort(torch.rand((K - 1, W), **kw), dim=1)
    log_u = torch.log(torch.rand((K - 1, W), **kw))
    for k in range(K - 1):
        idx = jidx[k]
        lik_a, lik_b = lik[k], lik[k + 1][idx]
        dlik = torch.where(torch.isfinite(lik_b) | torch.isfinite(lik_a),
                           lik_b - lik_a, torch.zeros_like(lik_a))
        logr = (betas[k] - betas[k + 1]) * dlik
        logr = torch.where(torch.isnan(logr),
                           torch.full_like(logr, -float("inf")), logr)
        accept = log_u[k] < logr
        for arr in (x, pri, lik):
            msk = accept[:, None] if arr.ndim == 3 else accept
            lo, hi = arr[k].clone(), arr[k + 1][idx]
            arr[k + 1, idx] = torch.where(msk, lo, hi)
            arr[k] = torch.where(msk, hi, lo)
        sacc[k] += accept.to(sacc.dtype).mean()


def run_evidence_ladder(log_prior_batch, log_like_batch, p0: torch.Tensor,
                        betas, n_steps: int, gen: torch.Generator,
                        n_burn: int = 0, thin: int = 1) -> EvidenceResult:
    """Sample the melting path and estimate log Z.

    ``log_prior_batch`` / ``log_like_batch`` map (N, D) -> (N,): the
    unnormalized log-prior (-inf outside support) and the data
    log-likelihood.  ``p0`` (W, D) replicated to every rung, or (K, W,
    D), in the prior's support; rung 0 only sees the prior, so give it
    ``n_burn`` steps to grow a posterior-concentrated cloud to the
    prior's scale.  ``gen``: a generator on p0's device."""
    betas_np = np.asarray(betas, dtype=float)
    if betas_np.ndim != 1 or betas_np[0] != 0.0 or betas_np[-1] != 1.0 \
            or np.any(np.diff(betas_np) <= 0):
        raise ValueError("betas must ascend strictly from 0.0 to 1.0")
    K = betas_np.shape[0]
    if p0.ndim == 2:
        p0 = p0[None].expand((K,) + tuple(p0.shape))
    if p0.shape[0] != K:
        raise ValueError(f"p0 leading dim {p0.shape[0]} != n_rungs {K}")
    _, W, D = p0.shape
    validate_schedule(n_steps, thin, W)
    if n_burn < 0:
        raise ValueError(f"n_burn ({n_burn}) must be >= 0")
    H = W // 2
    dtype, dev = p0.dtype, p0.device
    beta = torch.as_tensor(betas_np, dtype=dtype, device=dev)

    def parts(flat):                # (K*N, D) rung-major -> two (K, N)
        return (log_prior_batch(flat).reshape(K, -1),
                log_like_batch(flat).reshape(K, -1))

    def lp_fn(flat):                # target + (prior, lik) aux
        pri, lik = parts(flat)
        return (_target(pri, lik, beta[:, None]).reshape(-1),
                (pri.reshape(-1), lik.reshape(-1)))

    def step(x, pri, lik, acc, sacc):
        u = torch.rand((2, K, H, 3), generator=gen, dtype=dtype, device=dev)
        for which in (0, 1):
            m = slice(None, H) if which == 0 else slice(H, None)
            f = slice(H, None) if which == 0 else slice(None, H)
            tgt = _target(pri[:, m], lik[:, m], beta[:, None])
            xm, _, accept, _, (pm, lm) = stretch_half_update(
                lp_fn, u[which], x[:, m], tgt, x[:, f], D, 1.0,
                aux_move=(pri[:, m], lik[:, m]))
            x[:, m], pri[:, m], lik[:, m] = xm, pm, lm
            acc[:, m] += accept.to(dtype)
        _swap_sweep(x, pri, lik, beta, gen, sacc)

    with torch.no_grad():
        x = p0.clone().contiguous()
        pri, lik = parts(x.reshape(-1, D))
        acc = torch.zeros((K, W), dtype=dtype, device=dev)
        sacc = torch.zeros((K - 1,), dtype=dtype, device=dev)
        for _ in range(n_burn):
            step(x, pri, lik, acc, sacc)
        acc.zero_()
        sacc.zero_()
        n_saved = n_steps // thin
        lik_saved = torch.empty((n_saved, K, W), dtype=dtype, device=dev)
        for i in range(n_steps):
            step(x, pri, lik, acc, sacc)
            if (i + 1) % thin == 0:
                lik_saved[(i + 1) // thin - 1] = lik
    lik_np = lik_saved.cpu().numpy()
    est = ladder_estimates(lik_np, betas_np)
    return EvidenceResult(
        log_z=est["log_z"], log_z_ti=est["log_z_ti"],
        log_z_err=est["log_z_err"], betas=betas_np,
        mean_log_like=est["mean_log_like"], ss_terms=est["ss_terms"],
        acceptance_fraction=(acc / float(n_steps)).cpu().numpy(),
        swap_acceptance=(sacc / float(n_steps)).cpu().numpy(),
        log_like_samples=lik_np, final_state=(x, pri, lik))


def model_evidence(model, n_rungs: int = 16, n_walkers: int = 128,
                   n_steps: int = 2000, n_burn: int = 2000,
                   thin: int = 10, seed: int = 0, power: float = 5.0,
                   p0=None) -> EvidenceResult:
    """Evidence of a JointModel on its bound data, on the model's device
    and in its dtype: the ladder on its prior and likelihood factors
    (``log_prior_only`` / ``log_data_like``).  Compare families by the
    log Bayes factor ``result_A.log_z - result_B.log_z`` (each model's
    own normalized prior is the reference measure).  Without ``p0`` the
    walkers start around the parameters' default values
    (``stretch.generate_init_positions`` on seed + 1); the ladder draws
    from seed."""
    from .stretch import generate_init_positions

    sz = model.sz_data
    dev, dtype = sz.L.device, sz.L.dtype
    if p0 is None:
        g_init = torch.Generator(device=dev)
        g_init.manual_seed(seed + 1)
        with torch.no_grad():
            p0 = generate_init_positions(
                model.log_like_batch, model.params.thawed_values(),
                n_walkers, g_init, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return run_evidence_ladder(
        model.log_prior_only, model.log_data_like,
        torch.as_tensor(p0, dtype=dtype, device=dev),
        power_betas(n_rungs, power), n_steps, gen, n_burn=n_burn, thin=thin)
