"""Maximum-likelihood warm start for the sampler.

Torch counterpart of ``joxsz_tpu/sampling/mle.py::find_mle`` (reference
``fit.doFitting()``, joxsz_main.py:191): Nelder-Mead restarts (robust to
the -inf veto regions) until a restart improves the log-like by less than
``restart_tol``, then an L-BFGS-B polish with ``torch.autograd`` gradients
where the neighbourhood is finite.

The optimiser is a host loop of single evaluations (~17 k of them for
the flagship on the synthetic CL J1226 data), so on the card every call
pays a device round trip.  As the JAX package does (``prefer_cpu=True``,
its default), the objective and its autograd gradient therefore run on a
float64 copy of the model on the host CPU, made once per call of
``find_mle``; the sampler stays on the card.  ``prefer_cpu=False`` keeps
the objective on the session's device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import optimize


def mle_device(device, prefer_cpu: bool = True) -> torch.device:
    """Where ``find_mle`` evaluates its objective for a model on
    ``device``."""
    return torch.device("cpu") if prefer_cpu else torch.device(device)


def find_mle(model, theta0: np.ndarray, lo: np.ndarray, hi: np.ndarray,
             *, device, prefer_cpu: bool = True, max_restarts: int = 5,
             xtol: float = 1e-6, ftol: float = 1e-6,
             restart_tol: float = 0.3,
             verbose: bool = False) -> tuple[np.ndarray, float]:
    """Maximise the log-posterior of ``model`` (a ``JointModel`` whose data
    lie on ``device``) from ``theta0``; returns (theta_hat, ll_hat).  With
    ``prefer_cpu`` the objective runs on a float64 copy of the model on
    the CPU."""
    device = mle_device(device, prefer_cpu)
    L = model.sz_data.L
    if prefer_cpu and (L.device.type != "cpu" or L.dtype != torch.float64):
        model = model.to(device, torch.float64)
    log_like = model.log_like

    def ll(x, grad=False):
        t = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
        if not grad:
            with torch.no_grad():
                return float(log_like(t)), None
        t.requires_grad_(True)
        v = log_like(t)
        if not torch.isfinite(v):
            return float(v.detach()), None
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g.detach().cpu().numpy()

    def neg_ll(x):
        v, _ = ll(x)
        return 1e30 if not np.isfinite(v) else -v

    best_x = np.asarray(theta0, dtype=float)
    best_f = neg_ll(best_x)
    if best_f >= 1e30:
        raise ValueError("starting point has non-finite likelihood")
    for it in range(max_restarts):
        res = optimize.minimize(neg_ll, best_x, method="Nelder-Mead",
                                options={"xatol": xtol, "fatol": ftol,
                                         "maxiter": 4000, "adaptive": True})
        if verbose:
            print(f"  simplex restart {it}: -ll {res.fun:.4f}")
        improved = res.fun < best_f - restart_tol
        if res.fun < best_f:
            best_f, best_x = res.fun, res.x
        if not improved:
            break

    def neg_ll_grad(x):
        v, g = ll(x, grad=True)
        if not np.isfinite(v):
            return 1e30, np.zeros_like(x)
        if g is None or not np.all(np.isfinite(g)):
            return -v, np.zeros_like(x)
        return -v, -g

    eps = 1e-9
    bounds = [(l + eps, h - eps) for l, h in zip(lo, hi)]
    res = optimize.minimize(neg_ll_grad, np.clip(best_x, lo + eps, hi - eps),
                            jac=True, method="L-BFGS-B", bounds=bounds,
                            options={"maxiter": 500, "ftol": 1e-12})
    if res.fun < best_f:
        best_f, best_x = res.fun, res.x
    if verbose:
        print(f"  MLE log-like: {-best_f:.4f}")
    return np.asarray(best_x), -best_f
