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

``find_mle_cached`` puts ``find_mle`` behind a self-validating disk cache
(a repeat fit of the same cluster costs one likelihood evaluation);
``find_mle_multistart`` is the batched alternative: a batch of starts
under Adam on the session's device, then a short simplex polish.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
from scipy import optimize


def mle_device(device, prefer_cpu: bool = True) -> torch.device:
    """Where ``find_mle`` evaluates its objective for a model on
    ``device``."""
    return torch.device("cpu") if prefer_cpu else torch.device(device)


def _objective(model, device, prefer_cpu: bool):
    """(device, scalar log-probability of a (D,) vector) the MLE
    evaluates: a model's ``log_like`` on its float64 copy on the CPU with
    ``prefer_cpu``; a batched function as given."""
    if not hasattr(model, "log_like_batch"):
        return torch.device(device), lambda t: model(t[None])[0]
    device = mle_device(device, prefer_cpu)
    L = model.sz_data.L
    if prefer_cpu and (L.device.type != "cpu" or L.dtype != torch.float64):
        model = model.to(device, torch.float64)
    return device, model.log_like


def find_mle(model, theta0: np.ndarray, lo: np.ndarray, hi: np.ndarray,
             *, device, prefer_cpu: bool = True, max_restarts: int = 5,
             xtol: float = 1e-6, ftol: float = 1e-6,
             restart_tol: float = 0.3,
             verbose: bool = False) -> tuple[np.ndarray, float]:
    """Maximise the log-posterior of ``model`` from ``theta0``; returns
    (theta_hat, ll_hat).  ``model``: a ``JointModel`` whose data lie on
    ``device`` (with ``prefer_cpu`` the objective runs on a float64 copy
    of it on the CPU), or any batched log-probability (N, D) -> (N,) on
    ``device``."""
    device, log_like = _objective(model, device, prefer_cpu)

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


def find_mle_cached(model, theta0: np.ndarray, lo: np.ndarray,
                    hi: np.ndarray, cache_path, *, device,
                    verbose: bool = False,
                    **kw) -> tuple[np.ndarray, float, bool]:
    """:func:`find_mle` behind a SELF-VALIDATING disk cache
    (``joxsz_tpu/sampling/mle.py::find_mle_cached``).

    The MLE is a deterministic function of (config, data): the entry holds
    (theta, ll, theta0, lo, hi) and is honoured only when (a) the start
    point and box match and (b) ONE fresh float64 evaluation on the host
    CPU at the cached theta reproduces the cached ll within 0.5 — so a
    changed dataset, table or likelihood invalidates it through the
    physics, not a file-hash scheme.  Written atomically (a ``.tmp`` file
    replaced into place).  Returns ``(theta, ll, was_cached)``."""
    cache_path = pathlib.Path(cache_path)
    if cache_path.exists():
        try:
            d = json.loads(cache_path.read_text())
            same_problem = (
                np.allclose(d["theta0"], np.asarray(theta0, float))
                and np.allclose(d["lo"], np.asarray(lo, float))
                and np.allclose(d["hi"], np.asarray(hi, float)))
            if same_problem:
                theta = np.asarray(d["theta"], float)
                dev, log_like = _objective(model, device, True)
                with torch.no_grad():
                    ll_now = float(log_like(torch.as_tensor(
                        theta, dtype=torch.float64, device=dev)))
                if np.isfinite(ll_now) and abs(ll_now - d["ll"]) < 0.5:
                    if verbose:
                        print(f"  MLE cache hit ({cache_path.name}): "
                              f"log-like {ll_now:.4f}")
                    return theta, ll_now, True
                if verbose:
                    print("  MLE cache stale (log-like moved "
                          f"{ll_now - d['ll']:+.2f}); re-fitting")
        except (ValueError, KeyError, json.JSONDecodeError):
            pass
    theta, ll = find_mle(model, theta0, lo, hi, device=device,
                         verbose=verbose, **kw)
    try:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache_path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "theta": np.asarray(theta, float).tolist(), "ll": float(ll),
            "theta0": np.asarray(theta0, float).tolist(),
            "lo": np.asarray(lo, float).tolist(),
            "hi": np.asarray(hi, float).tolist()}))
        tmp.replace(cache_path)
    except OSError:
        pass
    return theta, ll, False


def adam_starts(batch, theta0: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                *, device, dtype=torch.float64, seed: int = 0,
                n_starts: int = 64, n_steps: int = 800, lr: float = 3e-3,
                spread: float = 0.05):
    """The batched climb of :func:`find_mle_multistart`: ``n_starts``
    points around ``theta0`` (``spread`` in the unconstrained u) under
    ``torch.optim.Adam`` for ``n_steps`` steps on ``device``, each row an
    independent start of the batched log-probability ``batch``; the box
    is a sigmoid map of u.  A vetoed point scores -1e12 with a zero
    gradient (its non-finite gradient entries are zeroed): a start that
    steps into a veto moves on with its momentum, a start that begins in
    one stays put, and neither turns to NaN.
    Returns (best theta (n_starts, D), best -ll (n_starts,)) over all
    steps."""
    kw = dict(dtype=dtype, device=device)
    theta0 = np.asarray(theta0, dtype=float)
    lo_t = torch.as_tensor(np.asarray(lo, float), **kw)
    hi_t = torch.as_tensor(np.asarray(hi, float), **kw)
    finite = torch.isfinite(lo_t) & torch.isfinite(hi_t)
    span = torch.where(finite, hi_t - lo_t, torch.ones_like(hi_t))
    lo_f = torch.where(finite, lo_t, torch.zeros_like(lo_t))
    eps = 1e-6

    def to_theta(u):
        return torch.where(finite, lo_f + span * torch.sigmoid(u), u)

    th0 = torch.as_tensor(theta0, **kw)
    t = torch.clamp((th0 - lo_f) / span, eps, 1 - eps)
    u0 = torch.where(finite, torch.log(t) - torch.log1p(-t), th0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = u0[None] + spread * torch.randn((n_starts, theta0.size),
                                        generator=gen, **kw)
    u.requires_grad_(True)
    opt = torch.optim.Adam([u], lr=lr)

    def objective(uu):
        """(per-start -ll with vetoes at 1e12, its finite mask)."""
        ll = batch(to_theta(uu))
        ok = torch.isfinite(ll)
        return torch.where(ok, -ll, torch.full_like(ll, 1e12)), ok

    with torch.no_grad():
        best_f, _ = objective(u)
    best_u = u.detach().clone()
    for _ in range(n_steps):
        opt.zero_grad()
        f, ok = objective(u)
        f.sum().backward()
        with torch.no_grad():
            g = torch.where(ok[:, None], u.grad, torch.zeros_like(u.grad))
            u.grad = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        opt.step()
        with torch.no_grad():
            f, _ = objective(u)
            better = f < best_f
            best_u = torch.where(better[:, None], u, best_u)
            best_f = torch.where(better, f, best_f)
    with torch.no_grad():
        return to_theta(best_u), best_f


def find_mle_multistart(model, theta0: np.ndarray, lo: np.ndarray,
                        hi: np.ndarray, *, device, seed: int = 0,
                        n_starts: int = 64, n_steps: int = 800,
                        lr: float = 3e-3, spread: float = 0.05,
                        verbose: bool = False) -> tuple[np.ndarray, float]:
    """Batched multi-start gradient MLE
    (``joxsz_tpu/sampling/mle.py::find_mle_multistart``): the Adam climb
    of :func:`adam_starts` on ``device`` (``model``: a ``JointModel``, in
    its own dtype, or a batched log-probability in float64), then the
    simplex of :func:`find_mle` with ``max_restarts=2`` from the best
    point over all starts and steps."""
    device = torch.device(device)
    batch = getattr(model, "log_like_batch", model)
    L = getattr(getattr(model, "sz_data", None), "L", None)
    thetas, fs = adam_starts(
        batch, theta0, lo, hi, device=device,
        dtype=L.dtype if L is not None else torch.float64, seed=seed,
        n_starts=n_starts, n_steps=n_steps, lr=lr, spread=spread)
    i = int(torch.argmin(fs))
    theta_hat = thetas[i].cpu().numpy().astype(float)
    ll_hat = -float(fs[i])
    if verbose:
        print(f"  multistart MLE: ll {ll_hat:.4f} "
              f"(best of {n_starts} starts)")
    # simplex polish (Adam plateaus before the simplex's terminal
    # precision on ill-conditioned directions)
    theta_hat, ll_hat2 = find_mle(model, theta_hat, lo, hi, device=device,
                                  max_restarts=2)
    if verbose and ll_hat2 > ll_hat:
        print(f"  polish: ll {ll_hat2:.4f}")
    return np.asarray(theta_hat), max(ll_hat, ll_hat2)
