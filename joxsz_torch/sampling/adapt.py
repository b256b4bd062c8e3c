"""Shared pieces of the gradient samplers (HMC, NUTS): the -inf-safe
log-probability and gradient, the Nesterov dual-averaging step-size
scheme of Hoffman & Gelman 2014 (§3.2) and its warmup scaffold.

Torch counterpart of ``joxsz_tpu/sampling/adapt.py``.  A log-probability
here is batched, (C, D) -> (C,) (a ``JointModel.log_like_batch``, or any
function of independent rows), and its gradient comes from
``torch.autograd.grad`` of the batch sum.  Everything runs on the device
and in the dtype of the positions; the step size stays a device tensor
through the warmup, so no step waits for the host.
"""

from __future__ import annotations

import contextlib

import torch

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75
# the value a non-finite log-probability takes inside the gradient (the
# JAX package's surrogate): the where() cuts the gradient there
GRAD_SURROGATE = -1e12


def dual_averaging_update(t, a_prob, h_bar, log_eps_bar, mu,
                          target_accept):
    """One dual-averaging update at (1-based) warmup step ``t`` given the
    step's mean acceptance statistic; returns the new (log_eps,
    log_eps_bar, h_bar).  Floats or tensors."""
    h_bar = ((1.0 - 1.0 / (t + T0)) * h_bar
             + (target_accept - a_prob) / (t + T0))
    log_eps = mu - t ** 0.5 / GAMMA * h_bar
    w = t ** (-KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar


def lp_and_grad(log_prob, x: torch.Tensor):
    """(log-prob with every non-finite value -inf, its gradient) of a
    (C, D) batch in one forward and one backward pass.  The gradient is
    that of ``where(finite, lp, -1e12)``, as ``joxsz_tpu``'s ``jax.grad``
    of the same expression: at a vetoed row the backward pass multiplies
    zero cotangents by the model's partials there, which gives 0 or
    NaN."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        v = log_prob(xr)
        fin = torch.isfinite(v)
        s = torch.where(fin, v, torch.full_like(v, GRAD_SURROGATE))
        (g,) = torch.autograd.grad(s.sum(), xr)
    lp = torch.where(fin, v.detach(), torch.full_like(v, -float("inf")))
    return lp, g


def make_safe_lp_grad(log_prob):
    """Batched -inf-safe log-prob and gradient functions, ``(lp_b,
    grad_b)``, each (C, D) -> (C,) / (C, D): the single implementation
    HMC and NUTS share."""

    def lp_b(x):
        with torch.no_grad():
            v = log_prob(x)
        return torch.where(torch.isfinite(v), v,
                           torch.full_like(v, -float("inf")))

    def grad_b(x):
        return lp_and_grad(log_prob, x)[1]

    return lp_b, grad_b


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in full precision while the gradient
    samplers run: TF32 in ``pp @ L^T`` feeds exp and chi^2, the
    reduced-precision trap of the knot family."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dual_averaging_warmup(transition, p0, aux0, mass0, n_warmup, *,
                          init_step_size, target_accept, adapt_mass):
    """Dual-averaging step-size warmup with optional two-window diagonal
    mass adaptation — the shared HMC/NUTS scaffold.

    ``transition(x, aux, eps, mass) -> (x, aux, alpha)`` advances every
    chain one step and returns the acceptance statistic (its mean is
    taken); ``aux`` is what the chains carry beside their positions
    (HMC and NUTS: the log-probability and its gradient), passed through
    untouched.  With ``adapt_mass`` and ``n_warmup >= 100`` the mass is
    re-estimated after the first half from the cross-chain position
    variance and the step size re-adapted in the second window.  Returns
    ``(x, aux, eps, mass)`` with ``eps`` a 0-d tensor."""
    dtype, dev = p0.dtype, p0.device
    log_init = torch.log(torch.tensor(float(init_step_size), dtype=dtype,
                                      device=dev))
    mu = torch.log(torch.tensor(10.0 * init_step_size, dtype=dtype,
                                device=dev))

    def warmup(x, aux, mass, n):
        log_eps = log_eps_bar = log_init
        h_bar = torch.zeros((), dtype=dtype, device=dev)
        for t in range(1, n + 1):
            x, aux, alpha = transition(x, aux, torch.exp(log_eps), mass)
            log_eps, log_eps_bar, h_bar = dual_averaging_update(
                float(t), alpha.mean(), h_bar, log_eps_bar, mu,
                target_accept)
        return x, aux, torch.exp(log_eps_bar)

    mass = mass0
    if adapt_mass and n_warmup >= 100:
        n1 = n_warmup // 2
        x, aux, _ = warmup(p0, aux0, mass, n1)
        mass = 1.0 / (torch.var(x, dim=0, unbiased=False) + 1e-12)
        x, aux, eps = warmup(x, aux, mass, n_warmup - n1)
    else:
        x, aux, eps = warmup(p0, aux0, mass, n_warmup)
    return x, aux, eps, mass
