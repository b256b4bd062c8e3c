"""Hamiltonian Monte Carlo on the joint posterior, batched over chains.

Torch counterpart of ``joxsz_tpu/sampling/hmc.py``.  The joint
likelihood is differentiable end to end (matmuls, lerps, elementwise
physics; the -inf vetoes are flat outside their boundaries), so
gradient-based sampling works on it, which the reference's black-box
scipy pipeline could not do:

  * leapfrog integration with a diagonal mass matrix,
  * vetoed regions handled by rejection (a trajectory entering a -inf
    region has infinite energy error; a NaN log-ratio is a rejection),
  * dual-averaging step-size adaptation (Hoffman & Gelman 2014) toward a
    target acceptance during warmup (``adapt.py``),
  * every chain advancing in the same batched step (chains play the role
    walkers play for the stretch sampler).

``log_prob`` is batched, (C, D) -> (C,) (a ``JointModel.log_like_batch``
on the card under ``run``), not the JAX package's scalar function; its
gradient is ``torch.autograd.grad`` of the batch sum.  The leapfrog
carries the gradient from one step to the next and each chain carries
it from one transition to the next, the accepted end's or its own
(n_leapfrog gradient passes per transition; the JAX package takes
2 n_leapfrog, the same values).  Everything runs on p0's device and in
its dtype, draws from an explicit ``torch.Generator`` there, TF32 off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .adapt import dual_averaging_warmup, lp_and_grad, no_tf32
from .stretch import validate_schedule


@dataclasses.dataclass
class HMCResult:
    chain: np.ndarray             # (n_saved, n_chains, ndim)
    log_prob: np.ndarray          # (n_saved, n_chains)
    acceptance_fraction: np.ndarray
    step_size: float
    final_state: tuple            # (x, lp) tensors


def _leapfrog(log_prob, x, p, g, eps, inv_mass, n_steps):
    """n_steps leapfrog steps from (x, p) with the gradient g at x;
    returns (x', p', lp', g')."""
    lp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * g
        x = x + eps * inv_mass * p
        lp, g = lp_and_grad(log_prob, x)
        p = p + 0.5 * eps * g
    return x, p, lp, g


def run_hmc(log_prob, p0: torch.Tensor, n_steps: int, gen: torch.Generator,
            n_warmup: int = 500, n_leapfrog: int = 16,
            target_accept: float = 0.8, init_step_size: float = 0.01,
            mass_diag=None, adapt_mass: bool = False,
            thin: int = 1) -> HMCResult:
    """Batched HMC with dual-averaging warmup from p0 (C, D).

    ``mass_diag`` is the diagonal of the mass matrix (default: the
    inverse variance of the initial cloud).  With ``adapt_mass`` the
    warmup runs in two windows, the mass re-estimated between them from
    the cross-chain position variance."""
    C, D = p0.shape
    dtype, dev = p0.dtype, p0.device
    validate_schedule(n_steps, thin)
    if mass_diag is None:
        mass_diag = 1.0 / (torch.var(p0, dim=0, unbiased=False) + 1e-12)
    mass0 = torch.as_tensor(mass_diag, dtype=dtype, device=dev)
    kw = dict(generator=gen, dtype=dtype, device=dev)

    def hmc_step(x, lp, g, eps, mass):
        inv_mass = 1.0 / mass
        p = torch.randn(x.shape, **kw) * torch.sqrt(mass)
        x_new, p_new, lp_new, g_new = _leapfrog(log_prob, x, p, g, eps,
                                                inv_mass, n_leapfrog)
        ke0 = 0.5 * torch.sum(p * p * inv_mass, dim=-1)
        ke1 = 0.5 * torch.sum(p_new * p_new * inv_mass, dim=-1)
        log_ratio = (lp_new - ke1) - (lp - ke0)
        log_ratio = torch.where(torch.isnan(log_ratio),
                                torch.full_like(log_ratio, -float("inf")),
                                log_ratio)
        u = torch.log(torch.rand((C,), **kw))
        accept = u < log_ratio
        x = torch.where(accept[:, None], x_new, x)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept[:, None], g_new, g)
        a_prob = torch.clamp(torch.exp(log_ratio), max=1.0)
        return x, lp, g, accept, a_prob

    def warm_transition(x, aux, eps, mass):
        x, lp, g, _, a_prob = hmc_step(x, *aux, eps, mass)
        return x, (lp, g), a_prob

    with no_tf32():
        x, (lp, g), eps, mass = dual_averaging_warmup(
            warm_transition, p0, lp_and_grad(log_prob, p0), mass0, n_warmup,
            init_step_size=init_step_size, target_accept=target_accept,
            adapt_mass=adapt_mass)
        n_saved = n_steps // thin
        chain = torch.empty((n_saved, C, D), dtype=dtype, device=dev)
        chain_lp = torch.empty((n_saved, C), dtype=dtype, device=dev)
        acc = torch.zeros(C, dtype=dtype, device=dev)
        for i in range(n_steps):
            x, lp, g, accepted, _ = hmc_step(x, lp, g, eps, mass)
            acc += accepted.to(dtype)
            if (i + 1) % thin == 0:
                chain[(i + 1) // thin - 1] = x
                chain_lp[(i + 1) // thin - 1] = lp
    return HMCResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / float(n_steps)).cpu().numpy(),
        step_size=float(eps), final_state=(x, lp))
