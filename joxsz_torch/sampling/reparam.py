"""Nonlinear sampling-space reparametrization (opt-in).

Torch counterpart of ``joxsz_tpu/sampling/reparam.py``.  The stretch
move is affine-invariant, so linear correlations cost nothing, but the
CL J1226 joint posterior's worst-mixing direction is the curved (a, b,
r_p) gNFW shape degeneracy, which no affine move straightens.  Sampling
in u_i = log(theta_i) for the strictly positive shape parameters bends
those power-law ridges toward straight lines.

The transform targets the same posterior: the wrapped log-density is

    lp_u(u) = lp_theta(exp(u)) + sum_{i in mask} u_i

(the log-Jacobian of theta = exp(u)), and chains map back to theta
before analysis.  No reference analog (emcee samples the raw vector);
off by default.  The step kernels take theta-space likelihoods, so a
reparametrized density runs through the plain samplers.
"""

from __future__ import annotations

import numpy as np
import torch

# the gNFW shape parameters spanning the curved degeneracy (lower bounds
# >= 0, posteriors away from 0)
DEFAULT_LOG_PARAMS = ("P_0", "a", "b", "r_p")


class LogReparam:
    """Elementwise exp/log bijection on a subset of parameters.

    ``names``: parameter names to log-transform; names absent from the
    thawed set are ignored (an SZ-only fit that froze some).  A
    transformed parameter must have a non-negative lower bound (the box
    prior inside the likelihood still enforces the exact bounds).  The
    maps take tensors on any device (or numpy arrays, as float64 CPU
    tensors)."""

    def __init__(self, params, names=DEFAULT_LOG_PARAMS):
        thawed = list(params.thawed)
        mask = np.zeros(len(thawed), dtype=bool)
        for i, n in enumerate(thawed):
            if n in names:
                if params.lo[i] < 0:
                    raise ValueError(
                        f"cannot log-transform {n!r}: lower bound "
                        f"{params.lo[i]} < 0")
                mask[i] = True
        if not mask.any():
            raise ValueError(f"none of {names} are thawed")
        self.names = tuple(n for n in thawed if n in names)
        self._mask = mask

    def _m(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._mask, device=x.device)

    def fwd(self, theta):
        """theta-space -> sampling space (log on masked coordinates); a
        masked coordinate at exactly 0 maps to -inf (callers start from
        interior points)."""
        theta = torch.as_tensor(theta)
        m = self._m(theta)
        return torch.where(m, torch.log(torch.where(
            m, theta, torch.ones_like(theta))), theta)

    def inv(self, u):
        u = torch.as_tensor(u)
        m = self._m(u)
        return torch.where(m, torch.exp(torch.where(
            m, u, torch.zeros_like(u))), u)

    def log_jacobian(self, u):
        """log |d theta / d u| = sum of the masked u (theta = exp(u))."""
        u = torch.as_tensor(u)
        return torch.sum(torch.where(self._m(u), u, torch.zeros_like(u)),
                         dim=-1)

    def wrap_log_prob_batch(self, log_prob_batch):
        """Batched theta-space log-prob -> batched u-space log-prob
        targeting the same theta-posterior (Jacobian-corrected)."""

        def lp_u(U):
            return log_prob_batch(self.inv(U)) + self.log_jacobian(U)

        return lp_u

    def chain_to_theta(self, chain) -> np.ndarray:
        """A (n_saved, W, D) u-space chain (numpy, as samplers return
        it) back to theta-space, in numpy on the host."""
        chain = np.asarray(chain)
        mask = self._mask
        return np.where(mask, np.exp(np.where(mask, chain, 0.0)), chain)
