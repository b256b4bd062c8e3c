"""No-U-Turn sampler (NUTS) on the joint posterior, batched over chains.

Torch counterpart of ``joxsz_tpu/sampling/nuts.py``.  HMC
(``sampling/hmc.py``) needs its trajectory length tuned by hand; NUTS
adapts it per transition by doubling the trajectory until the path turns
back on itself (Hoffman & Gelman 2014).  The tree is built iteratively
(the checkpoint-stack scheme of Phan & Pradhan, arXiv:1912.11554), as in
the JAX package:

  * a loop over doublings that stops when every chain is done — one
    host sync per doubling (``done.all()``), the price of stopping early;
  * a loop over the 2^depth leapfrogs of the new subtree;
  * U-turn checks of all balanced subtrees through a (max_depth+1)-slot
    checkpoint stack: leaf j stores into slot popcount(j) when j is even
    and checks slots [popcount(j) - t, popcount(j) - 1] when j is odd
    (t = the trailing one-bits of j);
  * progressive multinomial sampling within a subtree, biased progressive
    sampling across doublings (Betancourt 2017);
  * every chain in the same batched step, finished chains frozen behind
    masks.

Direction: a backward-integrated endpoint's momentum is the forward-time
momentum there, so the global U-turn criterion uses the time-ordered
endpoints with their momenta as produced, while within a subtree the
stream-order displacement carries the direction (dx * s).

``log_prob`` is batched, (C, D) -> (C,); each leaf is one forward and one
backward pass (the gradient at the cursor is carried, and each chain
carries the gradient at its position from one transition to the next).
Everything runs on p0's device and in its dtype, draws from an explicit
``torch.Generator`` there, TF32 off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .adapt import dual_averaging_warmup, lp_and_grad, no_tf32
from .stretch import validate_schedule


@dataclasses.dataclass
class NUTSResult:
    chain: np.ndarray             # (n_saved, n_chains, ndim)
    log_prob: np.ndarray          # (n_saved, n_chains)
    mean_accept_prob: float       # dual-averaging statistic over sampling
    mean_tree_depth: float
    step_size: float
    final_state: tuple            # (x, lp) tensors


_DIVERGENCE = 1000.0              # energy-error threshold


def _popcount(j: int) -> int:
    return bin(j).count("1")


def _nuts_transition(log_prob, x, lp, g0, eps, mass, gen, max_depth: int):
    """One batched NUTS transition: x (C, D), lp (C,) and the gradient g0
    (C, D) at x -> new (x, lp, gradient) plus the mean acceptance
    statistic and the tree depth per chain."""
    C, D = x.shape
    dtype, dev = x.dtype, x.device
    kw = dict(generator=gen, dtype=dtype, device=dev)
    inv_mass = 1.0 / mass
    ninf = torch.full((C,), -float("inf"), dtype=dtype, device=dev)

    def where(m, a, b):
        return torch.where(m[:, None] if a.ndim == 2 else m, a, b)

    def vdot(a, b):
        return torch.sum(a * inv_mass * b, dim=-1)

    p0 = torch.randn((C, D), **kw) * torch.sqrt(mass)
    w0 = lp - 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    xl = xr = xprop = x
    pl = pr = p0
    gl = gr = gprop = g0
    lpprop, wlog = lp, w0
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    sum_alpha = torch.zeros(C, dtype=dtype, device=dev)
    n_alpha = torch.zeros(C, dtype=dtype, device=dev)
    depth_reached = torch.zeros(C, dtype=torch.int32, device=dev)

    for d in range(max_depth):
        if bool(done.all()):
            break
        s = torch.where(torch.rand((C,), **kw) < 0.5, 1.0, -1.0).to(dtype)
        fw = s > 0
        cx, cp, cg = where(fw, xr, xl), where(fw, pr, pl), where(fw, gr, gl)
        sx, slp, sg, wsub = cx, lpprop, cg, ninf
        turning = torch.zeros_like(done)
        diverged = torch.zeros_like(done)
        sub_alpha = torch.zeros_like(sum_alpha)
        sub_n = torch.zeros_like(n_alpha)
        ckpt_x = torch.zeros((max_depth + 1, C, D), dtype=dtype, device=dev)
        ckpt_p = torch.zeros_like(ckpt_x)
        step = (s * eps)[:, None]
        for j in range(1 << d):
            frozen = done | turning | diverged
            np_ = cp + 0.5 * step * cg
            nx = cx + step * inv_mass * np_
            nlp, ng = lp_and_grad(log_prob, nx)
            np_ = np_ + 0.5 * step * ng
            w = nlp - 0.5 * torch.sum(np_ * np_ * inv_mass, dim=-1)
            w = torch.where(torch.isnan(w), ninf, w)
            diverged = diverged | (~frozen & (w0 - w > _DIVERGENCE))

            # progressive multinomial sampling within the subtree
            wnew = torch.logaddexp(wsub, w)
            take = (torch.log(torch.rand((C,), **kw)) < (w - wnew)) \
                & ~frozen & ~diverged
            sx = where(take, nx, sx)
            slp = where(take, nlp, slp)
            sg = where(take, ng, sg)
            wsub = where(frozen | diverged, wsub, wnew)

            # a chain started at lp = -inf has w0 = -inf and w - w0 = NaN,
            # which would poison the cross-chain mean fed to the shared
            # step size
            ratio = w - w0
            alpha = torch.clamp(torch.exp(torch.where(
                torch.isnan(ratio), ninf, ratio)), max=1.0)
            sub_alpha = sub_alpha + torch.where(frozen, 0.0, alpha)
            sub_n = sub_n + torch.where(frozen, 0.0, 1.0)

            # checkpoint-stack U-turn checks
            pc = _popcount(j)
            if j % 2 == 0:
                ckpt_x[pc] = nx
                ckpt_p[pc] = np_
            else:
                t = _popcount(j & ~(j + 1))          # trailing ones
                for k in range(pc - t, pc):
                    # the stream-order displacement carries one direction
                    # factor; momenta stay as produced
                    dxs = (nx - ckpt_x[k]) * s[:, None]
                    turn_k = (vdot(dxs, ckpt_p[k]) < 0) | (vdot(dxs, np_) < 0)
                    turning = turning | (turn_k & ~frozen & ~diverged)

            keep = ~frozen
            cx, cp, cg = where(keep, nx, cx), where(keep, np_, cp), \
                where(keep, ng, cg)

        invalid = turning | diverged
        newly_done = ~done & invalid
        merge = ~done & ~invalid

        # biased progressive sampling across doublings
        take = (torch.log(torch.rand((C,), **kw)) < (wsub - wlog)) & merge
        xprop = where(take, sx, xprop)
        lpprop = where(take, slp, lpprop)
        gprop = where(take, sg, gprop)
        wlog = where(merge, torch.logaddexp(wlog, wsub), wlog)

        # extend the time-ordered trajectory on side s
        fwd = fw & merge
        bwd = ~fw & merge
        xr, pr, gr = where(fwd, cx, xr), where(fwd, cp, pr), where(fwd, cg, gr)
        xl, pl, gl = where(bwd, cx, xl), where(bwd, cp, pl), where(bwd, cg, gl)

        # global U-turn across the whole trajectory
        dx = xr - xl
        gturn = (vdot(dx, pl) < 0) | (vdot(dx, pr) < 0)
        depth_reached = depth_reached + (~done).to(torch.int32)
        done = done | newly_done | (merge & gturn)
        sum_alpha = sum_alpha + sub_alpha
        n_alpha = n_alpha + sub_n

    alpha = sum_alpha / torch.clamp(n_alpha, min=1.0)
    return xprop, lpprop, gprop, alpha, depth_reached


def run_nuts(log_prob, p0: torch.Tensor, n_steps: int, gen: torch.Generator,
             n_warmup: int = 500, max_depth: int = 8,
             target_accept: float = 0.8, init_step_size: float = 0.01,
             mass_diag=None, adapt_mass: bool = True,
             thin: int = 1) -> NUTSResult:
    """Batched NUTS from p0 (C, D) with dual-averaging step-size warmup
    and (optionally) windowed diagonal mass adaptation, as
    ``sampling/hmc.py``."""
    C, D = p0.shape
    dtype, dev = p0.dtype, p0.device
    validate_schedule(n_steps, thin)
    if mass_diag is None:
        mass_diag = 1.0 / (torch.var(p0, dim=0, unbiased=False) + 1e-12)
    mass0 = torch.as_tensor(mass_diag, dtype=dtype, device=dev)

    def transition(x, lp, g, eps, mass):
        return _nuts_transition(log_prob, x, lp, g, eps, mass, gen,
                                max_depth)

    def warm_transition(x, aux, eps, mass):
        x, lp, g, alpha, _ = transition(x, *aux, eps, mass)
        return x, (lp, g), alpha

    with no_tf32():
        x, (lp, g), eps, mass = dual_averaging_warmup(
            warm_transition, p0, lp_and_grad(log_prob, p0), mass0, n_warmup,
            init_step_size=init_step_size, target_accept=target_accept,
            adapt_mass=adapt_mass)
        n_saved = n_steps // thin
        chain = torch.empty((n_saved, C, D), dtype=dtype, device=dev)
        chain_lp = torch.empty((n_saved, C), dtype=dtype, device=dev)
        asum = torch.zeros((), dtype=dtype, device=dev)
        dsum = torch.zeros((), dtype=dtype, device=dev)
        for i in range(n_steps):
            x, lp, g, alpha, depth = transition(x, lp, g, eps, mass)
            asum = asum + alpha.mean()
            dsum = dsum + depth.to(dtype).mean()
            if (i + 1) % thin == 0:
                chain[(i + 1) // thin - 1] = x
                chain_lp[(i + 1) // thin - 1] = lp
    n_trans = max(n_steps, 1)
    return NUTSResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        mean_accept_prob=float(asum) / n_trans,
        mean_tree_depth=float(dsum) / n_trans,
        step_size=float(eps), final_state=(x, lp))
