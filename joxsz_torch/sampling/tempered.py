"""Parallel tempering between stretch-move ensembles, plain torch.

Torch counterpart of ``joxsz_tpu/sampling/tempered.py``: K replica
ensembles at inverse temperatures beta_k (beta = 1 is the posterior),
stretch moves within each rung with the log-prob difference scaled by
beta_k, then a sweep over adjacent rungs kk, kk+1 that pairs cold walkers
with hot ones and accepts

    ln U < (beta_kk - beta_kk+1) (logP(x_hot) - logP(x_cold))

on untempered log-probs, exchanging positions and log-probs.  Accept
counts belong to the walker slot and do not move.  Two pairing laws:

* ``swap_update`` — the fused TPU kernel's (``make_tempered_step_kernel``,
  pallas_joint.py:2383-2432), which the CUDA swap kernel implements: cold
  slot j of each half pairs with hot slot (j - shift) mod H, a hashed
  rotation that only has to be state-independent;
* ``run_tempered_ensemble`` — the plain sampler's (``sampling/tempered.py
  :117-142``): each cold walker pairs with a random permutation of the
  hotter rung, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TemperedResult:
    chain: np.ndarray            # cold-rung chain (n_saved, W, D)
    log_prob: np.ndarray         # cold-rung log probs (n_saved, W)
    acceptance_fraction: np.ndarray   # (K, W) within-rung acceptance
    swap_acceptance: np.ndarray  # (K-1,) between-rung swap acceptance
    final_state: tuple           # (x (K, W, D), lp (K, W)) tensors


def default_betas(n_rungs: int, ratio: float = 0.6) -> np.ndarray:
    """Geometric temperature ladder 1, r, r^2, ... (beta = 1 is cold)."""
    return ratio ** np.arange(n_rungs)


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def rotation_shift(seed: int, step: int, kk: int, H: int) -> int:
    """Swap-pairing shift of boundary ``kk`` at ``step``: the literal
    int32 expression of pallas_joint.py:2386-2388 (wrapping multiply,
    arithmetic ``>> 8``, floor-mod by H)."""
    v = _i32(_i32(_i32(seed) * 1103515245) + _i32(step * 40503)
             + kk * 10007)
    return (v >> 8) % H


def swap_update(x: torch.Tensor, lp: torch.Tensor, kk: int, shift: int,
                u: torch.Tensor, db: float):
    """Swap sweep at boundary ``kk`` on state x (K, W, D), lp (K, W);
    ``u`` (2, H) float32 uniforms, one per (half, cold slot); ``db`` the
    float32 beta difference.  Returns ``(x, lp, accept (2, H), margin)``
    as new tensors."""
    K, W, D = x.shape
    H = W // 2
    x, lp = x.clone(), lp.clone()
    j = torch.arange(H, device=x.device)
    jh = (j - shift) % H
    accepts, margins = [], []
    for hb in range(2):
        cs = hb * H + j
        hs = hb * H + jh
        lc, lh = lp[kk, cs], lp[kk + 1, hs]
        margin = torch.log(u[hb]) - db * (lh - lc)
        acc = margin < 0
        xc, xh = x[kk, cs], x[kk + 1, hs]
        x[kk, cs] = torch.where(acc[:, None], xh, xc)
        x[kk + 1, hs] = torch.where(acc[:, None], xc, xh)
        lp[kk, cs] = torch.where(acc, lh, lc)
        lp[kk + 1, hs] = torch.where(acc, lc, lh)
        accepts.append(acc)
        margins.append(margin)
    return x, lp, torch.stack(accepts), torch.stack(margins)


def run_tempered_ensemble(log_prob_batch, p0: torch.Tensor, betas,
                          n_steps: int, gen: torch.Generator,
                          thin: int = 1) -> TemperedResult:
    """K-rung tempered sampling on any batched log-probability (N, D) ->
    (N,), from p0 (K, W, D) or (W, D) replicated to every rung; plain
    torch on p0's device and dtype, draws from ``gen``.  The cold rung is
    saved every ``thin`` steps.  ``swap_acceptance[kk]`` is the mean over
    steps of the accepted share of the W pairs at boundary kk."""
    from .stretch import ensemble_step, validate_schedule

    betas = np.asarray(betas, dtype=np.float64)
    K = betas.size
    x = p0 if p0.dim() == 3 else p0[None].expand(K, *p0.shape)
    x = x.clone()
    _, W, D = x.shape
    validate_schedule(n_steps, thin, W)
    dev, dtype = x.device, x.dtype
    beta = torch.as_tensor(betas, dtype=dtype, device=dev)
    lp = log_prob_batch(x.reshape(K * W, D)).reshape(K, W)
    acc = torch.zeros((K, W), dtype=torch.float32, device=dev)
    sacc = torch.zeros(max(K - 1, 1), dtype=torch.float64, device=dev)
    n_saved = n_steps // thin
    chain = torch.empty((n_saved, W, D), dtype=dtype, device=dev)
    chain_lp = torch.empty((n_saved, W), dtype=lp.dtype, device=dev)
    for i in range(n_steps):
        u = torch.rand((2, K, W // 2, 3), generator=gen, dtype=dtype,
                       device=dev)
        x, lp, acc = ensemble_step(log_prob_batch, x, lp, acc, u,
                                   beta[:, None])
        if K > 1:
            perm_u = torch.rand((K - 1, W), generator=gen, dtype=dtype,
                                device=dev)
            jidx = torch.argsort(perm_u, dim=1)      # random permutations
            u_sw = torch.rand((K - 1, W), generator=gen, dtype=dtype,
                              device=dev)
        for kk in range(K - 1):
            j = jidx[kk]
            lp_c, lp_h = lp[kk], lp[kk + 1][j]
            x_c, x_h = x[kk], x[kk + 1][j]
            accept = torch.log(u_sw[kk]) < (beta[kk] - beta[kk + 1]) * (
                lp_h - lp_c)
            # swapped-out cold states scatter back into the hot rung
            hot_x = x[kk + 1].clone()
            hot_x[j] = torch.where(accept[:, None], x_c, x_h)
            hot_lp = lp[kk + 1].clone()
            hot_lp[j] = torch.where(accept, lp_c, lp_h)
            x[kk] = torch.where(accept[:, None], x_h, x_c)
            lp[kk] = torch.where(accept, lp_h, lp_c)
            x[kk + 1], lp[kk + 1] = hot_x, hot_lp
            sacc[kk] += accept.to(sacc.dtype).mean()
        if (i + 1) % thin == 0:
            chain[(i + 1) // thin - 1] = x[0]
            chain_lp[(i + 1) // thin - 1] = lp[0]
    return TemperedResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / float(n_steps)).cpu().numpy(),
        swap_acceptance=(sacc[:K - 1] / float(n_steps)).cpu().numpy(),
        final_state=(x, lp))
