"""Parallel tempering between stretch-move ensembles, plain torch.

Torch counterpart of ``joxsz_tpu/sampling/tempered.py`` with the swap law
of the fused TPU kernel (``make_tempered_step_kernel``, pallas_joint.py
:2383-2432), which the CUDA swap kernel implements: K replica ensembles
at inverse temperatures beta_k (beta = 1 is the posterior), stretch moves
within each rung with the log-prob difference scaled by beta_k, then a
sweep over adjacent rungs kk, kk+1 that pairs each cold slot j of each
half with hot slot (j - shift) mod H — a hashed rotation that only has to
be state-independent — and accepts

    ln U < (beta_kk - beta_kk+1) (logP(x_hot) - logP(x_cold))

on untempered log-probs, exchanging positions and log-probs.  Accept
counts belong to the walker slot and do not move.
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
