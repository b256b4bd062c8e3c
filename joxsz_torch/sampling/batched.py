"""Batched independent stretch-move ensembles: C clusters x W walkers.

Torch counterpart of ``joxsz_tpu/sampling/batched.py``: a (C, W, D)
parameter block advanced by C independent Goodman-Weare ensembles whose
likelihood is one callable (C, W, D) -> (C, W) (``models.multicluster``).
Plain torch on an explicit ``torch.Generator``; it is the sampler of the
survey fit for stacks outside the cluster-grid kernel's specialisation
and the initialiser of both routes.
"""

from __future__ import annotations

import numpy as np
import torch

from .stretch import ensemble_step, validate_schedule


def batched_init(log_prob_batch_cluster, centers, n_walkers: int,
                 gen: torch.Generator, *, device, dtype=torch.float32,
                 spread: float = 0.05, max_tries: int = 64,
                 shrink_every: int = 8) -> torch.Tensor:
    """(C, W, D) finite-likelihood init clouds around per-cluster centers
    (C, D), with the additive floor ``spread * max(|c|, 1e-2)`` of
    ``stretch.generate_init_positions``.  A center can sit close to a
    veto boundary where a fixed-spread cloud almost never lands in
    support, so clusters still unfinished have their spread halved every
    ``shrink_every`` tries."""
    cen = torch.as_tensor(np.asarray(centers, dtype=np.float64),
                          device=device)
    C, D = cen.shape
    scale = spread * torch.clamp(cen.abs(), min=1e-2)
    pos = torch.zeros((C, n_walkers, D), dtype=dtype, device=device)
    ok = torch.zeros((C, n_walkers), dtype=torch.bool, device=device)
    for t in range(max_tries):
        noise = torch.randn((C, n_walkers, D), generator=gen,
                            dtype=torch.float64, device=device)
        cand = (cen[:, None, :] + scale[:, None, :] * noise).to(dtype)
        fine = torch.isfinite(log_prob_batch_cluster(cand))
        take = fine & ~ok
        pos = torch.where(take[..., None], cand, pos)
        ok = ok | fine
        if bool(ok.all()):
            return pos
        if (t + 1) % shrink_every == 0:
            done = ok.all(dim=1)
            scale = torch.where(done[:, None], scale, scale * 0.5)
    missing = torch.nonzero(~ok.all(dim=1))[:, 0].tolist()
    raise RuntimeError(
        f"could not initialise finite walkers for cluster(s) {missing} "
        f"after {max_tries} tries; check the centers / spread")


def run_batched_ensembles(log_prob_batch_cluster, p0: torch.Tensor,
                          n_burn: int, n_steps: int, gen: torch.Generator,
                          thin: int = 1):
    """C independent stretch-move ensembles from p0 (C, W, D): ``n_burn``
    discarded steps (acceptance reset after them), then ``n_steps``
    thinned by ``thin``.  Returns ``(chain (n_saved, C, W, D), lp_chain
    (n_saved, C, W), acceptance (C, W), final positions)``; the first
    three as numpy."""
    C, W, D = p0.shape
    validate_schedule(n_steps, thin, W)
    if n_burn < 0:
        raise ValueError(f"n_burn ({n_burn}) must be >= 0")
    H = W // 2
    dev = p0.device

    def lp_fn(flat):
        # proposals arrive as (C*H, D) rows, cluster-major
        return log_prob_batch_cluster(flat.reshape(C, -1, D)).reshape(-1)

    x = p0.clone()
    lp = log_prob_batch_cluster(x)
    acc = torch.zeros((C, W), dtype=torch.float32, device=dev)
    n_saved = n_steps // thin
    chain = torch.empty((n_saved, C, W, D), dtype=x.dtype, device=dev)
    lp_chain = torch.empty((n_saved, C, W), dtype=lp.dtype, device=dev)
    for i in range(n_burn + n_steps):
        if i == n_burn:
            acc.zero_()
        u = torch.rand((2, C, H, 3), generator=gen, dtype=x.dtype,
                       device=dev)
        x, lp, acc = ensemble_step(lp_fn, x, lp, acc, u)
        k = i - n_burn + 1
        if k > 0 and k % thin == 0:
            chain[k // thin - 1] = x
            lp_chain[k // thin - 1] = lp
    return (chain.cpu().numpy(), lp_chain.cpu().numpy(),
            (acc / float(n_steps)).cpu().numpy(), x)
