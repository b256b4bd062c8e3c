"""Affine-invariant ensemble sampling (Goodman-Weare 2010), plain torch.

Torch counterpart of ``joxsz_tpu/sampling/stretch.py`` for the pieces the
flagless fit uses (reference emcee stack, joxsz_funcs.py:572-635):

  * the ensemble splits into two fixed halves; each half-step moves one
    half with partners drawn from the complementary half (emcee's
    red-black scheme);
  * z ~ g(z) prop. 1/sqrt(z) on [1/a, a] by inverse CDF of one uniform;
  * acceptance log U < (ndim - 1) log z + beta (logP(Y) - logP(X)).

``stretch_half_update`` is the move law the CUDA half-step kernel
(``ops.step_kernel``) implements, in the kernel's float32 arithmetic; it
takes its uniforms from the caller so both can be fed the same bits.
``de_half_update`` and ``snooker_half_update`` are emcee's differential-
evolution moves (``DEMove``, ``DESnookerMove``), which exist only in the
plain sampler, as in the JAX package.  ``run_ensemble`` is the plain
sampler for any batched log-probability and any of the three moves
(``make_step``), drawing from an explicit ``torch.Generator``.

Uniforms are laid out (..., H, k) — one row of k draws per moving walker
— where the JAX functions take (..., k, H): the same draws transposed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INV24 = 2.0 ** -24


@dataclasses.dataclass
class EnsembleResult:
    chain: np.ndarray                 # (n_saved, n_walkers, ndim)
    log_prob: np.ndarray              # (n_saved, n_walkers)
    acceptance_fraction: np.ndarray   # (n_walkers,)
    final_state: tuple                # (positions, log_probs) tensors
    # raw steps per saved frame when it is not the caller's ``thin``: the
    # hybrid coupled sampler records frames only inside its local windows,
    # so its frames lie thin * sync_every / (sync_every - 1) steps apart
    frame_spacing: float | None = None
    # a mesh that spans processes: the coupled and hybrid samplers return
    # this process's walkers only, and here their global indices (the
    # chain's columns); None where the chain holds every walker
    walker_indices: np.ndarray | None = None


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (held in int64) -> float32 uniforms on [0, 1) from
    the top 24 bits (``pallas_joint.py::_uniforms``)."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * INV24


STRETCH_A = 2.0    # stretch scale a: z on [1/a, a]
# (1/sqrt(a), sqrt(a) - 1/sqrt(a)) rounded to float32: z = (c1 + u c2)^2
# (``pallas_joint.py::_stretch_z``)
STRETCH_ZC = (float(np.float32(1.0 / np.sqrt(STRETCH_A))),
              float(np.float32(np.sqrt(STRETCH_A) - 1.0 / np.sqrt(STRETCH_A))))


def stretch_zc(a: float) -> tuple[float, float]:
    """(1/sqrt(a), sqrt(a) - 1/sqrt(a)) of the scale ``a``; the kernels'
    float32-rounded ``STRETCH_ZC`` at the default a = 2."""
    if a == STRETCH_A:
        return STRETCH_ZC
    return 1.0 / np.sqrt(a), np.sqrt(a) - 1.0 / np.sqrt(a)


def stretch_half_update(lp_fn, u: torch.Tensor, x_move: torch.Tensor,
                        lp_move: torch.Tensor, x_fixed: torch.Tensor,
                        ndim: int, beta: torch.Tensor, aux_move=None,
                        a: float = STRETCH_A, partner=None):
    """Stretch-move update of one half of every rung.

    ``u`` (..., H, >=3) float32 uniforms (z, partner, accept); ``x_move``
    and ``x_fixed`` (..., H, D); ``lp_move`` (..., H) untempered; ``beta``
    broadcastable to (..., H).  ``lp_fn`` maps (N, D) -> (N,).  Returns
    ``(x_new, lp_new, accept, margin)`` with ``margin = log u - threshold``
    (the decision's distance from its threshold).

    ``partner``: None for the one-hot law (a uniform row of the fixed half
    from ``u[..., 1]``), or the fixed-half rows themselves, int64 (..., H)
    (the hashed-roll law, ``roll_partners``; ``u[..., 1]`` goes unused).

    With ``aux_move``, a tuple of (..., H) values carried beside the state
    (the evidence ladder's prior and likelihood), ``lp_fn`` returns
    ``(lp, aux)`` with aux a tuple of (N,) values; the accepted
    proposals' aux is merged in, and ``aux_new`` is returned fifth.
    ``a``: the stretch scale (z on [1/a, a])."""
    H = x_fixed.shape[-2]
    D = x_move.shape[-1]
    zc = stretch_zc(a)
    t = zc[0] + u[..., 0] * zc[1]
    z = t * t
    pidx = (torch.clamp((u[..., 1] * H).to(torch.long), max=H - 1)
            if partner is None else partner)
    xp = torch.gather(x_fixed, -2, pidx[..., None].expand(*pidx.shape, D))
    y = xp + z[..., None] * (x_move - xp)
    lp_y = lp_fn(y.reshape(-1, D))
    if aux_move is not None:
        lp_y, aux_y = lp_y
    lp_y = lp_y.reshape(lp_move.shape)
    thr = (ndim - 1.0) * torch.log(z) + beta * (lp_y - lp_move)
    margin = torch.log(u[..., 2]) - thr
    accept = margin < 0
    x_new = torch.where(accept[..., None], y, x_move)
    lp_new = torch.where(accept, lp_y, lp_move)
    if aux_move is None:
        return x_new, lp_new, accept, margin
    aux_new = tuple(torch.where(accept, n.reshape(o.shape), o)
                    for n, o in zip(aux_y, aux_move))
    return x_new, lp_new, accept, margin, aux_new


def roll_partners(shifts, n_rows: int, H: int, row_off: int = 0,
                  device=None) -> torch.Tensor:
    """Partners of the hashed-roll law: moving row ``row_off + i`` of a
    half pairs with row ``(row_off + i - s) mod H`` of the fixed half (the
    fixed half rotated by ``jnp.roll``), one shift ``s`` per leading
    index.  ``shifts`` (G,) ints -> int64 (G, n_rows)."""
    s = torch.as_tensor(list(shifts), dtype=torch.long, device=device)
    i = torch.arange(row_off, row_off + n_rows, device=device)
    return (i[None, :] - s[:, None]) % H


def _index(u: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform index in [0, n) from a uniform draw (exact up to the
    draw's quantisation)."""
    return torch.clamp((u * n).to(torch.long), max=n - 1)


def _take(x_fixed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., H) of ``x_fixed`` (..., Hf, D) -> (..., H, D)."""
    D = x_fixed.shape[-1]
    return torch.gather(x_fixed, -2, idx[..., None].expand(*idx.shape, D))


def _propose(lp_fn, y: torch.Tensor, lp_move: torch.Tensor) -> torch.Tensor:
    """lp_fn over a (..., H, D) block of proposals -> (..., H)."""
    return lp_fn(y.reshape(-1, y.shape[-1])).reshape(lp_move.shape)


def de_half_update(lp_fn, u: torch.Tensor, g1: torch.Tensor,
                   x_move: torch.Tensor, lp_move: torch.Tensor,
                   x_fixed: torch.Tensor, gamma0: float, sigma: float,
                   beta=None):
    """Differential-evolution update of one half-ensemble (DE-MC, ter
    Braak 2006; emcee's ``DEMove`` with the Nelson et al. 2013 gamma
    jitter), ``joxsz_tpu/sampling/stretch.py::de_half_update``:
    ``y = x + gamma (x_a - x_b)`` with a distinct pair (a, b) from the
    fixed half and ``gamma = gamma0 (1 + sigma N(0,1))`` per walker.  The
    proposal is symmetric: plain Metropolis, ``log U < lp_y - lp_x``.

    ``u`` (..., H, 3) uniforms: pair draw a, pair draw b, accept; ``g1``
    (..., H) standard normals.  ``beta`` scales the log-prob difference.
    Returns ``(x_new, lp_new, accept)``."""
    Hf = x_fixed.shape[-2]
    ia = _index(u[..., 0], Hf)
    # b uniform over the Hf-1 indices != a: draw from [0, Hf-1), skip a
    ib = _index(u[..., 1], Hf - 1)
    ib = ib + (ib >= ia).to(ib.dtype)
    gamma = gamma0 * (1.0 + sigma * g1)
    y = x_move + gamma[..., None] * (_take(x_fixed, ia) - _take(x_fixed, ib))
    lp_y = _propose(lp_fn, y, lp_move)
    dlp = lp_y - lp_move
    if beta is not None:
        dlp = beta * dlp
    accept = torch.log(u[..., 2]) < dlp
    return (torch.where(accept[..., None], y, x_move),
            torch.where(accept, lp_y, lp_move), accept)


def de_gamma0(ndim: int) -> float:
    """ter Braak's optimal-scaling default, emcee's ``gamma0=None``."""
    return 2.38 / float(np.sqrt(2.0 * ndim))


def _distinct3(u: torch.Tensor, Hf: int):
    """Three distinct uniform indices in [0, Hf) from the uniforms
    ``u[..., 0:3]``, by the skip construction (exactly uniform over
    ordered distinct triples)."""
    i0 = _index(u[..., 0], Hf)
    i1 = _index(u[..., 1], Hf - 1)
    i1 = i1 + (i1 >= i0).to(i1.dtype)
    i2 = _index(u[..., 2], Hf - 2)
    lo = torch.minimum(i0, i1)
    hi = torch.maximum(i0, i1)
    i2 = i2 + (i2 >= lo).to(i2.dtype)
    i2 = i2 + (i2 >= hi).to(i2.dtype)
    return i0, i1, i2


def snooker_half_update(lp_fn, u: torch.Tensor, x_move: torch.Tensor,
                        lp_move: torch.Tensor, x_fixed: torch.Tensor,
                        ndim: int, gamma_s: float = 1.7, beta=None):
    """Snooker update of one half-ensemble (ter Braak & Vrugt 2008;
    emcee's ``DESnookerMove``), ``joxsz_tpu/sampling/stretch.py::
    snooker_half_update``: along the line through x and an anchor z of
    the fixed half, step by the difference of two other walkers'
    projections onto it,

        y = x + u (gamma_s (u.z1 - u.z2)),   u = (x - z)/|x - z|,

    accepted with the Jacobian factor |1 + s/|x - z||^(ndim-1).

    ``u`` (..., H, 4) uniforms: three distinct anchor/projection draws
    and the accept draw.  Returns ``(x_new, lp_new, accept)``."""
    Hf = x_fixed.shape[-2]
    iz, i1, i2 = _distinct3(u, Hf)
    z = _take(x_fixed, iz)
    delta = x_move - z
    norm = torch.sqrt(torch.sum(delta * delta, dim=-1))          # (..., H)
    ok = norm > 0.0        # coincident x == z: reject (measure zero)
    safe = torch.where(ok, norm, torch.ones_like(norm))
    u_hat = delta / safe[..., None]
    s = gamma_s * torch.sum(u_hat * (_take(x_fixed, i1)
                                     - _take(x_fixed, i2)), dim=-1)
    y = x_move + u_hat * s[..., None]
    lp_y = _propose(lp_fn, y, lp_move)
    dlp = lp_y - lp_move
    if beta is not None:
        dlp = beta * dlp
    ratio = torch.abs(1.0 + s / safe)
    log_jac = (ndim - 1.0) * torch.log(torch.clamp(ratio, min=1e-30))
    accept = ok & (torch.log(u[..., 3]) < log_jac + dlp)
    return (torch.where(accept[..., None], y, x_move),
            torch.where(accept, lp_y, lp_move), accept)


MOVES = ("stretch", "de", "snooker")


# times generate_init_positions may shrink its spread by 3x
INIT_SHRINKS = 3


def generate_init_positions(log_prob_batch, theta0: np.ndarray,
                            n_walkers: int, gen: torch.Generator, *,
                            device, dtype=torch.float32, spread: float = 0.1,
                            max_tries: int = 64, lo=None,
                            hi=None) -> torch.Tensor:
    """Multiplicative-Gaussian perturbations of a centre point, redrawn
    until every walker has a finite log-probability (reference
    ``_generateInitPars``, joxsz_funcs.py:548-570), with the JAX package's
    additive floor ``spread * max(|theta_i|, 1e-2)`` so a zero coordinate
    still spreads.  Draws come from ``gen`` (a generator on ``device``).

    Where ``max_tries`` draws leave a walker without a finite point (a
    centre on the edge of a prior box or of the mass veto, as the MLE of
    the knot-pressure family is: most of a 10% cloud lies outside), the
    spread shrinks by 3x, up to three times, for the walkers still
    missing, and from the first shrink on a draw outside the prior box
    ``[lo, hi]`` is reflected into it (with several parameters on their
    box edges almost every draw leaves the box, whatever the spread);
    the JAX package raises there.  Burn-in regrows the cloud."""
    th0 = torch.as_tensor(np.asarray(theta0, dtype=np.float64),
                          device=device)
    D = th0.shape[0]
    box = None
    if lo is not None:
        box = [torch.as_tensor(np.asarray(b, np.float64), device=device)
               for b in (lo, hi)]
    pos = torch.zeros((n_walkers, D), dtype=dtype, device=device)
    ok = torch.zeros(n_walkers, dtype=torch.bool, device=device)
    for shrink in range(INIT_SHRINKS + 1):
        scale = spread / 3.0 ** shrink * torch.clamp(th0.abs(), min=1e-2)
        for _ in range(max_tries):
            noise = torch.randn((n_walkers, D), generator=gen,
                                dtype=torch.float64, device=device)
            cand = th0 + scale * noise
            if shrink and box is not None:
                cand = torch.where(cand < box[0], 2 * box[0] - cand, cand)
                cand = torch.where(cand > box[1], 2 * box[1] - cand, cand)
                cand = torch.minimum(torch.maximum(cand, box[0]), box[1])
            cand = cand.to(dtype)
            fine = torch.isfinite(log_prob_batch(cand))
            take = fine & ~ok
            pos = torch.where(take[:, None], cand, pos)
            ok = ok | fine
            if bool(ok.all()):
                return pos
    raise RuntimeError(f"could not find {n_walkers} finite-likelihood "
                       "walkers; check the starting point / priors")


def validate_schedule(n_steps: int, thin: int, n_walkers: int | None = None):
    """Shared schedule check of the plain samplers: an even ensemble, a
    positive step count, and a thin that divides it (emcee v3 semantics;
    a silent round-down would skew the acceptance normalisation)."""
    if n_walkers is not None and n_walkers % 2:
        raise ValueError("need an even number of walkers")
    if n_steps <= 0:
        raise ValueError(f"n_steps ({n_steps}) must be positive")
    if thin <= 0:
        raise ValueError(f"thin ({thin}) must be positive")
    if n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                         f"thin ({thin})")


def ensemble_step(lp_fn, x, lp, acc, u, beta=1.0, a: float = STRETCH_A):
    """One full stretch step — both half-updates — of ensembles with any
    leading batch axes: x (..., W, D), lp/acc (..., W), ``u`` (2, ..., H,
    3) uniforms, ``lp_fn`` (N, D) -> (N,), stretch scale ``a``.  Returns
    new (x, lp, acc)."""
    H = x.shape[-2] // 2
    D = x.shape[-1]
    halves = [x[..., :H, :], x[..., H:, :]]
    lps = [lp[..., :H], lp[..., H:]]
    accs = [acc[..., :H], acc[..., H:]]
    for which in (0, 1):
        halves[which], lps[which], accept, _ = stretch_half_update(
            lp_fn, u[which], halves[which], lps[which], halves[1 - which],
            D, beta, a=a)
        accs[which] = accs[which] + accept.to(acc.dtype)
    return (torch.cat(halves, dim=-2), torch.cat(lps, dim=-1),
            torch.cat(accs, dim=-1))


def make_step(log_prob_batch, ndim: int, move: str = "stretch",
              de_sigma: float = 1.0e-5, de_gamma: float | None = None,
              a: float = STRETCH_A):
    """One full ensemble step, both half-updates, of a (W, D) ensemble:
    ``step(x, lp, acc, gen) -> (x, lp, acc)``.  ``move``: 'stretch'
    (Goodman-Weare, the reference's emcee default), 'de' (``DEMove``) or
    'snooker' (``DESnookerMove``), as ``joxsz_tpu/sampling/stretch.py::
    make_step``; ``a`` is the stretch scale.  Per step one uniform block from ``gen``, (2, H, 3) or
    (2, H, 4) for snooker, and for DE a (2, H) normal block after it."""
    if move not in MOVES:
        raise ValueError(f"unknown move {move!r}: expected 'stretch', "
                         "'de', or 'snooker'")
    g0 = de_gamma0(ndim) if de_gamma is None else float(de_gamma)
    gs = 1.7 if de_gamma is None else float(de_gamma)

    def step(x, lp, acc, gen):
        W = x.shape[0]
        H = W // 2
        # DE needs a distinct pair, snooker a distinct triple, from the
        # fixed half; below that the skip construction would duplicate a
        # partner and bias the proposal
        if move == "de" and H < 2:
            raise ValueError(f"DE move needs >= 4 walkers (got {W}): "
                             "each half must hold a distinct pair")
        if move == "snooker" and H < 3:
            raise ValueError(f"snooker move needs >= 6 walkers (got {W}): "
                             "each half must hold a distinct triple")
        kw = dict(generator=gen, dtype=x.dtype, device=x.device)
        u = torch.rand((2, H, 4 if move == "snooker" else 3), **kw)
        if move == "stretch":
            return ensemble_step(log_prob_batch, x, lp, acc, u, a=a)
        g = torch.randn((2, H), **kw) if move == "de" else None
        halves = [x[:H], x[H:]]
        lps = [lp[:H], lp[H:]]
        accs = [acc[:H], acc[H:]]
        for w in (0, 1):
            if move == "de":
                halves[w], lps[w], accept = de_half_update(
                    log_prob_batch, u[w], g[w], halves[w], lps[w],
                    halves[1 - w], g0, de_sigma)
            else:
                halves[w], lps[w], accept = snooker_half_update(
                    log_prob_batch, u[w], halves[w], lps[w],
                    halves[1 - w], ndim, gs)
            accs[w] = accs[w] + accept.to(acc.dtype)
        return torch.cat(halves), torch.cat(lps), torch.cat(accs)

    return step


def run_ensemble(log_like_batch, p0: torch.Tensor, n_steps: int,
                 gen: torch.Generator, thin: int = 1,
                 store_chain: bool = True, move: str = "stretch",
                 de_gamma: float | None = None,
                 a: float = STRETCH_A) -> EnsembleResult:
    """Plain ensemble from p0 (W, D) on any batched log-probability
    (N, D) -> (N,) with the move ``move`` (``make_step``), saving every
    ``thin``-th state (``joxsz_tpu/sampling/stretch.py::run_ensemble``).
    Runs on p0's device and dtype; ``gen`` is a generator on that
    device."""
    W, D = p0.shape
    validate_schedule(n_steps, thin, W)
    step = make_step(log_like_batch, D, move=move, de_gamma=de_gamma, a=a)
    x = p0.clone()
    lp = log_like_batch(x)
    acc = torch.zeros(W, dtype=torch.float32, device=x.device)
    n_saved = n_steps // thin if store_chain else 0
    chain = torch.empty((n_saved, W, D), dtype=x.dtype, device=x.device)
    chain_lp = torch.empty((n_saved, W), dtype=lp.dtype, device=x.device)
    for i in range(n_steps):
        x, lp, acc = step(x, lp, acc, gen)
        if store_chain and (i + 1) % thin == 0:
            chain[(i + 1) // thin - 1] = x
            chain_lp[(i + 1) // thin - 1] = lp
    return EnsembleResult(
        chain=chain.cpu().numpy(), log_prob=chain_lp.cpu().numpy(),
        acceptance_fraction=(acc / n_steps).cpu().numpy(),
        final_state=(x, lp))
