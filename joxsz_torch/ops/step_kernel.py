"""The step kernel: n_inner full stretch steps of K rungs in one launch.

Replaces ``joxsz_tpu/ops/pallas_joint.py::make_step_kernel`` (K = 1, the
plain sampler) and ``make_tempered_step_kernel`` (K rungs, with its swap
sweep), which run ``n_inner`` full steps per call: ``stretch_steps`` is
one cooperative launch of ``csrc/stretch_step.cu::stretch_steps_kernel``
that advances the state by a whole chunk of steps — per step half 0,
half 1 (Philox bits, stretch factor, partner, proposal, the joint
log-posterior through the device function kernel 1 uses, beta-scaled
acceptance) and the K-1 swap boundaries in order, with grid barriers
between them — and writes the cold rung's thinned frames itself.  The
cluster grid (``ops.multicluster_kernel``) is the same kernel with the
cluster axis on.

Two partner laws, as the TPU kernels' ``partner`` argument: 'onehot'
draws a uniform row of the fixed half per walker (emcee's law), 'roll'
pairs moving row i with fixed row (i - s) mod H, one hashed shift s =
``sampling.tempered.hash_shift(seed, step, which, H, rung)`` per
half-step and rung (``_hash_shift`` with ``jnp.roll``).  'auto' (the
default) takes roll above ``PARTNER_AUTO_THRESHOLD`` walkers per rung,
as ``make_step_kernel`` and ``make_tempered_step_kernel`` do; the
cluster grid is one-hot at every W, as ``make_multicluster_step_kernel``
is.  Both laws leave the posterior invariant; the kernel takes the law
as a launch argument, and both consume the same Philox words but the
partner word.

What bounds it on the card: the likelihood of K*W/2 rows per half-step
(~84 k FP32 operations a walker, so operations), plus two or three grid
barriers a step; the swap sweep moves 2 rows of D floats per accepted
pair on one block.

The TPU kernels drew from the TPU's hardware PRNG; here every draw is
Philox-4x32-10 keyed on (seed, 0) with counter (row, step, which, group):
``which`` is the half (0, 1) for half-steps and 16 + 2 kk + half for the
swap at boundary kk, ``row`` is k*H + i for half-steps and the cold slot
j for swaps, ``group`` is 0 here (the cluster-grid step of
``ops.multicluster_kernel`` puts the cluster there); the four output
words are the draws (z, partner, accept); the roll law leaves the
partner word unused.
``philox4x32_10`` below is the same generator in torch int64, so the
plain versions and the kernels consume identical bits.

``steps_plain`` is the plain version of a launch (the two half-steps and
the swap sweep of ``tempered_step_plain`` per step, frames kept as the
kernel keeps them) on bits from any source; the wrapper runs it only for
CPU tensors.

Sources: ``csrc/stretch_step.cu`` (+ ``csrc/joint_ll.cuh``).
"""

from __future__ import annotations

import torch

from .joint_kernel import JointConsts, joint_ll_plain
from ..sampling.stretch import (STRETCH_ZC, roll_partners, uniforms,
                                stretch_half_update)
from ..sampling.tempered import hash_shift, rotation_shift, swap_update

_M = 0xFFFFFFFF
# partner="auto" takes the hashed-roll law above this many walkers (per
# rung), as ``pallas_joint.py::_PARTNER_AUTO_THRESHOLD``
PARTNER_AUTO_THRESHOLD = 4096
PARTNERS = ("onehot", "roll")


def resolve_partner(partner: str, n_walkers: int) -> str:
    """The partner law of an ensemble of ``n_walkers`` (per rung):
    'onehot' (a uniform row of the fixed half per walker), 'roll' (the
    fixed half rotated by one hashed shift per half-step), or 'auto':
    roll above ``PARTNER_AUTO_THRESHOLD`` walkers, one-hot up to it."""
    if partner == "auto":
        return "roll" if n_walkers > PARTNER_AUTO_THRESHOLD else "onehot"
    if partner not in PARTNERS:
        raise ValueError(f"partner must be 'onehot', 'roll' or 'auto', "
                         f"got {partner!r}")
    return partner
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64,
    from 16-bit partial products so nothing overflows int64."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    lo_full = p1 + ((p2 & 0xFFFF) << 16)
    return (lo_full >> 32) + (p2 >> 16), lo_full & _M


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 (Salmon et al. 2011) on int64 tensors holding
    uint32 values; returns the four output words."""
    k0 &= _M
    k1 &= _M
    for r in range(10):
        if r > 0:
            k0 = (k0 + PHILOX_W[0]) & _M
            k1 = (k1 + PHILOX_W[1]) & _M
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_stream(seed: int, device):
    """``bits(step, which, n_rows, n_words, group=0)`` -> int64 (n_rows,
    n_words): the Philox bits the kernels draw for rows 0..n_rows-1 at
    counter (row, step, which, group)."""
    def bits(step: int, which: int, n_rows: int, n_words: int,
             group: int = 0):
        row = torch.arange(n_rows, dtype=torch.int64, device=device)
        z = torch.zeros_like(row)
        out = philox4x32_10(row, z + (step & _M), z + (which & _M),
                            z + (group & _M), seed, 0)
        return torch.stack(out[:n_words], dim=1)

    return bits


def half_step_plain(x, lp, acc, beta, which: int, bits, lp_fn,
                    shifts=None):
    """Plain version of one half-step of the step kernel on state x (K,
    W, D), lp/acc (K, W); ``beta`` (K,) float32; ``bits`` (K*H, >=3) for
    this (step, which); ``shifts``: None for the one-hot law, else the K
    rungs' shifts of the hashed-roll law (``roll_shifts``).
    Returns ``(x, lp, acc, accept (K, H), margin (K, H))`` as new tensors."""
    K, W, D = x.shape
    H = W // 2
    u = uniforms(bits[:, :3]).reshape(K, H, 3)
    mv = slice(which * H, (which + 1) * H)
    fx = slice((1 - which) * H, (2 - which) * H)
    partner = (None if shifts is None
               else roll_partners(shifts, H, H, device=x.device))
    xm, lm, accept, margin = stretch_half_update(
        lp_fn, u, x[:, mv], lp[:, mv], x[:, fx], D, beta[:, None],
        partner=partner)
    x, lp, acc = x.clone(), lp.clone(), acc.clone()
    x[:, mv], lp[:, mv] = xm, lm
    acc[:, mv] = acc[:, mv] + accept.to(acc.dtype)
    return x, lp, acc, accept, margin


def roll_shifts(partner: str, seed: int, step: int, which: int, K: int,
                H: int):
    """The K rungs' shifts of the hashed-roll law at (step, which), rung r
    folded in as ``extra`` (pallas_joint.py:2212-2219), or None for the
    one-hot law."""
    if partner == "onehot":
        return None
    return [hash_shift(seed, step, which, H, r) for r in range(K)]


def swap_plain(x, lp, kk: int, seed: int, step: int, bits, db: float):
    """Plain version of the step kernel's swap at boundary ``kk``; ``bits``
    (H, >=1) per half as a (2, H) pair of draws.  Returns ``(x, lp,
    accept (2, H), margin)``."""
    H = x.shape[1] // 2
    shift = rotation_shift(seed, step, kk, H)
    return swap_update(x, lp, kk, shift, uniforms(bits), db)


def tempered_step_plain(x, lp, acc, beta, seed: int, step: int, bits_fn,
                        lp_fn, db, partner: str = "onehot"):
    """One full plain step — two half-steps under the partner law
    ``partner`` ('onehot' or 'roll'), then the swap boundaries in order —
    from ``bits_fn(step, which, n_rows, n_words)``.  Returns ``(x, lp,
    acc, swaps (K-1,) accepted counts)``."""
    K, W, _ = x.shape
    H = W // 2
    for which in (0, 1):
        x, lp, acc, _, _ = half_step_plain(
            x, lp, acc, beta, which, bits_fn(step, which, K * H, 4), lp_fn,
            roll_shifts(partner, seed, step, which, K, H))
    swaps = []
    for kk in range(K - 1):
        u = torch.stack([bits_fn(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                         for hb in (0, 1)])
        x, lp, accept, _ = swap_plain(x, lp, kk, seed, step, u, db[kk])
        swaps.append(int(accept.sum()))
    return x, lp, acc, swaps


def steps_plain(x, lp, acc, beta, db, seed: int, n_steps: int, bits_fn,
                lp_fn, thin: int = 0, step0: int = 0,
                partner: str = "onehot"):
    """Plain version of one launch of the step kernel: steps ``step0 ..
    step0 + n_steps - 1`` of ``tempered_step_plain`` under the partner
    law ``partner`` from state x (K, W, D), lp/acc (K, W), bits from
    ``bits_fn(step, which, n_rows, n_words)``.  With ``thin`` > 0 the
    cold rung is kept after every ``thin``-th step.  Returns ``(x, lp,
    acc, swaps (K-1,) accepted counts, chain (n_steps // thin, W, D),
    chain_lp (n_steps // thin, W))`` as new tensors."""
    K, W, D = x.shape
    n_keep = n_steps // thin if thin else 0
    chain = x.new_empty((n_keep, W, D))
    chain_lp = lp.new_empty((n_keep, W))
    swaps = [0] * (K - 1)
    for n in range(1, n_steps + 1):
        x, lp, acc, sw = tempered_step_plain(
            x, lp, acc, beta, seed, step0 + n - 1, bits_fn, lp_fn, db,
            partner)
        swaps = [a + b for a, b in zip(swaps, sw)]
        if thin and n % thin == 0:
            chain[n // thin - 1] = x[0]
            chain_lp[n // thin - 1] = lp[0]
    return x, lp, acc, swaps, chain, chain_lp


def check_schedule(W: int, n_steps: int, thin: int, step0: int):
    """The arguments every step-kernel launch shares: an even walker
    count, n_steps >= 0 a multiple of thin (thin 0: no frames), step0 >=
    0."""
    if W % 2:
        raise ValueError(f"need an even number of walkers, got {W}")
    if n_steps < 0 or thin < 0 or step0 < 0:
        raise ValueError("n_steps, thin and step0 must be non-negative")
    if thin and n_steps % thin:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of thin "
                         f"({thin})")


def check_state_tensors(tensors, device):
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("sampler state must be contiguous float32")
        if t.device != device:
            raise ValueError(f"state on {t.device}, constants on {device}")


def frames_out(out, shape_x, shape_lp, device):
    """The frame tensors a launch writes: ``out`` = (chain, chain_lp)
    checked against the shapes, or new ones."""
    if out is None:
        return (torch.empty(shape_x, dtype=torch.float32, device=device),
                torch.empty(shape_lp, dtype=torch.float32, device=device))
    chain, chain_lp = out
    if tuple(chain.shape) != tuple(shape_x) or \
            tuple(chain_lp.shape) != tuple(shape_lp):
        raise ValueError(f"frames must be {tuple(shape_x)} and "
                         f"{tuple(shape_lp)}")
    check_state_tensors((chain, chain_lp), device)
    return chain, chain_lp


def launch_steps(x, lp, acc, sacc, beta, db, seed: int, step0: int,
                 n_steps: int, thin: int, chain, chain_lp, per_cluster: int,
                 cstride: int, buf, params, what: str, roll: bool = False):
    """One cooperative launch of ``stretch_steps_kernel`` on CUDA
    tensors (raises when the card refuses it); ``roll`` picks the
    hashed-roll partner law.  ``what`` names the launch in an error."""
    from ._build import kernel_library, launch_checked

    G, W, _ = x.shape
    bar = torch.zeros(1, dtype=torch.int32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = kernel_library("stretch_step")
    with torch.cuda.device(x.device):
        launch_checked(
            "stretch_steps", lib.launch_stretch_steps, x.data_ptr(),
            lp.data_ptr(), acc.data_ptr(), ptr(sacc), ptr(beta), ptr(db), G,
            W, seed & _M, step0, n_steps, thin,
            ptr(chain) if chain.numel() else None,
            ptr(chain_lp) if chain_lp.numel() else None, STRETCH_ZC[0],
            STRETCH_ZC[1], per_cluster, int(roll), cstride, bar.data_ptr(),
            buf.data_ptr(), params.iv_ptr, params.fv_ptr,
            torch.cuda.current_stream(x.device).cuda_stream, what=what)


def step_kernel_config(c, G: int, W: int) -> tuple[int, int, bool, int]:
    """(blocks, dynamic shared memory bytes, constants staged in shared
    memory, floats of global scratch per block (0: the tiles' scratch is
    in shared memory)) of a step-kernel launch on G groups of W walkers on
    the current card."""
    import ctypes

    from ._build import kernel_library, check_launch

    out = (ctypes.c_int * 4)()
    err = kernel_library("stretch_step").stretch_steps_config(
        G, W, c.params.iv_ptr, c.params.fv_ptr, out)
    check_launch(err, "stretch_steps_config")
    return out[0], out[1], bool(out[2]), out[3]


def stretch_steps(x, lp, acc, sacc, beta, db, seed: int, n_steps: int,
                  c: JointConsts, thin: int = 0, step0: int = 0, out=None,
                  partner: str = "auto"):
    """Advance K rungs x (K, W, D), lp/acc (K, W) in place by steps
    ``step0 .. step0 + n_steps - 1`` of the chunk seeded by ``seed``: per
    step two half-steps at inverse temperatures ``beta`` (K,) float32 and
    the K-1 swap boundaries at rung differences ``db`` (K-1,) float32
    (``sampling.kernel.rung_tensors``), both on the state's device,
    adding accepted swaps to ``sacc`` (int32, at least K-1 long).  One
    launch of the step kernel for CUDA tensors, its plain version for CPU
    tensors.  Returns the cold rung's frames after every ``thin``-th step
    ``(chain (n_steps // thin, W, D), chain_lp (n_steps // thin, W))``
    (empty for thin 0), written into ``out`` when given.  ``partner``:
    the partner law (``resolve_partner`` at W walkers per rung)."""
    K, W, D = x.shape
    check_schedule(W, n_steps, thin, step0)
    partner = resolve_partner(partner, W)
    if D != c.ints["D"] or lp.shape != (K, W) or acc.shape != (K, W):
        raise ValueError(f"state must be x (K, W, {c.ints['D']}), lp and "
                         f"acc (K, W); got {tuple(x.shape)}, "
                         f"{tuple(lp.shape)}, {tuple(acc.shape)}")
    check_state_tensors((x, lp, acc, beta, db), c.device)
    if beta.shape != (K,) or db.shape != (K - 1,):
        raise ValueError(f"need {K} betas and {K - 1} rung differences")
    if sacc.dtype != torch.int32 or sacc.device != x.device or \
            sacc.numel() < K - 1:
        raise ValueError("sacc must be int32 with K-1 entries on the "
                         "state's device")
    n_keep = n_steps // thin if thin else 0
    chain, chain_lp = frames_out(out, (n_keep, W, D), (n_keep, W), x.device)
    if x.device.type == "cpu":
        xn, lpn, accn, swaps, ch, ch_lp = steps_plain(
            x, lp, acc, beta, db.tolist(), seed, n_steps,
            philox_stream(seed, "cpu"),
            lambda th: joint_ll_plain(th, c), thin, step0, partner=partner)
        for t, v in ((x, xn), (lp, lpn), (acc, accn), (chain, ch),
                     (chain_lp, ch_lp)):
            t.copy_(v)
        for kk, n in enumerate(swaps):
            sacc[kk] += n
        return chain, chain_lp
    if n_steps == 0:
        return chain, chain_lp
    launch_steps(x, lp, acc, sacc, beta, db if K > 1 else None, seed, step0,
                 n_steps, thin, chain, chain_lp, 0, 0, c.buf, c.params,
                 "stretch_steps", roll=partner == "roll")
    stretch_steps.launches += 1
    if K > 1:
        stretch_steps.launches_tempered += 1
    if partner == "roll":
        stretch_steps.launches_roll[K > 1] += 1
    return chain, chain_lp


# launches of the step kernel on rung state, those of them at K > 1, and
# those under the roll law at K = 1 and at K > 1
stretch_steps.launches = 0
stretch_steps.launches_tempered = 0
stretch_steps.launches_roll = [0, 0]


def f64_pairs(reset: bool = False) -> int:
    """Mass-veto pairs the float64 tier decided in the step kernels (this
    kernel, kernel 4 and kernel 6: ``csrc/stretch_step.cu``'s counter)
    since the last reset; the plain versions count in
    ``joint_kernel.f64_pairs``."""
    from ._build import f64_pairs as card

    return card("stretch_step", reset)


def tier2_pairs() -> int:
    """Mass-veto pairs tier 1 left to tiers 2-3 in the step kernels (one
    count a tile, ``csrc/joint_ll.cuh``), never reset; the plain versions
    count in ``joint_kernel.tier2_pairs``.  Synchronises with the card."""
    from ._build import tier2_pairs as card

    return card("stretch_step")


def pair_counts(device) -> torch.Tensor:
    """The step kernels' (tier-2, float64-tier) pair counts on the card
    ``device`` as a (2,) int64 tensor there, copied in the current
    stream's order: it does not wait for the card (zeros before the
    first launch)."""
    from ._build import snap_pair_counters

    out = torch.empty(2, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        if not snap_pair_counters("stretch_step", out):
            out.zero_()
    return out
