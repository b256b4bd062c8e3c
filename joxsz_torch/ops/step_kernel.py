"""Kernels 2 and 3: the stretch half-step and the swap sweep.

Kernel 2 replaces the half-step inside ``joxsz_tpu/ops/pallas_joint.py::
make_step_kernel`` (K = 1, the plain sampler) and ``make_tempered_step_
kernel`` (K rungs): one launch moves one half of every rung — Philox bits,
stretch factor, one-hot-law partner, proposal, the joint log-posterior
through the device function kernel 1 uses, beta-scaled acceptance.
Kernel 3 replaces the tempered kernel's swap sweep at one rung boundary.
A half-step needs the whole other half, so the host loops over launches:
two half-steps and K-1 swap boundaries per step (``sampling.kernel``).

What bounds them on the card: kernel 2 is the likelihood of K*W/2 rows
plus a few row reads/writes (the same L2/transcendental bound as kernel 1);
kernel 3 moves 2 rows of D floats per accepted pair — a few hundred KB —
so its time is launch latency.

The TPU kernels drew from the TPU's hardware PRNG; here every draw is
Philox-4x32-10 keyed on (seed, 0) with counter (row, step, which, group):
``which`` is the half (0, 1) for half-steps and 16 + 2 kk + half for the
swap at boundary kk, ``row`` is k*H + i for half-steps and the cold slot
j for swaps, ``group`` is 0 here (the cluster-grid step of
``ops.multicluster_kernel`` puts the cluster there); the four output
words are the draws (z, partner, accept).
``philox4x32_10`` below is the same generator in torch int64, so the
plain versions and the kernels consume identical bits.

Sources: ``csrc/stretch_step.cu`` (+ ``csrc/joint_ll.cuh``).
"""

from __future__ import annotations

import torch

from .joint_kernel import JointConsts, joint_ll_plain
from ..sampling.stretch import STRETCH_ZC, uniforms, stretch_half_update
from ..sampling.tempered import rotation_shift, swap_update

_M = 0xFFFFFFFF
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


def half_step_plain(x, lp, acc, beta, which: int, bits, lp_fn):
    """Plain version of kernel 2 on state x (K, W, D), lp/acc (K, W);
    ``beta`` (K,) float32; ``bits`` (K*H, >=3) for this (step, which).
    Returns ``(x, lp, acc, accept (K, H), margin (K, H))`` as new tensors."""
    K, W, D = x.shape
    H = W // 2
    u = uniforms(bits[:, :3]).reshape(K, H, 3)
    mv = slice(which * H, (which + 1) * H)
    fx = slice((1 - which) * H, (2 - which) * H)
    xm, lm, accept, margin = stretch_half_update(
        lp_fn, u, x[:, mv], lp[:, mv], x[:, fx], D, beta[:, None])
    x, lp, acc = x.clone(), lp.clone(), acc.clone()
    x[:, mv], lp[:, mv] = xm, lm
    acc[:, mv] = acc[:, mv] + accept.to(acc.dtype)
    return x, lp, acc, accept, margin


def swap_plain(x, lp, kk: int, seed: int, step: int, bits, db: float):
    """Plain version of kernel 3 at boundary ``kk``; ``bits`` (H, >=1)
    per half as a (2, H) pair of draws.  Returns
    ``(x, lp, accept (2, H), margin)``."""
    H = x.shape[1] // 2
    shift = rotation_shift(seed, step, kk, H)
    return swap_update(x, lp, kk, shift, uniforms(bits), db)


def tempered_step_plain(x, lp, acc, beta, seed: int, step: int, bits_fn,
                        lp_fn, db):
    """One full plain step — two half-steps, then the swap boundaries in
    order — from ``bits_fn(step, which, n_rows, n_words)``.  Returns
    ``(x, lp, acc, swaps (K-1,) accepted counts)``."""
    K, W, _ = x.shape
    H = W // 2
    for which in (0, 1):
        x, lp, acc, _, _ = half_step_plain(
            x, lp, acc, beta, which, bits_fn(step, which, K * H, 4), lp_fn)
    swaps = []
    for kk in range(K - 1):
        u = torch.stack([bits_fn(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                         for hb in (0, 1)])
        x, lp, accept, _ = swap_plain(x, lp, kk, seed, step, u, db[kk])
        swaps.append(int(accept.sum()))
    return x, lp, acc, swaps


def _check_state(x, lp, acc, c: JointConsts):
    K, W, D = x.shape
    if W % 2 or D != c.ints["D"]:
        raise ValueError(f"state must be (K, even W, {c.ints['D']}), got "
                         f"{tuple(x.shape)}")
    for t in (x, lp, acc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("sampler state must be contiguous float32")
        if t.device != c.device:
            raise ValueError(f"state on {t.device}, constants on {c.device}")
    if lp.shape != (K, W) or acc.shape != (K, W):
        raise ValueError("lp and acc must be (K, W)")


def stretch_half(x, lp, acc, beta, which: int, seed: int, step: int,
                 c: JointConsts):
    """Advance the moving half ``which`` of every rung in place (kernel 2
    for CUDA tensors, its plain version for CPU tensors)."""
    _check_state(x, lp, acc, c)
    K, W, _ = x.shape
    if x.device.type == "cpu":
        bits = philox_stream(seed, x.device)(step, which, K * (W // 2), 4)
        xn, lpn, accn, _, _ = half_step_plain(
            x, lp, acc, beta, which, bits,
            lambda th: joint_ll_plain(th, c))
        x.copy_(xn)
        lp.copy_(lpn)
        acc.copy_(accn)
        return
    from ._build import kernel_library, check_launch

    if beta.dtype != torch.float32 or beta.shape != (K,) or \
            beta.device != x.device:
        raise ValueError("beta must be a float32 (K,) tensor on the "
                         "state's device")
    lib = kernel_library("stretch_step")
    err = lib.launch_stretch_half(
        x.data_ptr(), lp.data_ptr(), acc.data_ptr(), beta.data_ptr(), K, W,
        which, seed & _M, step, STRETCH_ZC[0], STRETCH_ZC[1], 0, 0,
        c.buf.data_ptr(), c.params.iv_ptr, c.params.fv_ptr,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "stretch_half")
    stretch_half.launches += 1


stretch_half.launches = 0


def swap(x, lp, sacc, kk: int, seed: int, step: int, db: float):
    """Swap sweep at boundary ``kk`` in place, adding the accepted count
    to ``sacc[kk]`` (int32, on the state's device): kernel 3 for CUDA
    tensors, its plain version for CPU tensors."""
    K, W, D = x.shape
    H = W // 2
    if not (0 <= kk < K - 1):
        raise ValueError(f"boundary {kk} outside 0..{K - 2}")
    if x.device.type == "cpu":
        bits = philox_stream(seed, x.device)
        u = torch.stack([bits(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                         for hb in (0, 1)])
        xn, lpn, accept, _ = swap_plain(x, lp, kk, seed, step, u, db)
        x.copy_(xn)
        lp.copy_(lpn)
        sacc[kk] += int(accept.sum())
        return
    from ._build import kernel_library, check_launch

    if sacc.dtype != torch.int32 or sacc.device != x.device:
        raise ValueError("sacc must be int32 on the state's device")
    shift = rotation_shift(seed, step, kk, H)
    lib = kernel_library("stretch_step")
    err = lib.launch_swap(
        x.data_ptr(), lp.data_ptr(), sacc.data_ptr(), W, D, kk, seed & _M,
        step, shift, db, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "swap")
    swap.launches += 1


swap.launches = 0

