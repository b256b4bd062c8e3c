"""Kernel 6: the coupled half-step, one shard's block of ONE ensemble.

Replaces ``joxsz_tpu/ops/pallas_joint.py::make_coupled_half_kernel``: one
half-substep of a single Goodman-Weare ensemble of W = 2 H walkers that
is spread over ``n_shards`` shards.  A shard holds ``H_loc = H /
n_shards`` rows of the moving half and, for the launch, a gathered copy
of the whole fixed half; it draws its rows' bits at the rows' place in
the whole half (``row_off + i``), takes ``z = _stretch_z(u0)``, the
partner ``min(int(u1 H), H - 1)`` in the FULL fixed half, proposes ``y =
x_p + z (x_m - x_p)``, evaluates the joint log-posterior and accepts by
``_gw_accept``.  The sampler that loops it — gather B, move A, gather A,
move B — is ``parallel.kernel_sharded.run_coupled_sharded_ensemble``.

The TPU kernel packs lp and the accept count into lanes of a (rows, Dp)
state, rolls the shard's rows to the top of the full draw and gathers
partners by a one-hot product; those are layout devices of that chip.
Here the state is unpacked as in the other step kernels (x (H_loc, D),
lp (H_loc,), acc (H_loc,), x_fixed (H, D), contiguous float32), the
gather is a row read, and a tile of 16 rows runs the device code of the
step kernel's half-step (``csrc/stretch_step.cu::stretch_half_tile``)
with two row counts: ``H_loc`` guards the moving rows, ``H`` clamps the
partner.

Random bits: Philox-4x32-10 keyed (seed, 0), counter (row_off + i, step,
which, 0) — the counter ``ops.step_kernel.stretch_steps`` uses at K = 1.
The likelihood's reductions do not depend on a walker's slot in its
tile, so a coupled step over any number of shards is bit for bit the
K = 1 step kernel on the whole ensemble with the same seed (the TPU
kernels agree with each other in lp only to float32 ulps).

One-hot partner law only; the hashed-roll law (``partner="roll"``,
``_hash_shift``) is not ported (``ROADMAP.md``, Queue B).

What bounds it on the card: the likelihood of H_loc rows; at the mesh
shapes (H_loc of 16 to 128 rows) a launch is one to eight tiles on 132
SMs and takes the latency of one tile and its staging of the constants.

Source: ``csrc/stretch_step.cu::coupled_half_kernel`` (+ ``joint_ll.cuh``).
"""

from __future__ import annotations

import torch

from .joint_kernel import JointConsts, joint_ll_plain
from .step_kernel import _M, philox_stream
from ..sampling.stretch import STRETCH_ZC, uniforms, stretch_half_update


def coupled_half_plain(x_upd, lp_upd, acc_upd, x_fixed, row_off: int, bits,
                       lp_fn):
    """Plain version of kernel 6: the block ``x_upd`` (H_loc, D), ``lp_upd``
    / ``acc_upd`` (H_loc,) at rows ``row_off ..`` of the moving half
    against the whole fixed half ``x_fixed`` (H, D).  ``bits`` (H, >=3)
    are the draws of the WHOLE half for this (step, which); the block
    keeps its rows.  Returns ``(x, lp, acc, accept (H_loc,), margin)`` as
    new tensors."""
    H_loc, D = x_upd.shape
    u = uniforms(bits[row_off:row_off + H_loc, :3])
    xm, lm, accept, margin = stretch_half_update(
        lp_fn, u, x_upd, lp_upd, x_fixed, D, 1.0)
    return xm, lm, acc_upd + accept.to(acc_upd.dtype), accept, margin


def _check_state(x_upd, lp_upd, acc_upd, x_fixed, row_off: int,
                 c: JointConsts):
    D = c.ints["D"]
    if x_upd.dim() != 2 or x_fixed.dim() != 2 or x_upd.shape[1] != D \
            or x_fixed.shape[1] != D:
        raise ValueError(f"x_upd and x_fixed must be (rows, {D}), got "
                         f"{tuple(x_upd.shape)} and {tuple(x_fixed.shape)}")
    H_loc, H = x_upd.shape[0], x_fixed.shape[0]
    if lp_upd.shape != (H_loc,) or acc_upd.shape != (H_loc,):
        raise ValueError("lp_upd and acc_upd must be (H_loc,)")
    if not (0 <= row_off and row_off + H_loc <= H):
        raise ValueError(f"rows {row_off}..{row_off + H_loc} lie outside "
                         f"the half of {H} rows")
    for t in (x_upd, lp_upd, acc_upd, x_fixed):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("sampler state must be contiguous float32")
        if t.device != c.device:
            raise ValueError(f"state on {t.device}, constants on {c.device}")


def coupled_half(x_upd, lp_upd, acc_upd, x_fixed, which: int, seed: int,
                 step: int, row_off: int, c: JointConsts,
                 partner: str = "onehot"):
    """Advance one shard's block of the moving half ``which`` in place
    (kernel 6 for CUDA tensors, its plain version for CPU tensors)."""
    if partner == "roll":
        raise NotImplementedError(
            "the hashed-roll partner law (partner='roll') is not ported; "
            "see ROADMAP.md, Queue B")
    if partner != "onehot":
        raise ValueError(f"partner must be 'onehot' or 'roll', got "
                         f"{partner!r}")
    _check_state(x_upd, lp_upd, acc_upd, x_fixed, row_off, c)
    H_loc, H = x_upd.shape[0], x_fixed.shape[0]
    if x_upd.device.type == "cpu":
        bits = philox_stream(seed, x_upd.device)(step, which, H, 4)
        xn, lpn, accn, _, _ = coupled_half_plain(
            x_upd, lp_upd, acc_upd, x_fixed, row_off, bits,
            lambda th: joint_ll_plain(th, c))
        x_upd.copy_(xn)
        lp_upd.copy_(lpn)
        acc_upd.copy_(accn)
        return
    from ._build import kernel_library, check_launch

    lib = kernel_library("stretch_step")
    with torch.cuda.device(x_upd.device):
        err = lib.launch_coupled_half(
            x_upd.data_ptr(), lp_upd.data_ptr(), acc_upd.data_ptr(),
            x_fixed.data_ptr(), H_loc, H, row_off, which, seed & _M, step,
            STRETCH_ZC[0], STRETCH_ZC[1], c.buf.data_ptr(), c.params.iv_ptr,
            c.params.fv_ptr,
            torch.cuda.current_stream(x_upd.device).cuda_stream)
    check_launch(err, "coupled_half")
    coupled_half.launches += 1


coupled_half.launches = 0
