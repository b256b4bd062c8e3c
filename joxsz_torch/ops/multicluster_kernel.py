"""Kernel 4: the cluster-grid stretch half-step.

Replaces ``joxsz_tpu/ops/pallas_joint.py::make_multicluster_step_kernel``
(constants: ``make_multicluster_consts`` -> ``joint_kernel.
pack_consts_stack``).  One launch moves one half of every cluster's
W-walker ensemble against that cluster's own constants (operators, flux,
counts, tables): the grid is (walker tile, cluster), a block reads its
cluster's constants at ``buf + cluster * stride`` and evaluates the joint
log-posterior through the device function kernels 1 and 2 use.  It is
``csrc/stretch_step.cu::stretch_half_kernel`` with the cluster axis
switched on: beta = 1, partner = ``min(int(u1 H), H - 1)`` in the *same
cluster's* fixed half, ``_stretch_z``, ``_gw_accept``, acceptance counted
in float32.  The TPU kernel loops ``n_inner`` steps inside one grid step;
a half-step needs the whole other half, so here the host loops launches,
two per step (``sampling.kernel.run_multicluster_steps``).

Like the TPU kernel it keeps the unpacked state layout and the one-hot
partner law only, which is meant for survey-scale ensembles (W up to
~4096 per cluster); the hashed-roll partner law of the single-cluster
TPU kernels above that size is not ported.

Random bits: Philox-4x32-10 keyed on (seed, 0) with counter (i, step,
half, cluster): clusters never share bits and a cluster's stream does not
depend on how many clusters there are (the TPU seeds its hardware PRNG
with ``prng_seed(seed, cluster)``).

What bounds it on the card: the likelihood of C*W/2 rows per launch, as
kernel 2 at K = C rungs.  State: x (C, W, D), lp/acc (C, W), contiguous
float32; the swap kernel never runs on it.

``half_step_multicluster_plain`` is the plain torch version;
``multicluster_ll`` evaluates (C, B, D) -> (C, B) through kernel 1, one
launch per cluster on that cluster's constants (init and lp0).
"""

from __future__ import annotations

import torch

from .joint_kernel import JointConstsStack, joint_ll, joint_ll_plain
from .step_kernel import _M, half_step_plain, philox_stream
from ..sampling.stretch import STRETCH_ZC


def multicluster_ll_plain(theta: torch.Tensor,
                          stack: JointConstsStack) -> torch.Tensor:
    """(C, B, D) -> (C, B) float32 through the plain joint likelihood,
    cluster c on cluster c's constants."""
    return torch.stack([joint_ll_plain(theta[c], cc)
                        for c, cc in enumerate(stack.clusters)])


def multicluster_ll(theta: torch.Tensor,
                    stack: JointConstsStack) -> torch.Tensor:
    """(C, B, D) -> (C, B) float32 through ``joint_ll`` (kernel 1 for
    CUDA tensors), one call per cluster on that cluster's constants."""
    if theta.dim() != 3 or theta.shape[0] != stack.n_clusters:
        raise ValueError(f"theta must be ({stack.n_clusters}, B, D), got "
                         f"{tuple(theta.shape)}")
    return torch.stack([joint_ll(theta[c].contiguous(), cc)
                        for c, cc in enumerate(stack.clusters)])


def multicluster_bits(seed: int, device, step: int, which: int, C: int,
                      H: int) -> torch.Tensor:
    """(C, H, 4) Philox bits of one half-step: cluster c draws at counter
    (i, step, which, c)."""
    bits = philox_stream(seed, device)
    return torch.stack([bits(step, which, H, 4, group=c) for c in range(C)])


def half_step_multicluster_plain(x, lp, acc, which: int, bits,
                                 stack: JointConstsStack, lp_fn=None):
    """Plain version of kernel 4 on state x (C, W, D), lp/acc (C, W);
    ``bits`` (C, H, >=3) for this (step, which).  ``lp_fn`` (C, H, D) ->
    (C, H) defaults to the plain likelihood.  Returns ``(x, lp, acc,
    accept (C, H), margin (C, H))`` as new tensors."""
    C, W, D = x.shape
    H = W // 2
    if lp_fn is None:
        lp_fn = lambda th: multicluster_ll_plain(th, stack)   # noqa: E731
    ones = torch.ones(C, dtype=torch.float32, device=x.device)
    return half_step_plain(
        x, lp, acc, ones, which, bits.reshape(C * H, -1),
        lambda flat: lp_fn(flat.reshape(C, H, D)).reshape(-1))


def _check_state(x, lp, acc, stack: JointConstsStack):
    C, W, D = x.shape
    if C != stack.n_clusters or W % 2 or D != stack.ints["D"]:
        raise ValueError(
            f"state must be ({stack.n_clusters}, even W, "
            f"{stack.ints['D']}), got {tuple(x.shape)}")
    for t in (x, lp, acc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("sampler state must be contiguous float32")
        if t.device != stack.device:
            raise ValueError(f"state on {t.device}, constants on "
                             f"{stack.device}")
    if lp.shape != (C, W) or acc.shape != (C, W):
        raise ValueError("lp and acc must be (C, W)")


def stretch_half_multicluster(x, lp, acc, which: int, seed: int, step: int,
                              stack: JointConstsStack):
    """Advance the moving half ``which`` of every cluster in place
    (kernel 4 for CUDA tensors, its plain version for CPU tensors)."""
    _check_state(x, lp, acc, stack)
    C, W, _ = x.shape
    if x.device.type == "cpu":
        bits = multicluster_bits(seed, x.device, step, which, C, W // 2)
        xn, lpn, accn, _, _ = half_step_multicluster_plain(
            x, lp, acc, which, bits, stack)
        x.copy_(xn)
        lp.copy_(lpn)
        acc.copy_(accn)
        return
    from ._build import kernel_library, check_launch

    lib = kernel_library("stretch_step")
    p = stack.params
    err = lib.launch_stretch_half(
        x.data_ptr(), lp.data_ptr(), acc.data_ptr(), None, C, W, which,
        seed & _M, step, STRETCH_ZC[0], STRETCH_ZC[1], 1, stack.stride,
        stack.buf.data_ptr(), p.iv_ptr, p.fv_ptr,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "stretch_half_multicluster")
    stretch_half_multicluster.launches += 1


stretch_half_multicluster.launches = 0
