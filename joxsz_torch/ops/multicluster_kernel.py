"""Kernel 4: the cluster-grid stretch steps.

Replaces ``joxsz_tpu/ops/pallas_joint.py::make_multicluster_step_kernel``
(constants: ``make_multicluster_consts`` -> ``joint_kernel.
pack_consts_stack``).  One launch advances every cluster's W-walker
ensemble by ``n_inner`` full steps against that cluster's own constants
(operators, flux, counts, tables), as the TPU kernel does per call: it is
``csrc/stretch_step.cu::stretch_steps_kernel`` with the cluster axis
switched on — the moving half's tiles of all clusters spread over the
persistent grid, a block stages its cluster's operands from ``buf +
cluster * stride`` and evaluates the joint log-posterior through the
device function kernels 1 and 6 use; beta = 1, partner = ``min(int(u1
H), H - 1)`` in the *same cluster's* fixed half, ``_stretch_z``,
``_gw_accept``, acceptance counted in float32, no swap sweep.  The kernel
writes every cluster's thinned frames itself.

Every model family runs here: a stack of knot-pressure, Vikhlinin-T,
double-density, line_scale or SZ-only clusters takes the kernel's family
instance (``stretch_steps_fam_kernel`` / ``_fam_large_``, picked from the
packed ints as for kernels 1 and 6), each cluster's constants (its knot
tables too) at ``buf + cluster * stride`` over the family's longer
layout; ``launches_by_family`` counts the launches per
``consts_layout.family_key``.

Like the TPU kernel it keeps the unpacked state layout and the one-hot
partner law only, which is meant for survey-scale ensembles (W up to
~4096 per cluster); the hashed-roll partner law of the single-cluster
TPU kernels above that size is not ported.

Random bits: Philox-4x32-10 keyed on (seed, 0) with counter (i, step,
half, cluster): clusters never share bits and a cluster's stream does not
depend on how many clusters there are (the TPU seeds its hardware PRNG
with ``prng_seed(seed, cluster)``).

What bounds it on the card: the likelihood of C*W/2 rows per half-step,
as the step kernel at K = C rungs.  State: x (C, W, D), lp/acc (C, W),
contiguous float32.

``half_step_multicluster_plain`` is the plain torch half-step and
``steps_multicluster_plain`` the plain version of a launch;
``multicluster_ll`` evaluates (C, B, D) -> (C, B) through kernel 1, one
launch per cluster on that cluster's constants (init and lp0).
"""

from __future__ import annotations

import torch

from .consts_layout import family_key
from .joint_kernel import JointConstsStack, joint_ll, joint_ll_plain
from .step_kernel import (check_schedule, check_state_tensors, frames_out,
                          half_step_plain, launch_steps, philox_stream)


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


def steps_multicluster_plain(x, lp, acc, n_steps: int, bits_fn,
                             stack: JointConstsStack, lp_fn=None,
                             thin: int = 0, step0: int = 0):
    """Plain version of one launch of kernel 4: steps ``step0 .. step0 +
    n_steps - 1`` from state x (C, W, D), lp/acc (C, W), the bits of a
    half-step from ``bits_fn(step, which)`` (C, H, >=3).  With ``thin`` >
    0 every cluster is kept after every ``thin``-th step.  Returns ``(x,
    lp, acc, chain (C, n_steps // thin, W, D), chain_lp (C, n_steps //
    thin, W))`` as new tensors."""
    C, W, D = x.shape
    n_keep = n_steps // thin if thin else 0
    chain = x.new_empty((C, n_keep, W, D))
    chain_lp = lp.new_empty((C, n_keep, W))
    for n in range(1, n_steps + 1):
        for which in (0, 1):
            x, lp, acc, _, _ = half_step_multicluster_plain(
                x, lp, acc, which, bits_fn(step0 + n - 1, which), stack,
                lp_fn)
        if thin and n % thin == 0:
            chain[:, n // thin - 1] = x
            chain_lp[:, n // thin - 1] = lp
    return x, lp, acc, chain, chain_lp


def stretch_steps_multicluster(x, lp, acc, seed: int, n_steps: int,
                               stack: JointConstsStack, thin: int = 0,
                               step0: int = 0, out=None):
    """Advance every cluster's ensemble x (C, W, D), lp/acc (C, W) in
    place by steps ``step0 .. step0 + n_steps - 1`` of the chunk seeded by
    ``seed``, cluster c against ``stack.clusters[c]`` (one launch of
    kernel 4 for CUDA tensors, its plain version for CPU tensors).
    Returns every cluster's frames after every ``thin``-th step ``(chain
    (C, n_steps // thin, W, D), chain_lp (C, n_steps // thin, W))``
    (empty for thin 0), written into ``out`` when given."""
    C, W, D = x.shape
    if C != stack.n_clusters or D != stack.ints["D"] or \
            lp.shape != (C, W) or acc.shape != (C, W):
        raise ValueError(
            f"state must be ({stack.n_clusters}, even W, "
            f"{stack.ints['D']}), got {tuple(x.shape)}")
    check_schedule(W, n_steps, thin, step0)
    check_state_tensors((x, lp, acc), stack.device)
    n_keep = n_steps // thin if thin else 0
    chain, chain_lp = frames_out(out, (C, n_keep, W, D), (C, n_keep, W),
                                 x.device)
    if x.device.type == "cpu":
        got = steps_multicluster_plain(
            x, lp, acc, n_steps,
            lambda step, which: multicluster_bits(seed, "cpu", step, which,
                                                  C, W // 2),
            stack, thin=thin, step0=step0)
        for t, v in zip((x, lp, acc, chain, chain_lp), got):
            t.copy_(v)
        return chain, chain_lp
    if n_steps == 0:
        return chain, chain_lp
    launch_steps(x, lp, acc, None, None, None, seed, step0, n_steps, thin,
                 chain, chain_lp, 1, stack.stride, stack.buf, stack.params,
                 "stretch_steps_multicluster")
    stretch_steps_multicluster.launches += 1
    by = stretch_steps_multicluster.launches_by_family
    key = family_key(stack.ints)
    by[key] = by.get(key, 0) + 1
    return chain, chain_lp


# launches, and launches per model family (consts_layout.family_key)
stretch_steps_multicluster.launches = 0
stretch_steps_multicluster.launches_by_family = {}
