"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernels of ``joxsz_torch/csrc`` from source, holds each
against its plain torch version on the card, drives the port's paths on a
synthetic CL J1226-shaped dataset — the flagless fit (``joxsz_torch.run.
main``: MLE, prelim rounds, burn-in and W=1024 x K=4 tempered sampling
with auto-extend, the card's production schedule), the survey fit
(``joxsz_torch.survey.main --mock 4`` at W=1024, 1000 + 1000 steps), the
fused-likelihood fit (``run.main --fused --no-step-kernel``) and the mesh
fit (``run_fit(mesh=...)`` over four shards, ``run --mesh``, ``survey
--mesh``) — and checks their output.  Phases:

  1. card name / power limit, kernel build time;
  2. synthetic dataset from ``--seed``, session on ``cuda``, shapes;
  3. kernel 1 vs plain float32 (and plain float64) on 4096 rows, vetoed
     rows included: identical -inf masks, finite values within
     rtol=2e-4, atol=0.5, and within 0.05 of the plain float32 version;
  4. kernels 2 and 3 vs the plain step, step for step on the same
     Philox bits, for 5 steps at W=1024, K=1 (the plain sampler), 20
     steps at W=1024, K=4 (the tempered one) and 20 steps at W=32, K=1
     and K=4 (one shard's block on the mesh path): accept and swap decisions
     identical to the plain step's on kernel 1's likelihood except where
     |log u - threshold| < 1e-3, and to the fully plain step's except
     where the plain f32 likelihood moves the threshold (by at most
     0.05 beta); where they agree, positions to 1e-5 relative and lp
     within rtol=2e-4, atol=0.5; stored lp equal to a fresh kernel-1
     evaluation;
  5. the main path, with every launch counter set to 0 just before it:
     acceptance in (0.1, 0.6), finite positive swap rates, every kernel
     launched;
  6. timings: CUDA events over back-to-back launches beside each
     kernel's bound, and torch.profiler's device time per launch;
  7. the fused SZ core vs its plain float32 version on 4096 rows drawn as
     phase 3 draws them, with rows whose temperatures leave the
     conversion table and rows holding a NaN: identical NaN masks,
     finite values within rtol=2e-5 of |ll| plus atol=1e-3;
  8. the cluster-grid half-step vs its plain version, step for step on
     the same Philox bits at C=4, W=1024 and at one mesh shard's block
     (C=1 of the stacked constants) for 5 steps (decisions,
     positions, lp as in phase 4; stored lp equal to a fresh kernel-1
     evaluation per cluster), and a negative control: the same
     parameters under two clusters' constants give different
     log-posteriors, and the kernel's stored lp of a cluster is not what
     cluster 0's constants would give;
  9. the survey path at full width and depth, launch counters set to 0
     just before: acceptance in (0.1, 0.6) for every cluster, every
     truth within 5 sd of its median, the cluster-grid kernel launched;
 10. the fused-likelihood path at full width and a cut depth (the plain
     sampler loop is host-bound): finite lp, acceptance in (0.1, 0.6),
     the SZ-core kernel launched;
 11. the coupled half-step (kernel 6) at W=1024 and W=128 over 1, 2 and
     4 shards, all on this card, for 5 steps: decisions, positions and
     lp against its plain version as in phase 4; after every half-step
     the shards' blocks joined equal, bit for bit, kernel 2 at K=1 on the
     whole ensemble (so they are equal across shard counts); stored lp
     equal to a fresh kernel-1 evaluation; a wrong row offset changes
     the result; times at 512, 128 and 16 rows per shard;
 12. the mesh path at full width, launch counters set to 0 just before:
     ``run_fit`` over a mesh of four shards (all on this card: the entry
     point ``run --mesh 4`` refuses more shards than cards) at W=128,
     untempered, thin 5, which must take the hybrid coupled sampler:
     the declared frame spacing, lp equal to a kernel-1 evaluation of the
     last frame, acceptance in (0.1, 0.6), kernels 2 and 6 launched; the
     coupled sampler alone for its time per step; three short fits over
     four shards on this card with exact launch counts: ``run_fit`` at a
     layout the per-shard sampler declines (the coupled sampler, kernel
     6, never the plain step), a tempered ``run_fit`` (kernels 2-3 per
     shard; the runner equal to per-block runs, bit for bit) and
     ``fit_survey`` over a ``cluster`` mesh (kernel 4 on a block per
     shard; every shard equal to its block run alone, bit for bit);
     ``run --mesh 1`` and ``survey --mock 4 --mesh 1`` through their
     entry points.

Prints the kernel JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``; exits non-zero, with no result line,
when a phase fails or no GPU is visible.

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

# H100 SXM peaks (NVIDIA data sheet): HBM rate, FP32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
RTOL, ATOL = 2e-4, 0.5          # kernel vs plain (tests/test_pallas_joint.py)
# kernel 1 and the plain f32 version share the arithmetic order: their
# gap is rounding, far below ATOL on log-posteriors near 3e4
TIGHT_ATOL = 0.05
MARGIN = 1e-3                   # decisions closer than this may differ
W_SMOKE, K_SMOKE, STEPS_CMP, STEPS_CMP_K1 = 1024, 4, 20, 5
B_LL = 4096
C_SURVEY, STEPS_CMP_MC = 4, 5
SZ_RTOL, SZ_ATOL = 2e-5, 1e-3   # SZ core vs plain f32: order of the sums
# depth of the fused-likelihood path (burn, steps; prelim 100 x <= 2)
FUSED_BURN, FUSED_STEPS = 200, 400
# the mesh path: W, shards, thin (-> sync_every 101), windows of the hybrid
W_MESH, N_SHARDS, THIN_MESH, MESH_WINDOWS = 128, 4, 5, 40
STEPS_CMP_COUPLED = 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_time_per_launch(fn, reps: int):
    """({kernel name: device microseconds per launch}, device-busy share
    of the wall time) over ``reps`` calls of ``fn``, from torch.profiler's
    trace of the card; ({}, 0) when it recorded no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    per, total = {}, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        # device events carry the demangled signature: "name(float*, ...)"
        name = e.key.split("(")[0]
        if us > 0 and name.endswith("_kernel"):
            per[name] = us / e.count
            total += us
    return per, (total / wall_us if wall_us > 0 else 0.0)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def phase_build():
    from joxsz_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.kernel_library(name)
    dt = time.time() - t0
    print(f"[1] kernels built in {dt:.1f} s into {_build.BUILD_INFO['dir']}")
    for name, log in _build.BUILD_INFO.get("ptxas", {}).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    return dt


def phase_session(tmp: str, seed: int):
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.synth import write_synthetic_dataset

    cfg = write_synthetic_dataset(tmp, seed)
    t0 = time.time()
    sess = build_session(cfg, device="cuda")
    c = pack_consts(sess)
    I = c.ints
    check(sess.device.type == "cuda", "session not on cuda")
    check((I["n_press"], I["n_pix"], I["n_band"], I["n_ann"], I["D"])
          == (313, 86, 10, 15, 13),
          f"unexpected shapes {I}")
    check(sess.model.sz_data.L.is_cuda, "model tensors not on the card")
    print(f"[2] session on {torch.cuda.get_device_name(0)} in "
          f"{time.time() - t0:.1f} s: {I['n_press']} pressure radii, "
          f"{I['n_pix']} map radii, {I['n_data']} SZ points, "
          f"{I['n_band']} bands x {I['n_ann']} annuli, D={I['D']}")
    return cfg, sess, c


def ll_rows(sess, seed: int, n: int):
    """n parameter rows: draws around TRUTH, plus rows vetoed by the box,
    by r_c > r_s and by a non-monotone HSE mass."""
    import numpy as np
    import torch
    from joxsz_torch.synth import TRUTH

    p = sess.params
    th0 = np.array([TRUTH[k] for k in p.thawed])
    rng = np.random.default_rng(seed)
    rows = th0[None] * (1 + 0.03 * rng.standard_normal((n, th0.size)))
    ix = p.thawed.index
    rows[0::16, ix("P_0")] = -0.5                       # out of the box
    rows[1::16, ix("log(r_c)")] = 3.0                   # r_c > r_s
    rows[1::16, ix("log(r_s)")] = 2.0
    m = rows[2::16]                                     # falling mass
    m[:, ix("b")], m[:, ix("a")], m[:, ix("r_p")] = 14.0, 5.0, 150.0
    m[:, ix(r"\beta")] = 0.2
    rows[2::16] = m
    return torch.tensor(rows, dtype=torch.float64, device=sess.device)


def phase_joint(sess, c, seed: int) -> dict:
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_plain,
                                              joint_ll_flops, joint_ll_bytes)

    rows64 = ll_rows(sess, seed, B_LL)
    rows = rows64.to(torch.float32).contiguous()
    k = joint_ll(rows, c)
    p = joint_ll_plain(rows, c)
    with torch.no_grad():
        f64 = sess.model.log_like_batch(rows64)
    torch.cuda.synchronize()
    k, p, f64 = (t.double().cpu().numpy() for t in (k, p, f64))
    fin = np.isfinite(p)
    check(np.array_equal(np.isfinite(k), fin), "kernel 1 -inf mask differs "
          "from the plain float32 version")
    check(np.array_equal(np.isfinite(f64), fin), "kernel 1 -inf mask "
          "differs from the plain float64 version")
    n_veto = int((~fin).sum())
    check(n_veto >= 3 * B_LL // 16, f"only {n_veto} vetoed rows")
    err32 = float(np.max(np.abs(k[fin] - p[fin])))
    err64 = float(np.max(np.abs(k[fin] - f64[fin])))
    check(np.allclose(k[fin], p[fin], rtol=RTOL, atol=ATOL),
          f"kernel 1 vs plain f32: max abs err {err32}")
    check(err32 < TIGHT_ATOL, f"kernel 1 vs plain f32: max abs err {err32} "
          f">= {TIGHT_ATOL}")
    check(np.allclose(k[fin], f64[fin], rtol=RTOL, atol=ATOL),
          f"kernel 1 vs plain f64: max abs err {err64}")
    ms = cuda_ms(lambda: joint_ll(rows, c), reps=50)
    plain_ms = cuda_ms(lambda: joint_ll_plain(rows, c), reps=10)
    flops = joint_ll_flops(c) * B_LL
    nbytes = joint_ll_bytes(c, B_LL)
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
    print(f"[3] kernel 1 on {B_LL} rows ({n_veto} vetoed): max |err| "
          f"{err32:.4g} vs plain f32, {err64:.4g} vs plain f64; "
          f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound:.4f} ms) on "
          f"{torch.cuda.get_device_name(0)}")
    return dict(name="joint_ll", route="cuda",
                source="joxsz_torch/csrc/joint_ll.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1033",
                max_abs_err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=("bytes" if nbytes / PEAK_BYTES_S
                          > flops / PEAK_F32_S else "operations"),
                library_ms=None)


def check_half_against_plain(what: str, dec, xk, lpk, plain, plain_k1,
                             tol):
    """One half-step of a step kernel against its plain version on the
    same bits.  ``dec``: the kernel's accept decisions; ``xk``, ``lpk``:
    its moving rows after the launch; ``plain`` = (x, lp, accept, margin)
    of the fully plain step, ``plain_k1`` = (accept, margin) of the plain
    step on kernel 1's likelihood; ``tol``: how far the plain float32
    likelihood may move a threshold (beta * TIGHT_ATOL, broadcastable).
    Decisions must equal the kernel-1 step's except within MARGIN of the
    threshold; where they equal the fully plain step's, positions agree
    to 1e-5 relative and lp within RTOL / ATOL.  Returns (decisions,
    differences from the fully plain step, largest lp error)."""
    import torch

    xp, lpp, accp, margin = plain
    acc1, margin1 = plain_k1
    near = margin1.abs() < MARGIN
    check(not bool(((dec != acc1) & ~near).any()),
          f"{what}: half-step decisions differ")
    # against the fully plain step, a decision may flip only where the
    # plain f32 likelihood (one ulp is ~0.004 near 3e4) moves the threshold
    both = torch.isfinite(margin) & torch.isfinite(margin1)
    shift = (margin - margin1).abs()
    check(bool((shift[both] <= (tol + MARGIN).expand_as(shift)[both]).all()),
          f"{what}: plain and kernel-1 likelihoods move a threshold by "
          f"{float(shift[both].max())}")
    same = dec == accp
    xs, xq = xk[same], xp[same]
    check(bool(torch.all((xs - xq).abs() <= 1e-5 * xq.abs() + 1e-12)),
          f"{what}: half-step positions differ")
    lps, lpq = lpk[same], lpp[same]
    fin = torch.isfinite(lpq)
    check(torch.equal(torch.isfinite(lps), fin), f"{what}: lp masks differ")
    check(bool(torch.allclose(lps[fin], lpq[fin], rtol=RTOL, atol=ATOL)),
          f"{what}: half-step lp differ")
    return (int(same.numel()), int((~same).sum()),
            float((lps[fin] - lpq[fin]).abs().max()))


def compare_steps(x, lp, acc, betas, c, step_seed: int, n_steps: int):
    """Kernels 2 and 3 against their plain versions, step for step from
    state x (K, W, D), lp/acc (K, W) at inverse temperatures ``betas`` on
    the same Philox bits.  Returns the final state, sacc and the largest
    half-step lp and swap errors."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import (half_step_plain, swap_plain,
                                             stretch_half, swap,
                                             philox_stream)

    K, W, D = x.shape
    H = W // 2
    beta = torch.tensor(betas, dtype=torch.float32, device=c.device)
    db = [float(np.float32(betas[k] - betas[k + 1])) for k in range(K - 1)]
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    lp_k1 = lambda th: joint_ll(th, c)                    # noqa: E731
    sacc = torch.zeros(max(K - 1, 1), dtype=torch.int32, device=c.device)
    bits = philox_stream(step_seed, c.device)
    n_dec = n_near = n_swaps = 0
    err_half = err_swap = 0.0
    for step in range(n_steps):
        for which in (0, 1):
            b = bits(step, which, K * H, 4)
            xp, lpp, _, accp, margin = half_step_plain(x, lp, acc, beta,
                                                       which, b, lp_fn)
            # the plain step on kernel 1's likelihood: the step's own logic
            _, _, _, acc1, margin1 = half_step_plain(x, lp, acc, beta,
                                                     which, b, lp_k1)
            xk, lpk, acck = x.clone(), lp.clone(), acc.clone()
            stretch_half(xk, lpk, acck, beta, which, step_seed, step, c)
            mv = slice(which * H, (which + 1) * H)
            nd, nn, e = check_half_against_plain(
                f"K={K}, step {step}, half {which}",
                (acck - acc)[:, mv] > 0.5, xk[:, mv], lpk[:, mv],
                (xp[:, mv], lpp[:, mv], accp, margin), (acc1, margin1),
                beta[:, None] * TIGHT_ATOL)
            n_dec, n_near, err_half = n_dec + nd, n_near + nn, max(err_half,
                                                                   e)
            x, lp, acc = xk, lpk, acck
        for kk in range(K - 1):
            u = torch.stack([bits(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                             for hb in (0, 1)])
            xp, lpp, accp, margin = swap_plain(x, lp, kk, step_seed, step,
                                               u, db[kk])
            xk, lpk = x.clone(), lp.clone()
            swap(xk, lpk, sacc, kk, step_seed, step, db[kk])
            moved = (xk[kk] != x[kk]).any(dim=1).reshape(2, H)
            near = margin.abs() < MARGIN
            check(not bool(((moved != accp) & ~near).any()),
                  f"swap decisions differ (step {step}, boundary {kk})")
            if not bool((moved != accp).any()):
                err_swap = max(err_swap, float((xk - xp).abs().max()),
                               float((lpk - lpp).abs().max()))
            n_swaps += int(moved.sum())
            x, lp = xk, lpk
    torch.cuda.synchronize()
    check(float(acc.mean()) > 0, f"K={K}: no move was accepted")
    check(K == 1 or n_swaps > 0, "no swap was accepted")
    fresh = joint_ll(x.reshape(K * W, D), c).reshape(K, W)
    check(torch.equal(fresh, lp), f"K={K}: stored lp differs from a fresh "
          "kernel-1 evaluation")
    check(int(sacc[:K - 1].sum()) == n_swaps, "swap counter lost accepts")
    print(f"[4] {n_steps} steps at W={W}, K={K}: {n_dec} half-step "
          f"decisions, {n_near} near-threshold differences, {n_swaps} "
          f"swaps; max |lp err| {err_half:.4g}; stored lp == fresh kernel 1")
    return x, lp, acc, sacc, err_half, err_swap


def half_step_bound(c, K: int, W: int) -> tuple[float, str]:
    """(bound ms, what bounds it) of one half-step launch at (K, W)."""
    from joxsz_torch.ops.joint_kernel import joint_ll_flops

    D, rows = c.ints["D"], K * (W // 2)
    flops = joint_ll_flops(c) * rows
    nbytes = 4 * (K * W * D + 3 * K * W + K + c.buf.numel() + rows * (D + 2))
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S \
        else "operations"
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S), by


def phase_steps(sess, c, seed: int) -> tuple[dict, dict, float, float]:
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import (
        half_step_plain, swap_plain, stretch_half, swap, philox_stream)
    from joxsz_torch.sampling.tempered import default_betas
    from joxsz_torch.synth import TRUTH

    K, W, D = K_SMOKE, W_SMOKE, c.ints["D"]
    H = W // 2
    dev = c.device
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    step_seed = int(np.random.default_rng(seed).integers(0, 2 ** 31 - 1))
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(seed + 1)

    def start(k, w=W):
        x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
            (k, w, D))), dtype=torch.float32, device=dev).contiguous()
        lp = joint_ll(x.reshape(k * w, D), c).reshape(k, w)
        check(bool(torch.isfinite(lp).all()), "non-finite start state")
        return x, lp, torch.zeros((k, w), dtype=torch.float32, device=dev)

    # K=1, the plain sampler of the prelim rounds and burn-in
    x1, lp1, acc1, _, err_half1, _ = compare_steps(
        *start(1), np.ones(1), c, step_seed, STEPS_CMP_K1)
    beta1 = torch.ones(1, dtype=torch.float32, device=dev)
    # K=4, the tempered sampler
    betas = default_betas(K)
    x, lp, acc, sacc, err_half, err_swap = compare_steps(
        *start(K), betas, c, step_seed, STEPS_CMP)
    # the shapes the mesh path gives kernels 2 and 3: one shard's block of
    # W_MESH / N_SHARDS walkers, plain and tempered
    w_loc = W_MESH // N_SHARDS
    err_mesh = max(
        compare_steps(*start(1, w_loc), np.ones(1), c, step_seed,
                      STEPS_CMP)[4],
        compare_steps(*start(K, w_loc), betas, c, step_seed, STEPS_CMP)[4])
    beta = torch.tensor(betas, dtype=torch.float32, device=dev)
    db = [float(np.float32(betas[k] - betas[k + 1])) for k in range(K - 1)]
    bits = philox_stream(step_seed, dev)

    # timings: one launch of each, a full tempered step, plain versions
    half1_ms = cuda_ms(lambda: stretch_half(x1, lp1, acc1, beta1, 0,
                                            step_seed, 0, c), reps=50)
    half1_plain_ms = cuda_ms(lambda: half_step_plain(
        x1, lp1, acc1, beta1, 0, bits(0, 0, H, 4), lp_fn), reps=10)
    half1_bound, half1_by = half_step_bound(c, 1, W)
    dev1_us, _ = device_time_per_launch(
        lambda: stretch_half(x1, lp1, acc1, beta1, 0, step_seed, 0, c),
        reps=100)
    xs, lps, accs = x.clone(), lp.clone(), acc.clone()
    half_ms = cuda_ms(lambda: stretch_half(xs, lps, accs, beta, 0,
                                           step_seed, 0, c), reps=50)
    half_plain_ms = cuda_ms(lambda: half_step_plain(
        xs, lps, accs, beta, 0, bits(0, 0, K * H, 4), lp_fn), reps=10)
    half_bound, half_by = half_step_bound(c, K, W)
    # accepted swaps over the timed launches (warm-up included) set the
    # swap's row traffic
    sacc.zero_()
    swap_reps, swap_warm = 200, 2
    swap_ms = cuda_ms(lambda: swap(xs, lps, sacc, 0, step_seed, 0, db[0]),
                      reps=swap_reps, warmup=swap_warm)
    swap_acc = float(sacc[0]) / (swap_reps + swap_warm)
    uu = torch.stack([bits(0, 16 + hb, H, 1)[:, 0] for hb in (0, 1)])
    swap_plain_ms = cuda_ms(lambda: swap_plain(xs, lps, 0, step_seed, 0, uu,
                                               db[0]), reps=50)

    def one_step():
        for which in (0, 1):
            stretch_half(xs, lps, accs, beta, which, step_seed, 0, c)
        for kk in range(K - 1):
            swap(xs, lps, sacc, kk, step_seed, 0, db[kk])

    step_ms = cuda_ms(one_step, reps=100)
    dev_us, busy = device_time_per_launch(one_step, reps=100)
    if dev_us:
        print(f"[6] device time per launch in a tempered step: "
              + ", ".join(f"{k} {v:.2f} us" for k, v in dev_us.items())
              + f"; device busy {100 * busy:.1f}% of the step's wall time")
    else:
        print("[6] device time per launch: not measured (the profiler "
              "recorded no device kernels)")
    # swap: lp of both slots read for all 2H pairs; for each accepted pair
    # both rows of D floats read and written and both lp written
    swap_bytes = 4 * (2 * W + swap_acc * (4 * D + 2))
    swap_bound = 1e3 * swap_bytes / PEAK_BYTES_S
    dev1 = (f"{dev1_us['stretch_half_kernel']:.2f} us on the device"
            if "stretch_half_kernel" in dev1_us else "device us not measured")
    print(f"[6] K=1 half-step {half1_ms:.4f} ms ({dev1}; plain "
          f"{half1_plain_ms:.3f} ms, bound {half1_bound:.4f} ms) at W={W}")
    print(f"[6] K={K} half-step {half_ms:.4f} ms (plain {half_plain_ms:.3f} "
          f"ms, bound {half_bound:.4f} ms); swap {swap_ms:.4f} ms (plain "
          f"{swap_plain_ms:.3f} ms, bound {swap_bound:.6f} ms at "
          f"{swap_acc:.1f} of {W} pairs accepted per launch); tempered "
          f"step {1e3 * step_ms:.1f} us at W={W}, K={K}")
    k2 = dict(name="stretch_half", route="cuda",
              source="joxsz_torch/csrc/stretch_step.cu",
              replaces="joxsz_tpu/ops/pallas_joint.py:1242",
              max_abs_err=max(err_half, err_half1, err_mesh), ms=half_ms,
              plain_ms=half_plain_ms, bound_ms=half_bound, bound_by=half_by,
              library_ms=None)
    k3 = dict(name="swap", route="cuda",
              source="joxsz_torch/csrc/stretch_step.cu",
              replaces="joxsz_tpu/ops/pallas_joint.py:2105",
              max_abs_err=err_swap, ms=swap_ms, plain_ms=swap_plain_ms,
              bound_ms=swap_bound, bound_by="bytes", library_ms=None)
    plain_step_ms = 2 * half_plain_ms + (K - 1) * swap_plain_ms
    return k2, k3, step_ms, plain_step_ms


def phase_sz_core(cfg, sess, seed: int) -> dict:
    """Phase 7: kernel 5 (the fused SZ core) vs ``sz_core_plain``."""
    import numpy as np
    import torch
    from joxsz_torch.io.readers import read_conversion_table, read_xy
    from joxsz_torch.ops.sz_core import (make_sz_core, sz_core, sz_core_plain,
                                         sz_core_flops, sz_core_bytes)

    m = sess.model
    sz = m.sz_data
    core = make_sz_core(sess.sz_operator,
                        read_conversion_table(cfg.sz.conversion_file),
                        *read_xy(cfg.sz.flux_file, ncol=3)[1:], device="cuda")
    c = core.consts
    rows64 = ll_rows(sess, seed, B_LL)
    with torch.no_grad():
        pars = m.params.unpack(rows64)
        pp = m.pressure(pars, sz.r_press_kpc)
        t_prof = m.temperature.t_sz(pars, sz.r_press_kpc[:sz.sep])
        t_all = torch.cat([(t_prof @ sz.w_T0)[:, None], t_prof], dim=1)
        cal = pars["calibration"][:, 0]
    pp, t_all, cal = (t.to(torch.float32).contiguous()
                      for t in (pp, t_all, cal))
    # temperatures past both ends of the table, and NaN inputs
    t_all[3::16] *= 8.0
    t_all[4::16] *= -0.5
    t_all[5::64, 7] = float("nan")
    pp[6::64, 11] = float("nan")
    n_tab = int(((t_all > float(sz.conv_T[-1])) |
                 (t_all < float(sz.conv_T[0]))).any(dim=1).sum())
    k = sz_core(pp, t_all, cal, c)
    p = sz_core_plain(pp, t_all, cal, c)
    p64 = sz_core_plain(pp.double(), t_all.double(), cal.double(), c)
    torch.cuda.synchronize()
    k, p, p64 = (t.double().cpu().numpy() for t in (k, p, p64))
    nan = np.isnan(p)
    check(np.array_equal(np.isnan(k), nan), "SZ core: NaN rows differ "
          "from the plain version")
    check(int(nan.sum()) >= 2 * (B_LL // 64), f"only {int(nan.sum())} NaN "
          "rows")
    check(n_tab >= B_LL // 16, f"only {n_tab} rows leave the table")
    fin = ~nan
    check(np.all(np.isfinite(k[fin])), "SZ core: non-finite value")
    err = float(np.max(np.abs(k[fin] - p[fin])))
    rel = float(np.max(np.abs(k[fin] - p[fin]) / (np.abs(p[fin]) + 1e-30)))
    err64 = float(np.max(np.abs(k[fin] - p64[fin])
                         / (np.abs(p64[fin]) + 1e-30)))
    check(np.allclose(k[fin], p[fin], rtol=SZ_RTOL, atol=SZ_ATOL),
          f"SZ core vs plain f32: max abs err {err}, max rel err {rel}")
    ms = cuda_ms(lambda: sz_core(pp, t_all, cal, c), reps=50)
    plain_ms = cuda_ms(lambda: sz_core_plain(pp, t_all, cal, c), reps=10)
    dev_us, _ = device_time_per_launch(lambda: sz_core(pp, t_all, cal, c),
                                       reps=100)
    flops = sz_core_flops(c) * B_LL
    nbytes = sz_core_bytes(c, B_LL)
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
    dev = (f"{dev_us['sz_core_kernel']:.2f} us on the device"
           if "sz_core_kernel" in dev_us else "device us not measured")
    print(f"[7] SZ core on {B_LL} rows ({int(nan.sum())} NaN, {n_tab} "
          f"outside the table): max |err| {err:.4g} (rel {rel:.3g}) vs "
          f"plain f32, rel {err64:.3g} vs plain f64; {ms:.4f} ms ({dev}; "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms) on "
          f"{torch.cuda.get_device_name(0)}")
    return dict(name="sz_core", route="cuda",
                source="joxsz_torch/csrc/sz_core.cu",
                replaces="joxsz_tpu/ops/pallas_kernels.py:67",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=("bytes" if nbytes / PEAK_BYTES_S
                          > flops / PEAK_F32_S else "operations"),
                library_ms=None)


def phase_multicluster(sess, c, seed: int) -> dict:
    """Phase 8: kernel 4 (the cluster-grid half-step) vs its plain
    version, and the different-data negative control."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_flops,
                                              pack_consts_stack)
    from joxsz_torch.ops.multicluster_kernel import (
        half_step_multicluster_plain, multicluster_bits, multicluster_ll,
        stretch_half_multicluster)
    from joxsz_torch.simulate import simulate_survey
    from joxsz_torch.synth import TRUTH

    C, W, D = C_SURVEY, W_SMOKE, c.ints["D"]
    H = W // 2
    dev = c.device
    names = sess.params.thawed
    truths = np.tile(np.array([TRUTH[k] for k in names]), (C, 1))
    truths[:, names.index("P_0")] *= np.linspace(0.7, 1.3, C)
    truths[:, names.index(r"\beta")] += np.linspace(-0.03, 0.03, C)
    survey = simulate_survey(sess.model, truths,
                             np.random.default_rng(seed + 2))
    stack = pack_consts_stack(sess, survey.sz_stack, survey.xray_stack)
    check(stack.buf.shape == (C, c.buf.numel()), "stacked constants shape")
    step_seed = int(np.random.default_rng(seed + 3).integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed + 4)
    x = torch.tensor(truths[:, None] * (1 + 0.01 * rng.standard_normal(
        (C, W, D))), dtype=torch.float32, device=dev).contiguous()
    lp = multicluster_ll(x, stack)
    check(bool(torch.isfinite(lp).all()), "non-finite start state")
    acc = torch.zeros((C, W), dtype=torch.float32, device=dev)

    # negative control 1: the same parameters under two clusters'
    # constants give different log-posteriors
    same = torch.stack([joint_ll(x[0], cc) for cc in stack.clusters])
    gap = float((same[1:] - same[:1]).abs().min())
    check(gap > 1.0, f"clusters' constants give the same lp (gap {gap})")

    def compare(x, lp, acc, stk):
        """STEPS_CMP_MC steps of the cluster grid ``stk`` from (x, lp, acc),
        every launch against its plain version."""
        n_c = stk.n_clusters
        lp_k1 = lambda th: multicluster_ll(th, stk)         # noqa: E731
        beta = torch.ones((n_c, 1), dtype=torch.float32, device=dev)
        n_dec = n_near = 0
        err_half = 0.0
        for step in range(STEPS_CMP_MC):
            for which in (0, 1):
                b = multicluster_bits(step_seed, dev, step, which, n_c, H)
                xp, lpp, _, accp, margin = half_step_multicluster_plain(
                    x, lp, acc, which, b, stk)
                _, _, _, acc1, margin1 = half_step_multicluster_plain(
                    x, lp, acc, which, b, stk, lp_fn=lp_k1)
                xk, lpk, acck = x.clone(), lp.clone(), acc.clone()
                stretch_half_multicluster(xk, lpk, acck, which, step_seed,
                                          step, stk)
                mv = slice(which * H, (which + 1) * H)
                nd, nn, e = check_half_against_plain(
                    f"cluster grid C={n_c}, step {step}, half {which}",
                    (acck - acc)[:, mv] > 0.5, xk[:, mv], lpk[:, mv],
                    (xp[:, mv], lpp[:, mv], accp, margin), (acc1, margin1),
                    beta * TIGHT_ATOL)
                n_dec, n_near, err_half = (n_dec + nd, n_near + nn,
                                           max(err_half, e))
                x, lp, acc = xk, lpk, acck
        return x, lp, acc, n_dec, n_near, err_half

    # one shard's block on the survey's mesh path: C / N_SHARDS clusters
    c_loc = C // N_SHARDS
    xb, lpb, _, nb, _, err_block = compare(
        x[C - c_loc:].clone(), lp[C - c_loc:].clone(),
        acc[C - c_loc:].clone(), stack.block(C - c_loc, C, dev))
    check(torch.equal(multicluster_ll(xb, stack.block(C - c_loc, C, dev)),
                      lpb), "cluster block: stored lp differs from a fresh "
          "kernel-1 evaluation")
    x, lp, acc, n_dec, n_near, err_half = compare(x, lp, acc, stack)
    n_dec += nb
    err_half = max(err_half, err_block)
    torch.cuda.synchronize()
    check(all(float(acc[k].mean()) > 0 for k in range(C)),
          "cluster grid: a cluster accepted no move")
    fresh = multicluster_ll(x, stack)
    check(torch.equal(fresh, lp), "cluster grid: stored lp differs from a "
          "fresh kernel-1 evaluation on each cluster's constants")
    # negative control 2: under cluster 0's constants the other
    # clusters' stored lp would be different numbers
    wrong = torch.stack([joint_ll(x[k], stack.clusters[0])
                         for k in range(C)])
    gap2 = float((wrong[1:] - lp[1:]).abs().min())
    check(gap2 > 1.0, "cluster grid: a cluster's lp equals what cluster "
          f"0's constants give (gap {gap2})")

    ms = cuda_ms(lambda: stretch_half_multicluster(
        x, lp, acc, 0, step_seed, 0, stack), reps=50)
    dev_us, _ = device_time_per_launch(lambda: stretch_half_multicluster(
        x, lp, acc, 0, step_seed, 0, stack), reps=100)
    b0 = multicluster_bits(step_seed, dev, 0, 0, C, H)
    plain_ms = cuda_ms(lambda: half_step_multicluster_plain(
        x, lp, acc, 0, b0, stack), reps=5)
    rows = C * H
    flops = joint_ll_flops(c) * rows
    nbytes = 4 * (C * W * D + 3 * C * W + stack.buf.numel() + rows * (D + 2))
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
    dv = (f"{dev_us['stretch_half_kernel']:.2f} us on the device"
          if "stretch_half_kernel" in dev_us else "device us not measured")
    print(f"[8] {STEPS_CMP_MC} steps at C={C} and at a mesh shard's block "
          f"of C={c_loc}, W={W}: {n_dec} half-step "
          f"decisions, {n_near} near-threshold differences; max |lp err| "
          f"{err_half:.4g}; stored lp == fresh kernel 1 per cluster; "
          f"different-data gaps {gap:.1f} / {gap2:.1f}; {ms:.4f} ms ({dv}; "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms)")
    return dict(name="stretch_half_multicluster", route="cuda",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1859",
                max_abs_err=err_half, ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by=("bytes" if nbytes / PEAK_BYTES_S
                          > flops / PEAK_F32_S else "operations"),
                library_ms=None)


def coupled_bound(c, H_loc: int, H: int) -> tuple[float, str]:
    """(bound ms, what bounds it) of one kernel-6 launch: the likelihood
    of H_loc rows; the block's x, lp and acc read and written, the fixed
    half and the constants read."""
    from joxsz_torch.ops.joint_kernel import joint_ll_flops

    D = c.ints["D"]
    flops = joint_ll_flops(c) * H_loc
    nbytes = 4 * (2 * H_loc * (D + 2) + H * D + c.buf.numel())
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S \
        else "operations"
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S), by


def compare_coupled(x0, lp0, c, step_seed: int, n_shards: int, devices=None):
    """Kernel 6 over ``n_shards`` shards from the ensemble x0 (W, D), lp0
    (W,) for STEPS_CMP_COUPLED steps: every launch against its plain
    version on the same Philox bits, and after every half-step the joined
    blocks against kernel 2 at K = 1 on the whole ensemble, bit for bit.
    ``devices``: one card per shard (default: all on the constants'
    card; the plain comparison runs only there).  Returns (decisions,
    near-threshold differences, largest lp error, final x, lp, acc)."""
    import torch
    from joxsz_torch.ops.coupled_kernel import (coupled_half,
                                                coupled_half_plain)
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import philox_stream, stretch_half

    W, D = x0.shape
    H = W // 2
    H_loc = H // n_shards
    home = c.device
    compare_plain = devices is None
    devices = devices or [home] * n_shards
    consts = [c.to(d) for d in devices]
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    lp_k1 = lambda th: joint_ll(th, c)                    # noqa: E731
    bits = philox_stream(step_seed, home)
    beta1 = torch.ones(1, dtype=torch.float32, device=home)
    xr, lr, ar = x0[None].clone(), lp0[None].clone(), torch.zeros_like(
        lp0)[None]
    # halves[h][k][s]: tensor k (x, lp, acc) of shard s's block of half h
    halves = [[[t[h * H + s * H_loc:h * H + (s + 1) * H_loc].to(
        devices[s], copy=True).contiguous() for s in range(n_shards)]
        for t in (x0, lp0, torch.zeros_like(lp0))] for h in (0, 1)]
    n_dec = n_near = 0
    err = 0.0
    for step in range(STEPS_CMP_COUPLED):
        for which in (0, 1):
            b = bits(step, which, H, 4)
            xm, lm, am = halves[which]
            fixed_home = torch.cat([t.to(home) for t in halves[1 - which][0]])
            for s in range(n_shards):
                fixed = fixed_home.to(devices[s])
                if compare_plain:
                    xp, lpp, _, accp, margin = coupled_half_plain(
                        xm[s], lm[s], am[s], fixed, s * H_loc, b, lp_fn)
                    _, _, _, acc1, margin1 = coupled_half_plain(
                        xm[s], lm[s], am[s], fixed, s * H_loc, b, lp_k1)
                    a_before = am[s].clone()
                coupled_half(xm[s], lm[s], am[s], fixed, which, step_seed,
                             step, s * H_loc, consts[s])
                if not compare_plain:
                    continue
                nd, nn, e = check_half_against_plain(
                    f"coupled, W={W}, {n_shards} shards, step {step}, half "
                    f"{which}, shard {s}", (am[s] - a_before) > 0.5, xm[s],
                    lm[s], (xp, lpp, accp, margin), (acc1, margin1),
                    torch.tensor(TIGHT_ATOL, device=home))
                n_dec, n_near, err = n_dec + nd, n_near + nn, max(err, e)
            # kernel 2 at K = 1 on the whole ensemble, same seed and step
            stretch_half(xr, lr, ar, beta1, which, step_seed, step, c)
            mv = slice(which * H, (which + 1) * H)
            for k, ref in enumerate((xr, lr, ar)):
                got = torch.cat([t.to(home) for t in halves[which][k]])
                check(torch.equal(got, ref[0, mv]),
                      f"coupled: {('x', 'lp', 'acc')[k]} over {n_shards} "
                      f"shards differs from kernel 2 at K=1 (W={W}, step "
                      f"{step}, half {which})")
    torch.cuda.synchronize()
    x, lp, acc = (torch.cat([t.to(home) for h in (0, 1)
                             for t in halves[h][k]]) for k in range(3))
    check(float(acc.mean()) > 0, "coupled: no move was accepted")
    check(torch.equal(joint_ll(x, c), lp), "coupled: stored lp differs from "
          "a fresh kernel-1 evaluation")
    return n_dec, n_near, err, x, lp, acc


def phase_coupled(sess, c, seed: int) -> dict:
    """Phase 11: kernel 6 (the coupled half-step) vs its plain version and
    vs kernel 2 at K = 1, the negative control, and its times."""
    import numpy as np
    import torch
    from joxsz_torch.ops.coupled_kernel import (coupled_half,
                                                coupled_half_plain)
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import philox_stream, stretch_half
    from joxsz_torch.synth import TRUTH

    D, dev = c.ints["D"], c.device
    step_seed = int(np.random.default_rng(seed + 5).integers(0, 2 ** 31 - 1))
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(seed + 6)
    starts, err = {}, 0.0
    for W in (W_SMOKE, W_MESH):
        x0 = torch.tensor(th0[None] * (1 + 0.01 * rng.standard_normal(
            (W, D))), dtype=torch.float32, device=dev).contiguous()
        lp0 = joint_ll(x0, c)
        check(bool(torch.isfinite(lp0).all()), "non-finite start state")
        starts[W] = (x0, lp0)
        finals = []
        for n in (1, 2, 4):
            n_dec, n_near, e, x, lp, acc = compare_coupled(
                x0, lp0, c, step_seed, n)
            err = max(err, e)
            finals.append((x, lp, acc))
            print(f"[11] W={W}, {n} shard(s), {STEPS_CMP_COUPLED} steps: "
                  f"{n_dec} decisions, {n_near} near-threshold differences "
                  f"vs plain; max |lp err| {e:.4g}; x, lp, acc == kernel 2 at "
                  "K=1 after every half-step; stored lp == fresh kernel 1")
        check(all(torch.equal(a, b) for f in finals[1:]
                  for a, b in zip(f, finals[0])),
              f"coupled: W={W}: shard counts disagree")
    # negative control: shard 1's rows drawn at shard 0's row offset
    x0, lp0 = starts[W_MESH]
    H = W_MESH // 2
    H_loc = H // N_SHARDS
    fixed = x0[H:].contiguous()
    outs = []
    for off in (H_loc, 0):
        xm, lm = x0[H_loc:2 * H_loc].clone(), lp0[H_loc:2 * H_loc].clone()
        am = torch.zeros_like(lm)
        for step in range(STEPS_CMP_COUPLED):
            coupled_half(xm, lm, am, fixed, 0, step_seed, step, off, c)
        outs.append(xm)
    check(not torch.equal(outs[0], outs[1]), "coupled: a wrong row offset "
          "gives the same result")
    if torch.cuda.device_count() >= N_SHARDS:
        cards = [torch.device("cuda", i) for i in range(N_SHARDS)]
        compare_coupled(x0, lp0, c, step_seed, N_SHARDS, devices=cards)
        print(f"[11] W={W_MESH}: {N_SHARDS} shards on {N_SHARDS} distinct "
              "cards == kernel 2 at K=1 on one card, bit for bit")
    else:
        print(f"[11] one card visible: the {N_SHARDS} shards share cuda:0 "
              "(each its own buffers and launches)")

    # times at 512, 128 and 16 rows per shard
    bits = philox_stream(step_seed, dev)
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    timed = {}
    for W, n in ((W_SMOKE, 1), (W_SMOKE, 4), (W_MESH, N_SHARDS)):
        x0, lp0 = starts[W]
        H = W // 2
        H_loc = H // n
        xm, lm = x0[:H_loc].clone(), lp0[:H_loc].clone()
        am = torch.zeros_like(lm)
        fixed = x0[H:].contiguous()
        run = lambda: coupled_half(xm, lm, am, fixed, 0, step_seed,  # noqa
                                   0, 0, c)
        ms = cuda_ms(run, reps=50)
        dev_us, _ = device_time_per_launch(run, reps=100)
        b = bits(0, 0, H, 4)
        plain_ms = cuda_ms(lambda: coupled_half_plain(
            xm, lm, am, fixed, 0, b, lp_fn), reps=10)
        bound, by = coupled_bound(c, H_loc, H)
        timed[H_loc] = (ms, plain_ms, bound, by)
        dv = (f"{dev_us['coupled_half_kernel']:.2f} us on the device"
              if "coupled_half_kernel" in dev_us
              else "device us not measured")
        print(f"[11] kernel 6 at H_loc={H_loc}, H={H}: {ms:.4f} ms ({dv}; "
              f"plain {plain_ms:.3f} ms, bound {bound:.5f} ms by {by})")
        if n == 1:
            # kernel 2 at K = 1 on the same ensemble: the same rows and bits
            xw, lw = x0[None].clone(), lp0[None].clone()
            aw = torch.zeros_like(lw)
            one = torch.ones(1, dtype=torch.float32, device=dev)
            ms2 = cuda_ms(lambda: stretch_half(xw, lw, aw, one, 0, step_seed,
                                               0, c), reps=50)
            print(f"[11] kernel 2 at K=1 on the same W={W} ensemble: "
                  f"{ms2:.4f} ms")
    ms, plain_ms, bound, by = timed[W_MESH // 2 // N_SHARDS]
    return dict(name="coupled_half", route="cuda",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1657",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def phase_mesh_path(cfg, tmp: str, path: str, seed: int, theta0) -> dict:
    """Phase 12: the mesh fit at full width through ``run_fit(mesh=...)``
    over four shards, the coupled sampler alone, and the entry points
    ``run --mesh 1`` and ``survey --mesh 1``."""
    import numpy as np
    import torch
    from joxsz_torch import run, survey
    from joxsz_torch.build import build_session
    from joxsz_torch.ops.joint_kernel import joint_ll, pack_consts_stack
    from joxsz_torch.ops.multicluster_kernel import multicluster_ll
    from joxsz_torch.parallel import make_mesh, run_coupled_sharded_ensemble
    from joxsz_torch.sampling.batched import batched_init
    from joxsz_torch.sampling.driver import run_fit
    from joxsz_torch.sampling.kernel import (kernel_step, make_kernel_sampler,
                                             rung_differences,
                                             run_multicluster_steps)
    from joxsz_torch.sampling.tempered import default_betas
    from joxsz_torch.simulate import simulate_survey

    sync_every = THIN_MESH * round(99 / THIN_MESH) + 1
    nsteps = MESH_WINDOWS * sync_every
    sess = build_session(cfg, device="cuda")
    sampler = make_kernel_sampler(sess)
    mesh = make_mesh(N_SHARDS, axis_names=("walker",),
                     devices=[torch.device("cuda", 0)] * N_SHARDS)
    p = sess.params
    print(f"[12] mesh path, full width: run_fit over {mesh}, W={W_MESH} "
          f"({W_MESH // N_SHARDS} walkers per shard), untempered, prelim "
          f"100 x <= 2, burn 200, {nsteps} steps, thin {THIN_MESH}; walkers "
          "start around the main path's MLE (no second MLE)")
    zero_launches()
    t0 = time.time()
    res = run_fit(sess.model, sampler, theta0, p.lo, p.hi, p.thawed,
                  nwalkers=W_MESH, nburn=200, nsteps=nsteps, nthin=THIN_MESH,
                  seed=seed, prelim_iterations=100, max_prelim_rounds=2,
                  n_temper_rungs=0, do_mle=False, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    t = res.timings
    acc = float(np.mean(res.acceptance_fraction))
    print(f"[12] mesh fit in {wall:.1f} s (prelim {t['prelim_s']:.2f} s, "
          f"burn {t['burn_s']:.2f} s, sampling {t['sample_s']:.2f} s, "
          f"{t['evals_per_s']:.0f} evals/s; sampling phase alone "
          f"{W_MESH * nsteps / t['sample_s']:.0f} evals/s): acceptance "
          f"{acc:.3f}, frame spacing {t['frame_spacing']:.4f}, launches "
          f"{launches}")
    check(abs(t["frame_spacing"] - THIN_MESH * sync_every / (sync_every - 1))
          < 1e-12, f"the hybrid was not taken: frame spacing "
          f"{t['frame_spacing']}")
    n_keep = MESH_WINDOWS * (sync_every - 1) // THIN_MESH
    check(res.chain.shape == (n_keep, W_MESH, 13)
          and np.all(np.isfinite(res.chain)), f"mesh chain {res.chain.shape}")
    check(np.all(np.isfinite(res.log_prob)), "non-finite mesh log-probs")
    fresh = sampler.log_prob_batch(torch.tensor(res.chain[-1])).cpu().numpy()
    check(np.array_equal(fresh, res.log_prob[-1]), "mesh: stored lp differs "
          "from a kernel-1 evaluation of the last frame")
    check(0.1 < acc < 0.6, f"mesh acceptance {acc} outside (0.1, 0.6)")
    check(launches["coupled_half"] == MESH_WINDOWS * 2 * N_SHARDS,
          f"kernel 6 launches {launches['coupled_half']}")
    check(launches["stretch_half"] >= MESH_WINDOWS * (sync_every - 1) * 2
          * N_SHARDS and launches["joint_ll"] > 0, f"mesh launches {launches}")
    check(launches["swap"] == 0, "the swap kernel ran on an untempered fit")

    # the coupled sampler alone: time per coupled step at 4 shards
    p0 = torch.tensor(res.chain[-1], device="cuda")
    n_c = 200
    run_coupled_sharded_ensemble(sampler.consts, p0, 10, seed, mesh)
    torch.cuda.synchronize()
    t0 = time.time()
    rc = run_coupled_sharded_ensemble(sampler.consts, p0, n_c, seed, mesh,
                                      thin=THIN_MESH)
    torch.cuda.synchronize()
    step_us = 1e6 * (time.time() - t0) / n_c
    # one long call per repetition, so its set-up (first lp, the frames'
    # copy to the host) weighs little in the busy share
    dev_us, busy = device_time_per_launch(
        lambda: run_coupled_sharded_ensemble(sampler.consts, p0, n_c, seed,
                                             mesh, thin=THIN_MESH), reps=2)
    check(np.all(np.isfinite(rc.log_prob)) and 0.1 < float(np.mean(
        rc.acceptance_fraction)) < 0.6, "coupled sampler acceptance")
    print(f"[12] coupled sampler alone, W={W_MESH}, {N_SHARDS} shards, "
          f"{n_c} steps: {step_us:.1f} us per coupled step (2 x {N_SHARDS} "
          f"launches + 2 gathers), kernels 1 and 6 busy {100 * busy:.1f}% of "
          f"the wall time; acceptance {float(np.mean(rc.acceptance_fraction)):.3f}")

    def short_fit(**kw):
        """A short mesh fit with the launch counts read around it."""
        zero_launches()
        r = run_fit(sess.model, sampler, theta0, p.lo, p.hi, p.thawed,
                    nburn=100, nthin=THIN_MESH, seed=seed,
                    prelim_iterations=100, max_prelim_rounds=1,
                    do_mle=False, mesh=mesh, **kw)
        torch.cuda.synchronize()
        n = read_launches()
        check(np.all(np.isfinite(r.chain)) and np.all(np.isfinite(
            r.log_prob)), "non-finite short mesh fit")
        lp_re = sampler.log_prob_batch(torch.tensor(r.chain[-1])).cpu().numpy()
        check(np.array_equal(lp_re, r.log_prob[-1]), "short mesh fit: stored "
              "lp differs from a kernel-1 evaluation of the last frame")
        # quick depth: a looser band than the full-depth paths'
        check(0.02 < float(np.mean(r.acceptance_fraction)) < 0.8,
              "short mesh fit acceptance")
        return r, n, 2 * 100 * (r.timings["prelim_rounds"] + 1)

    # a layout the per-shard sampler declines (16 walkers per shard, below
    # the floor of 28): one ensemble coupled at every step, kernel 6
    n_d = 100
    rd, ld, one_dev = short_fit(nwalkers=W_MESH // 2, nsteps=n_d,
                                n_temper_rungs=0)
    check(rd.chain.shape == (n_d // THIN_MESH, W_MESH // 2, 13)
          and rd.timings["frame_spacing"] == THIN_MESH, "declined-layout fit")
    check(ld["coupled_half"] == n_d * 2 * N_SHARDS
          and ld["stretch_half"] == one_dev and ld["swap"] == 0,
          f"declined-layout launches {ld}")
    print(f"[12] run_fit at W={W_MESH // 2} ({W_MESH // 2 // N_SHARDS} "
          f"walkers per shard, declined by the per-shard sampler): the "
          f"coupled sampler, {n_d} steps in {rd.timings['sample_s']:.2f} s, "
          f"acceptance {float(np.mean(rd.acceptance_fraction)):.3f}, "
          f"launches {ld}")

    # a tempered mesh fit: an independent K-rung ensemble per shard
    # (kernels 2-3), then the runner against per-block runs, bit for bit
    K, n_t, w_loc = K_SMOKE, 200, W_MESH // N_SHARDS
    rt, lt, one_dev = short_fit(nwalkers=W_MESH, nsteps=n_t,
                                n_temper_rungs=K)
    swaps = rt.timings["swap_acceptance"]
    check(rt.chain.shape == (n_t // THIN_MESH, W_MESH, 13)
          and len(swaps) == K - 1
          and all(math.isfinite(v) and v > 0 for v in swaps),
          f"tempered mesh fit: chain {rt.chain.shape}, swap rates {swaps}")
    check(lt["swap"] == n_t * (K - 1) * N_SHARDS
          and lt["stretch_half"] == one_dev + n_t * 2 * N_SHARDS
          and lt["coupled_half"] == 0, f"tempered mesh launches {lt}")
    betas = default_betas(K)
    n_b = 50
    pt = torch.tensor(rt.chain[-1], device="cuda")
    got = sampler.run_tempered_sharded(pt, betas, n_b,
                                       np.random.default_rng(seed), mesh,
                                       thin=THIN_MESH)
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31 - 1,
                                                 size=(1, N_SHARDS))[0]
    beta = torch.tensor(betas, dtype=torch.float32, device="cuda")
    for d in range(N_SHARDS):
        blk = slice(d * w_loc, (d + 1) * w_loc)
        x = pt[None, blk].repeat(K, 1, 1)
        lp = joint_ll(x.reshape(K * w_loc, 13), sampler.consts).reshape(
            K, w_loc)
        acc = torch.zeros_like(lp)
        sacc = torch.zeros(K - 1, dtype=torch.int32, device="cuda")
        for i in range(n_b):
            kernel_step(x, lp, acc, sacc, beta, rung_differences(betas),
                        int(seeds[d]), i, sampler.consts)
        check(torch.equal(got.final_state[0][:, blk], x)
              and torch.equal(got.final_state[1][:, blk], lp)
              and np.array_equal(got.chain[-1, blk], x[0].cpu().numpy()),
              f"tempered mesh runner: shard {d} differs from its block "
              "run alone")
    print(f"[12] tempered run_fit over the mesh, W={W_MESH} x K={K}, {n_t} "
          f"steps in {rt.timings['sample_s']:.2f} s: acceptance "
          f"{float(np.mean(rt.acceptance_fraction)):.3f}, swap rates "
          f"{np.round(swaps, 3).tolist()}, launches {lt}; "
          f"run_tempered_sharded == per-block runs, bit for bit")

    # the survey over a 'cluster' mesh of four shards on this card
    # (kernel 4 on a block of one cluster per shard), against each block
    # run alone on its seed, bit for bit
    C, W, n_burn, n_s = C_SURVEY, W_SMOKE, 50, 100
    c_loc = C // N_SHARDS
    truths = np.tile(np.asarray(p.thawed_values()), (C, 1))
    truths[:, p.thawed.index("P_0")] *= np.linspace(0.7, 1.3, C)
    truths[:, p.thawed.index(r"\beta")] += np.linspace(-0.03, 0.03, C)
    sv = simulate_survey(sess.model, truths, np.random.default_rng(seed + 7))
    cmesh = make_mesh(N_SHARDS, axis_names=("cluster",),
                      devices=[torch.device("cuda", 0)] * N_SHARDS)
    zero_launches()
    t0 = time.time()
    rs = survey.fit_survey(sess, sv.sz_stack, sv.xray_stack, truths,
                           n_walkers=W, n_burn=n_burn, n_steps=n_s,
                           thin=THIN_MESH, seed=seed, mesh=cmesh)
    wall_s = time.time() - t0
    ls = read_launches()
    check(rs.chain.shape == (n_s // THIN_MESH, C, W, 13)
          and np.all(np.isfinite(rs.chain))
          and np.all(np.isfinite(rs.log_prob)), f"survey mesh chain "
          f"{rs.chain.shape}")
    check(ls["stretch_half_multicluster"] == 2 * (n_burn + n_s) * N_SHARDS
          and ls["stretch_half"] == 0, f"survey mesh launches {ls}")
    stack = pack_consts_stack(sess, sv.sz_stack, sv.xray_stack)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x0 = batched_init(lambda th: multicluster_ll(th, stack), truths, W, gen,
                      device=sess.device, dtype=torch.float32,
                      spread=0.05).contiguous()
    lp0 = multicluster_ll(x0, stack)
    for d in range(N_SHARDS):
        blk = slice(d * c_loc, (d + 1) * c_loc)
        sb = stack.block(blk.start, blk.stop)
        x, lp = x0[blk].clone(), lp0[blk].clone()
        acc = torch.zeros_like(lp)
        run_multicluster_steps(sb, x, lp, acc, n_burn,
                               (2 * seed + 1) * N_SHARDS + d)
        acc.zero_()
        ch, ch_lp = run_multicluster_steps(
            sb, x, lp, acc, n_s, (2 * seed + 2) * N_SHARDS + d,
            thin=THIN_MESH)
        check(np.array_equal(rs.chain[:, blk], ch.permute(1, 0, 2, 3)
                             .cpu().numpy())
              and np.array_equal(rs.log_prob[:, blk], ch_lp.permute(1, 0, 2)
                                 .cpu().numpy())
              and np.array_equal(rs.acceptance[blk], (acc / float(n_s))
                                 .cpu().numpy()),
              f"survey mesh: shard {d} differs from its block run alone")
    a_s = rs.acceptance.mean(axis=1)
    check(bool(np.all((a_s > 0.02) & (a_s < 0.8))), f"survey mesh "
          f"acceptance {a_s}")
    print(f"[12] fit_survey over a 'cluster' mesh of {N_SHARDS} shards, "
          f"C={C}, W={W}, {n_burn} + {n_s} steps in {wall_s:.2f} s "
          f"(sampling {rs.timings['sampling_s']:.2f} s): acceptance "
          f"{[round(float(v), 3) for v in a_s]}, launches {ls}; every shard == its "
          "block run alone, bit for bit")

    # the entry points on the degenerate mesh (one real card)
    t0 = time.time()
    r1 = run.main(["--config", path, "--quick", "--walkers", str(W_MESH),
                   "--temper", "0", "--mesh", "1", "--seed", str(seed)])
    check(r1.chain.shape[1:] == (W_MESH, 13) and r1.chain.shape[0] % 80 == 0
          and np.all(np.isfinite(r1.log_prob)),
          f"run --mesh 1 chain {r1.chain.shape}")
    # quick depth: a looser band than the full-depth paths'
    check(0.02 < float(np.mean(r1.acceptance_fraction)) < 0.8,
          "run --mesh 1 acceptance")
    print(f"[12] run --mesh 1 --quick in {time.time() - t0:.1f} s (MLE "
          f"{r1.timings['mle_s']:.1f} s): acceptance "
          f"{float(np.mean(r1.acceptance_fraction)):.3f}")
    t0 = time.time()
    r2 = survey.main(["--mock", str(C_SURVEY), "--config", path, "--quick",
                      "--mesh", "1", "--seed", str(seed), "--out",
                      f"{tmp}/survey_mesh.json"])
    a2 = r2.acceptance.mean(axis=1)
    check(r2.chain.shape == (30, C_SURVEY, 32, 13) and np.all(np.isfinite(
        r2.log_prob)), f"survey --mesh 1 chain {r2.chain.shape}")
    check(bool(np.all((a2 > 0.02) & (a2 < 0.8))), f"survey --mesh 1 "
          f"acceptance {a2}")
    print(f"[12] survey --mock {C_SURVEY} --mesh 1 --quick in "
          f"{time.time() - t0:.1f} s: acceptance {np.round(a2, 3).tolist()}")
    return launches


def all_launches() -> dict:
    from joxsz_torch.ops.coupled_kernel import coupled_half
    from joxsz_torch.ops.joint_kernel import joint_ll
    from joxsz_torch.ops.multicluster_kernel import stretch_half_multicluster
    from joxsz_torch.ops.step_kernel import stretch_half, swap
    from joxsz_torch.ops.sz_core import sz_core

    return {"joint_ll": joint_ll, "stretch_half": stretch_half,
            "swap": swap,
            "stretch_half_multicluster": stretch_half_multicluster,
            "sz_core": sz_core, "coupled_half": coupled_half}


def zero_launches():
    for fn in all_launches().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in all_launches().items()}


def phase_survey_path(tmp: str, path: str, seed: int) -> dict:
    """Phase 9: ``joxsz_torch.survey --mock 4`` at W=1024, 1000 + 1000."""
    import numpy as np
    from joxsz_torch import survey

    C, W = C_SURVEY, W_SMOKE
    print(f"[9] survey path, full width and depth: --mock {C}, W={W}, "
          "1000 burn + 1000 steps, thin 5")
    zero_launches()
    t0 = time.time()
    res = survey.main(["--mock", str(C), "--config", path, "--walkers",
                       str(W), "--seed", str(seed), "--out",
                       f"{tmp}/survey_summary.json"])
    wall = time.time() - t0
    launches = read_launches()
    acc = res.acceptance.mean(axis=1)
    pulls = np.abs(res.medians - res.truths) / np.maximum(res.sds, 1e-12)
    t = res.timings
    evals = C * W * 2000
    print(f"[9] survey path in {wall:.1f} s: setup_s {t['setup_s']:.2f}, "
          f"sampling_s {t['sampling_s']:.2f} ({evals / t['sampling_s']:.0f} "
          f"evals/s), acceptance {np.round(acc, 3).tolist()}, largest pull "
          f"{float(pulls.max()):.2f} sd, launches {launches}")
    check(res.chain.shape == (200, C, W, 13) and np.all(np.isfinite(
        res.chain)), f"survey chain shape {res.chain.shape} or non-finite")
    check(np.all(np.isfinite(res.log_prob)), "non-finite survey log-probs")
    check(bool(np.all((acc > 0.1) & (acc < 0.6))),
          f"survey acceptance {acc} outside (0.1, 0.6)")
    check(bool(np.all(pulls < 5.0)), f"a truth lies {float(pulls.max()):.1f} "
          "sd from its median")
    check(launches["stretch_half_multicluster"] == 2 * 2000
          and launches["joint_ll"] > 0, f"survey launches {launches}")
    check(launches["swap"] == 0, "the swap kernel ran on cluster-grid state")
    summary = json.loads(open(f"{tmp}/survey_summary.json").read())
    check(len(summary["clusters"]) == C, "survey summary")
    return launches


def phase_fused_path(cfg, tmp: str, seed: int) -> dict:
    """Phase 10: ``run --fused --no-step-kernel`` at W=1024, cut depth."""
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.config import MCMCConfig
    from joxsz_torch.synth import config_json

    cfg.mcmc = MCMCConfig(nwalkers=W_SMOKE, seed=seed)
    cfg.save_dir = tmp
    path = config_json(cfg, f"{tmp}/fused.json")
    print(f"[10] fused-likelihood path, full width, depth cut (host-bound "
          f"plain sampler loop): W={W_SMOKE}, K=1, prelim 100 x <= 2, burn "
          f"{FUSED_BURN}, steps {FUSED_STEPS} (--quick)")
    zero_launches()
    t0 = time.time()
    res = run.main(["--config", path, "--quick", "--fused",
                    "--no-step-kernel"])
    wall = time.time() - t0
    launches = read_launches()
    acc = float(np.mean(res.acceptance_fraction))
    t = res.timings
    print(f"[10] fused path in {wall:.1f} s (MLE {t['mle_s']:.1f} s, "
          f"sampling {t['prelim_s'] + t['burn_s'] + t['sample_s']:.1f} s, "
          f"{t['evals_per_s']:.0f} evals/s): acceptance {acc:.3f}, "
          f"launches {launches}")
    check(res.chain.shape == (FUSED_STEPS // 5, W_SMOKE, 13)
          and np.all(np.isfinite(res.chain)), "fused chain")
    check(np.all(np.isfinite(res.log_prob)), "non-finite fused log-probs")
    check(0.1 < acc < 0.6, f"fused acceptance {acc} outside (0.1, 0.6)")
    check(launches["sz_core"] > 0, f"fused launches {launches}")
    check(launches["stretch_half"] == 0 and launches["joint_ll"] == 0,
          f"the step kernels ran with --no-step-kernel: {launches}")
    return launches


def phase_main_path(cfg, tmp: str, seed: int) -> dict:
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.config import MCMCConfig
    from joxsz_torch.synth import config_json

    # the card's production schedule at full width (W=1024 x K=4, full
    # likelihood, 1000 x <=10 prelim / 4000 burn / 8000 steps / <=3
    # extensions): it fits the time limit, so no count is cut
    cfg.mcmc = MCMCConfig.converged_gpu()
    cfg.mcmc.seed = seed
    cfg.save_dir = tmp
    m = cfg.mcmc
    print(f"[5] main path, production schedule, no count cut: W="
          f"{m.nwalkers} x K={m.n_temper_rungs}, prelim "
          f"{m.prelim_iterations}, burn {m.nburn}, steps {m.nsteps}, "
          f"auto-extend {m.auto_extend}")
    path = config_json(cfg, f"{tmp}/smoke.json")
    zero_launches()
    t0 = time.time()
    res = run.main(["--config", path])
    wall = time.time() - t0
    launches = read_launches()
    acc = float(np.mean(res.acceptance_fraction))
    swaps = res.timings.get("swap_acceptance", [])
    print(f"[5] main path in {wall:.1f} s: acceptance {acc:.3f}, swap rates "
          f"{np.round(swaps, 3).tolist()}, launches {launches}")
    check(0.1 < acc < 0.6, f"acceptance {acc} outside (0.1, 0.6)")
    check(len(swaps) == K_SMOKE - 1
          and all(math.isfinite(s) and s > 0 for s in swaps),
          f"swap rates {swaps}")
    check(all(launches[k] > 0 for k in ("joint_ll", "stretch_half", "swap")),
          f"a kernel was not launched on the main path: {launches}")
    check(np.all(np.isfinite(res.chain)) and res.chain.shape[1:] == (
        W_SMOKE, 13), f"chain shape {res.chain.shape} or non-finite values")
    check(np.all(np.isfinite(res.log_prob)), "non-finite chain log-probs")
    return launches, path, res.mle_theta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="joxsz_smoke_")
    try:
        card = card_line()
        print(f"[1] card: {card}")
        phase_build()
        cfg, sess, c = phase_session(tmp, args.seed)
        k1 = phase_joint(sess, c, args.seed)
        k2, k3, step_ms, plain_step_ms = phase_steps(sess, c, args.seed)
        k5 = phase_sz_core(cfg, sess, args.seed)
        k4 = phase_multicluster(sess, c, args.seed)
        k6 = phase_coupled(sess, c, args.seed)
        del sess, c
        launches, path, mle_theta = phase_main_path(cfg, tmp, args.seed)
        for k in (k1, k2, k3):
            k["launches"] = launches[k["name"]]
        k4["launches"] = phase_survey_path(tmp, path, args.seed)[k4["name"]]
        k5["launches"] = phase_fused_path(cfg, tmp, args.seed)[k5["name"]]
        k6["launches"] = phase_mesh_path(cfg, tmp, path, args.seed,
                                         mle_theta)[k6["name"]]
        order = ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
        kernels = [{key: k[key] for key in order}
                   for k in (k1, k2, k3, k4, k5, k6)]
        print(f"tempered step W={W_SMOKE} K={K_SMOKE}: "
              f"{1e3 * step_ms:.1f} us (plain {1e3 * plain_step_ms:.1f} "
              f"us) on {card}")
        print(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
