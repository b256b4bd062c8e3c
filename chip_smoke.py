"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernels of ``joxsz_torch/csrc`` from source, holds each
against its plain torch version on the card, drives the port's paths on a
synthetic CL J1226-shaped dataset — the flagless fit (``joxsz_torch.run.
main``: MLE, prelim rounds, burn-in and W=1024 x K=4 tempered sampling
with auto-extend, the card's production schedule), the survey fit
(``joxsz_torch.survey.main --mock 4`` at W=1024, 1000 + 1000 steps) and
the fused-likelihood fit (``run.main --fused --no-step-kernel``) — and
checks their output.  Phases:

  1. card name / power limit, kernel build time;
  2. synthetic dataset from ``--seed``, session on ``cuda``, shapes;
  3. kernel 1 vs plain float32 (and plain float64) on 4096 rows, vetoed
     rows included: identical -inf masks, finite values within
     rtol=2e-4, atol=0.5, and within 0.05 of the plain float32 version;
  4. kernels 2 and 3 vs the plain step, step for step on the same
     Philox bits, for 5 steps at W=1024, K=1 (the plain sampler) and 20
     steps at W=1024, K=4 (the tempered one): accept and swap decisions
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
     the same Philox bits at C=4, W=1024 for 5 steps (decisions,
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
     the SZ-core kernel launched.

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
            acck_dec = (acck - acc)[:, mv] > 0.5
            near = margin1.abs() < MARGIN
            check(not bool(((acck_dec != acc1) & ~near).any()),
                  f"K={K}: half-step decisions differ (step {step}, half "
                  f"{which})")
            # against the fully plain step, a decision may flip only where
            # the plain f32 likelihood (one ulp is ~0.004 near 3e4) moves
            # the threshold, by at most beta * TIGHT_ATOL
            both = torch.isfinite(margin) & torch.isfinite(margin1)
            shift = (margin - margin1).abs()
            check(bool((shift[both] <= (beta[:, None] * TIGHT_ATOL
                                        + MARGIN).expand_as(shift)[both])
                       .all()),
                  f"K={K}: plain and kernel-1 likelihoods move a threshold "
                  f"by {float(shift[both].max())}")
            same = (acck_dec == accp)
            n_dec += int(same.numel())
            n_near += int((~same).sum())
            xs, xq = xk[:, mv][same], xp[:, mv][same]
            check(bool(torch.all((xs - xq).abs()
                                 <= 1e-5 * xq.abs() + 1e-12)),
                  f"K={K}: half-step positions differ (step {step})")
            lps, lpq = lpk[:, mv][same], lpp[:, mv][same]
            fin = torch.isfinite(lpq)
            check(torch.equal(torch.isfinite(lps), fin),
                  f"K={K}: half-step lp masks differ")
            check(bool(torch.allclose(lps[fin], lpq[fin], rtol=RTOL,
                                      atol=ATOL)),
                  f"K={K}: half-step lp differ")
            err_half = max(err_half, float((lps[fin] - lpq[fin]).abs().max()))
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

    def start(k):
        x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
            (k, W, D))), dtype=torch.float32, device=dev).contiguous()
        lp = joint_ll(x.reshape(k * W, D), c).reshape(k, W)
        check(bool(torch.isfinite(lp).all()), "non-finite start state")
        return x, lp, torch.zeros((k, W), dtype=torch.float32, device=dev)

    # K=1, the plain sampler of the prelim rounds and burn-in
    x1, lp1, acc1, _, err_half1, _ = compare_steps(
        *start(1), np.ones(1), c, step_seed, STEPS_CMP_K1)
    beta1 = torch.ones(1, dtype=torch.float32, device=dev)
    # K=4, the tempered sampler
    betas = default_betas(K)
    x, lp, acc, sacc, err_half, err_swap = compare_steps(
        *start(K), betas, c, step_seed, STEPS_CMP)
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
              max_abs_err=max(err_half, err_half1), ms=half_ms,
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

    lp_k1 = lambda th: multicluster_ll(th, stack)           # noqa: E731
    beta = torch.ones((C, 1), dtype=torch.float32, device=dev)
    n_dec = n_near = 0
    err_half = 0.0
    for step in range(STEPS_CMP_MC):
        for which in (0, 1):
            b = multicluster_bits(step_seed, dev, step, which, C, H)
            xp, lpp, _, accp, margin = half_step_multicluster_plain(
                x, lp, acc, which, b, stack)
            _, _, _, acc1, margin1 = half_step_multicluster_plain(
                x, lp, acc, which, b, stack, lp_fn=lp_k1)
            xk, lpk, acck = x.clone(), lp.clone(), acc.clone()
            stretch_half_multicluster(xk, lpk, acck, which, step_seed, step,
                                      stack)
            mv = slice(which * H, (which + 1) * H)
            acck_dec = (acck - acc)[:, mv] > 0.5
            near = margin1.abs() < MARGIN
            check(not bool(((acck_dec != acc1) & ~near).any()),
                  f"cluster grid: half-step decisions differ (step {step}, "
                  f"half {which})")
            both = torch.isfinite(margin) & torch.isfinite(margin1)
            shift = (margin - margin1).abs()
            check(bool((shift[both] <= (beta * TIGHT_ATOL + MARGIN)
                        .expand_as(shift)[both]).all()),
                  "cluster grid: plain and kernel-1 likelihoods move a "
                  f"threshold by {float(shift[both].max())}")
            same_dec = (acck_dec == accp)
            n_dec += int(same_dec.numel())
            n_near += int((~same_dec).sum())
            xs, xq = xk[:, mv][same_dec], xp[:, mv][same_dec]
            check(bool(torch.all((xs - xq).abs()
                                 <= 1e-5 * xq.abs() + 1e-12)),
                  f"cluster grid: positions differ (step {step})")
            lps, lpq = lpk[:, mv][same_dec], lpp[:, mv][same_dec]
            fin = torch.isfinite(lpq)
            check(torch.equal(torch.isfinite(lps), fin),
                  "cluster grid: lp masks differ")
            check(bool(torch.allclose(lps[fin], lpq[fin], rtol=RTOL,
                                      atol=ATOL)), "cluster grid: lp differ")
            err_half = max(err_half, float((lps[fin] - lpq[fin]).abs().max()))
            x, lp, acc = xk, lpk, acck
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
    print(f"[8] {STEPS_CMP_MC} steps at C={C}, W={W}: {n_dec} half-step "
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


def all_launches() -> dict:
    from joxsz_torch.ops.joint_kernel import joint_ll
    from joxsz_torch.ops.multicluster_kernel import stretch_half_multicluster
    from joxsz_torch.ops.step_kernel import stretch_half, swap
    from joxsz_torch.ops.sz_core import sz_core

    return {"joint_ll": joint_ll, "stretch_half": stretch_half,
            "swap": swap,
            "stretch_half_multicluster": stretch_half_multicluster,
            "sz_core": sz_core}


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
    return launches, path


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
        del sess, c
        launches, path = phase_main_path(cfg, tmp, args.seed)
        for k in (k1, k2, k3):
            k["launches"] = launches[k["name"]]
        k4["launches"] = phase_survey_path(tmp, path, args.seed)[k4["name"]]
        k5["launches"] = phase_fused_path(cfg, tmp, args.seed)[k5["name"]]
        order = ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")
        kernels = [{key: k[key] for key in order}
                   for k in (k1, k2, k3, k4, k5)]
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
