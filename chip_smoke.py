"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the CUDA kernels of ``joxsz_torch/csrc`` from source, holds each
against its plain torch version on the card, drives the port's paths on a
synthetic CL J1226-shaped dataset — the flagless fit (``joxsz_torch.run.
main``: MLE, prelim rounds, burn-in and W=1024 x K=4 tempered sampling
with auto-extend, the card's production schedule), the survey fit
(``joxsz_torch.survey.main --mock 4`` at W=1024, 1000 + 1000 steps), the
fused-likelihood fit (``run.main --fused --no-step-kernel``), the mesh
fit (``run_fit(mesh=...)`` over four shards, ``run --mesh``, ``survey
--mesh``), the model families' fits (``run.main --pressure knots
--temperature vikhlinin`` at the production schedule, ``--sz-only``, and
the others), the survey of a --spec mixing every family with its
population fit, a fit whose count-rate table is generated on the
card, the Laplace quick-look (``run --laplace``), the evidence ladder, HMC
and NUTS, simulation-based calibration on the cluster-grid kernel and
the emcee shim — and checks their output.  Phases:

  1. card name / power limit, kernel build time;
  2. synthetic dataset from ``--seed``, session on ``cuda``, shapes;
  3. kernel 1 vs plain float32 (and plain float64) on 4096 rows, vetoed
     rows included: identical -inf masks, finite values within
     rtol=2e-4, atol=0.5, and within 0.05 of the plain float32 version;
  4. the step kernel (n steps per cooperative launch: two half-steps and
     the swap sweep per step) vs the plain step, step for step on the
     same Philox bits, at W=1024, K=1 (5 steps, the plain sampler),
     W=1024, K=4 (20 steps, the tempered one) and W=32, K=1 and K=4 (20
     steps, one shard's block on the mesh path): each step a launch of
     that one step from the kernel's state; decisions identical to the
     plain step's on kernel 1's likelihood except where |log u -
     threshold| < 1e-3, and to the fully plain step's except where the
     plain f32 likelihood moves the threshold (by at most 0.05 beta);
     where none lies within 1e-3, state, swap count and frame equal to the
     plain step on kernel 1's likelihood bit for bit; where decisions
     agree with the fully plain step, positions to 1e-5 relative and lp
     within rtol=2e-4, atol=0.5; one launch of all the steps at thin 1
     and thin 5 gives the same state and frames; stored lp equal to a
     fresh kernel-1 evaluation;
  5. the main path, with every launch counter set to 0 just before it:
     acceptance in (0.1, 0.6), finite positive swap rates, exactly one
     step-kernel launch per chunk of steps; the fit's outputs written
     (the chain — HDF5, or its .npz twin without h5py — fit.dat, the
     summary, the state, the figures where matplotlib exists, else
     ``--no-plots`` with a printed line) and the MLE cache entry; the
     mass veto's float64-tier pairs over the fit printed;
 16. (run after phase 5, on its output directory) the same command
     again: the MLE cache hits, theta bit for bit phase 5's, ``mle_s``
     and the wall time cold and warm; ``--resume`` of phase 5's state
     with ``--auto-extend 0``: the K-rung ladder restored, no burn-in in
     the evaluations, nsteps // nthin frames, a first Philox seed none of
     phase 5's; ``--postprocess`` of phase 5's chain with ``--ppc``: the
     summary JSON equal to phase 5's, both p-values in [0, 1], and the
     profile, mass and predictive bands of 4096 draws on the card equal
     to the same draws' on the CPU (both float64) within 1e-6 relative,
     the post-processing seconds; ``--move de`` and ``--move snooker``
     at --quick on the plain sampler: acceptance and evals/s;
  6. the step kernel's times: per step by CUDA events and torch.profiler
     over launches of 100 steps at K=1 (W=1024 and W=32), K=4 and on the
     cluster grid of 4 copies of one cluster's constants (the K=4 step
     without its swap sweep: the sweep's share is the difference), the
     device-busy share, each beside its bound, the grid and shared memory
     per block, ptxas registers, the plain versions' times;
  7. the fused SZ core vs its plain float32 version on 4096 rows drawn as
     phase 3 draws them, with rows whose temperatures leave the
     conversion table and rows holding a NaN: identical NaN masks,
     finite values within rtol=2e-5 of |ll| plus atol=1e-3;
  8. the cluster-grid step kernel vs its plain version, step for step on
     the same Philox bits at C=4, W=1024 and at one mesh shard's block
     (C=1 of the stacked constants) for 5 steps (decisions, state,
     frames, positions, lp as in phase 4; stored lp equal to a fresh
     kernel-1 evaluation per cluster), its time per step over a launch of
     100 steps, and a negative control: the same
     parameters under two clusters' constants give different
     log-posteriors, and the kernel's stored lp of a cluster is not what
     cluster 0's constants would give;
  9. the survey path at full width and depth, launch counters set to 0
     just before: acceptance in (0.1, 0.6) for every cluster, every
     truth within 5 sd of its median, one launch of the cluster-grid
     step kernel each for burn-in and sampling;
 10. the fused-likelihood path at full width and a cut depth (the plain
     sampler loop is host-bound): finite lp, acceptance in (0.1, 0.6),
     the SZ-core kernel launched;
 11. the coupled half-step (kernel 6) at W=1024 and W=128 over 1, 2 and
     4 shards, all on this card, for 5 steps: decisions, positions and
     lp against its plain version as in phase 4; after every step the
     shards' blocks joined equal, bit for bit, the step kernel at K=1 on
     the whole ensemble (so they are equal across shard counts); stored lp
     equal to a fresh kernel-1 evaluation; a wrong row offset changes
     the result; times at 512, 128 and 16 rows per shard;
 13. (run after phase 11) kernels 1, 4, 5, 6 and the step kernel at
     shapes whose constants do not fit in a block's shared memory, as
     phases 3, 4, 7, 8 and 11 check them (``shape_checks``, which phase
     26 runs at other clusters' shapes), on two more synthetic datasets
     of a cluster at z = 0.3: on a 200" map (542 pressure radii, 127 map
     radii: the constants read in place) and integrated out to 20 Mpc
     (2167 pressure radii: the tiles' scratch in global memory too), the
     launch plan checked;
 12. the mesh path at full width, launch counters set to 0 just before:
     ``run_fit`` over a mesh of four shards (all on this card: the entry
     point ``run --mesh 4`` refuses more shards than cards) at W=128,
     untempered, thin 5, which must take the hybrid coupled sampler:
     the declared frame spacing, lp equal to a kernel-1 evaluation of the
     last frame, acceptance in (0.1, 0.6), one step-kernel launch per
     window and shard and two of kernel 6; the coupled sampler alone for
     its time per step; three short fits over four shards on this card
     with exact launch counts: ``run_fit`` at a layout the per-shard
     sampler declines (the coupled sampler, kernel 6, never the plain
     step), a tempered ``run_fit`` (one step-kernel launch per chunk and
     shard; the runner equal to per-block runs, bit for bit) and
     ``fit_survey`` over a ``cluster`` mesh (one launch of kernel 4 per
     call and shard; every shard equal to its block run alone, bit for
     bit);
     ``run --mesh 1`` and ``survey --mock 4 --mesh 1`` through their
     entry points.

 14. (run after phase 13) every model family of the likelihood (knot
     pressure, Vikhlinin temperature, double density, line_scale,
     SZ-only, config #4 = knots + Vikhlinin T, and all four at once),
     each a session of the synthetic dataset built as ``run`` builds it
     from the family's flags: kernel 1 on 4096 rows around ``synth.
     truth_theta`` as phase 3 checks it (with rows vetoed by the box, by
     r_c > r_s and by the mass veto, and rows colder and hotter than the
     count-rate table's grid), the step kernel at K=1 and K=4, W=1024 for
     5 steps as phase 4 checks it, and for config #4 kernel 6 over 2
     shards as phase 11 checks it; their times beside their bounds;
 15. (run after phase 12) the families' fits through ``run.main`` with
     their flags, one child process each, all at once, launch counters
     set to 0 just before each fit and read just after: config #4 and
     SZ-only at the production schedule (config #4 with --auto-extend 15
     must reach split-R-hat <= 1.01), config #4 over a mesh of one card
     at 32 walkers (below 2 D + 2: the coupled sampler, kernel 6), the
     other families --quick at W=1024 x K=4; finite chains, acceptance in
     (0.02, 0.6), exactly one step-kernel launch per chunk; each fit's
     mass-veto float64-tier pairs printed;
 17. the families on the survey's cluster grid (its kernel checks run
     after phase 14, the survey after phase 15): for every family of
     phase 14 but the widest, kernel 4's family
     instance on 4 clusters simulated from the family's model (distinct
     data, shared grids) against its plain step for 5 steps as phase 8
     checks the flagship's, and its time per launch of 20 steps at
     W=1024 beside its bound; then, launch counters set to 0 just before,
     ``survey.main`` on a --spec mixing gnfw and those six families (4
     clusters each, each its own dataset simulated from its family's
     model), W=1024, 1000 burn + 1000 steps, --save-chains, with the
     survey's fallback warning raised as an error: two launches of kernel
     4 per family, every truth within 5 sd of its median, acceptance in
     (0.02, 0.6), a chain file per cluster; and ``--mock 8 --population
     P_0``: the population block written, its mean among the clusters';
 18. the count-rate table of a synthetic 1000 x 1024 response generated
     on the card against the CPU (rtol 1e-10), both timed; a synthetic
     cluster at z = 0.5 with no table_path fitted through ``run.main
     --quick``: its table generated on the card into a temporary tables
     directory, then the fit.
 19. ``run --laplace`` through ``run.main`` on phase 5's config: the JSON
     keys of the JAX package's quick-look, the card's float64 Hessian at
     the MAP against the host CPU's (each element within rtol 1e-8), ok,
     the pinned parameters, the Laplace sd beside phase 5's posterior sd;
 20. ``model_evidence`` on the card for gNFW and knots on the same data
     (K=8 x W=128, 200 + 200 steps, thin 5): log Z and its error finite,
     every bridge's swap acceptance > 0, the time per ladder step;
 21. ``run_hmc`` and ``run_nuts`` on the flagship's float64 posterior from
     a 1% cloud around phase 5's MLE (32 chains, short warmups): the
     acceptance statistic in [0.5, 0.98], a finite step size, gradients
     per second;
 22. ``run_sbc`` on the card through kernel 4 (16 replications x W=256,
     500 + 500 steps, thin 50, on the JAX SBC test's box; its launches
     join kernel 4's entry): no StackMismatch and no warning, ranks in
     [0, L], thetas_true bit for bit the host CPU's, the p-values; kernel
     4 against its plain step for 5 steps on run_sbc's stack and kernel 1
     against its plain version at its init state; run_sbc's two float32
     checks on both boxes (``float32_vetoed``: no draw lost on either;
     ``float32_misfits`` on 64 replications' mock data), and run_sbc on
     the production box refused on its mock data; then
     ``EnsembleSampler(vectorize=True)`` on the model's ``log_like_batch``
     for 200 steps on the card.
 23. (its kernels right after phase 17's kernels, its CLI run after
     phase 22) the hashed-roll partner law
     ('auto' above 4096 walkers per rung): the step kernel at K=1, W=8192 and K=4 x W=8192 against its plain
     step for 5 steps as phase 4 holds it, kernel 6 under roll over 2
     shards as phase 11 holds it (bit for bit the K=1 roll step); one
     launch of 100 steps at K=1, W=65536 (the JAX package's headline
     shape) and at K=4, W=8192 under each law, beside the bound and the
     plain version; ``run --walkers 8192 --quick`` through ``run.main``
     with the launch counters set to 0 just before: the route printed as
     roll, every step-kernel launch a roll one;
 24. two processes on this card (``parallel.multihost``, gloo):
     ``survey --mock 4 --walkers 1024 --burn 1000 --steps 1000
     --multihost-launch 2``, kernel 4 twice per worker, the assembled
     medians, sds and acceptances bit for bit ``fit_survey`` over a
     2-shard cluster mesh on [cuda:0, cuda:0], every truth within 5 sd;
     the coupled sampler at W=128 across the two processes bit for bit
     one process with 2 shards (with four cards, the survey at 2 workers
     x 2 cards, --mock 8, against a 4-card mesh).
 25. the posterior-level referee (``tests/torch_parity.py``) on phase 2's
     dataset, the launch counters set to 0 just before it: an independent
     numpy stretch sampler on kernel 1 against the step kernel at K=1
     (one-hot), at K=4 (``default_betas(4)``, the cold rung) and at K=1
     under the roll law, each arm within the calibrated MED_BAND and
     WIDTH_BAND, the broken-move control ((d-1) -> (d+1)) outside
     WIDTH_BAND, kernel 1 and the step kernel under both laws launched;
     then ``examples/torch_*.py --smoke`` on the card in child processes.
 26. other clusters and instruments: every kernel at the eight corners of
     ``synth.CORNERS`` (the JAX geometry sweep's six: table nT 32 / 96,
     24 annuli x 12 bands, a large map, 5 knots, double density, SZ-only;
     line_scale and config #4 at other band and annulus counts) and for
     every family of phase 14 at phase 13's two shapes (the ``*_fam_
     large_kernel`` instances), each held as phase 13 holds its shapes
     (``shape_checks``: kernel 1 on 1024 rows, the step kernel at K=1 and
     K=4, kernel 4 on two clusters, kernel 5 where the corner is joint,
     kernel 6 over 2 shards; thresholds within twice TIGHT_RTOL |lp|
     where lp passes TIGHT_BELOW), the launch plan the card takes checked
     against the host's mirror (``consts_layout.launch_plan``); the veto
     clouds of ``tests/test_torch_precision.py`` through kernel 1 against
     the plain float32 version and the float64 model (no flip against
     either; row 200 of the flagship's 0.2 cloud kept); 4096 draws of the
     production prior box (1024 for knots; a dataset out to 5008 kpc)
     through kernel 1's flagship and family instances for four families
     against the float64 model, no row lost, near-ties included (the
     lost rows printed by cause; Vikhlinin row 2993 printed); near-tie
     rows (``ops.mass_veto.near_tie_rows``, float64 margins 1e-4 down to
     ~1e-9, four families, and two at phase 13's first shape) through
     kernel 1 and the tile of the step kernel (K=1, and K=4 with every
     rung holding the rows), kernel 4 and kernel 6 in each of their
     instances, every verdict the float64 model's, with the
     float64-tier pairs counted; the knots corner
     written by ``python -m joxsz_torch.synth`` and fitted by ``run
     --config <it> --quick --no-plots`` in a child process (W=1024 x
     K=4: finite medians, fit.dat, the family instances launched); and
     each of the 14 compiled instances (``ops._build.
     INSTANCES``) launched at least once over the run.

Prints the kernel JSON line (the six kernels on the flagship's paths,
then each kernel for each family, "name[family]", kernel 4's family
instance, then the step kernel's roll-law rows "name[roll]"), the card
line, and as the last line
``{"ok": true, "device": {...}}``; exits non-zero, with no result line,
when a phase fails or no GPU is visible.  The MLE cache entries the run
writes (``data/cache/mle_torch_*.json``) are removed at its end.

    python3 chip_smoke.py [--seed N] [--only 13,14,17,22,23,24,25,26]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import re
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
STEPS_CMP_LARGE = 5             # phase 13: steps at the larger shapes
# phase 13: (outermost SZ radius ", extent kpc) of a cluster at z = 0.3
LARGE_SHAPES = ((200.0, 5000.0), (118.0, 20000.0))
TIME_STEPS = 100                # steps per timed launch: one chunk
# the model families (phases 14-15): tag, the run flags that select it,
# the thawed D on the synthetic CL J1226 (7 pressure knots), and how
# phase 15 fits it: "production" (the card's production schedule), "mesh"
# (--quick over a mesh of one card at 32 walkers, below 2 D + 2: the
# coupled sampler, kernel 6) or "quick" (--quick at W=1024 x K=4)
KNOTS_VIKH = ("--pressure", "knots", "--temperature", "vikhlinin")
FAMILIES = (
    ("knots", ("--pressure", "knots"), 16, "quick"),
    ("vikhlinin_T", ("--temperature", "vikhlinin"), 18, "quick"),
    ("double_density", ("--density", "double"), 16, "quick"),
    ("line_scale", ("--line-systematic",), 14, "quick"),
    ("sz_only", ("--sz-only",), 10, "production"),
    ("config4", KNOTS_VIKH, 21, "production"),
    ("widest", KNOTS_VIKH + ("--density", "double", "--line-systematic"),
     25, "quick"),
)
FAMILY_MESH_FIT = ("config4_mesh", KNOTS_VIKH, 21, "mesh")
FAMILY_MESH_W = 32              # phase 15: walkers of the mesh fit
# phase 15: config #4's extension budget: its tau is ~2300 steps on the
# synthetic data (20 tau ~ 46 k steps, 6 production chunks)
CONFIG4_EXTEND = 15
# phase 15: the families' acceptance bar; the SZ-only posterior is wide
# and walled by its prior boxes (0.066 at the production schedule); a
# broken sampler accepts nothing, or nearly everything
FAMILY_ACCEPTANCE = (0.02, 0.6)
STEPS_CMP_FAM = 5               # phase 14: steps held against the plain
TIME_STEPS_FAM = 20             # phase 14: steps per timed launch
TIGHT_BELOW = 1e5               # phase 14: |ll| under which TIGHT_ATOL holds
# above TIGHT_BELOW, the same number of float32 ulps as TIGHT_ATOL there,
# relative (phase 22: mocks with bright X-ray data put lp near 5e5)
TIGHT_RTOL = TIGHT_ATOL / TIGHT_BELOW
FAMILY_FIT_TIMEOUT = 600        # phase 15: seconds a family fit may take
# phase 17: the families of the mixed --spec survey (tag, run flags)
SURVEY_MIX = (("gnfw", ()),) + tuple((t, f) for t, f, _, _ in FAMILIES
                                      if t != "widest")
# phase 16: rows of the phase-5 chain whose profile bands are computed on
# the card and on the CPU, both float64 sessions; their relative gap is
# the two devices' last-bit rounding, far below PROFILE_RTOL
PROFILE_ROWS, PROFILE_RTOL = 4096, 1e-6
OUTPUTS = ("chain", "fit.dat", "summary", "state")     # phase 5's files
# phase 19: the keys of the JAX package's <name>_laplace.json
# (joxsz_tpu/run.py:_laplace_quicklook), and the card's float64 Hessian
# against the host CPU's
LAPLACE_KEYS = ("ok", "theta_map", "sd", "sd_conditional", "at_boundary",
                "eigenvalues_negH", "log_post_map", "log_z",
                "log_z_normalized", "prior_log_norm", "prior_log_norm_err")
LAPLACE_RTOL = 1e-8
# phase 20: the ladder's rungs, walkers, burn, steps, thin (cut from the
# JAX defaults 16 x 128, 2000 + 2000, thin 10)
EVIDENCE = (8, 128, 200, 200, 5)
# phase 21: chains; HMC warmup, steps, leapfrogs; NUTS warmup, steps,
# max depth (the JAX defaults: 500 warmup, 16 leapfrogs, depth 8)
HMC_CUT = (32, 100, 100, 10, 50, 40, 5)
ACCEPT_BAND = (0.5, 0.98)
# phase 22: SBC replications, walkers, burn, steps, thin (the JAX
# defaults: 64 walkers, 2000 + 500, thin 50); the emcee shim's run
SBC_CUT = (16, 256, 500, 500, 50)
# phase 22: the box of the JAX package's SBC smoke test on the joint model
# (tests/test_sbc.py), around the CL J1226 posterior.  The float32
# kernels' mass veto covers the production box too (it forms n_e from ln
# n_e^2 and compares a scaled mass; the JAX package's interpret-mode
# kernel does not), but the mock data of its corners pass float32's
# precision, so run_sbc refuses it (SBC_PROD_REPS replications)
SBC_BOX = {"log(n_0)": (-1.55, -1.25), r"\beta": (0.58, 0.72),
           "log(r_c)": (1.85, 2.2), "log(r_s)": (2.2, 3.4),
           r"\epsilon": (0.0, 2.0), "log(T_X/T_{SZ})": (-0.2, 0.3),
           "Z": (0.0, 0.6), "P_0": (0.1, 0.4), "a": (0.8, 5.0),
           "b": (2.0, 4.0), "r_p": (110.0, 350.0)}
SBC_PROD_REPS = 2
SBC_MOCKS = 64                  # replications float32_misfits checks
EMCEE_W, EMCEE_STEPS = 64, 200
# phase 23: walkers per rung where 'auto' takes the roll law, the JAX
# package's headline width (bench.py), and the steps held against plain
W_ROLL, W_ROLL_TIME, STEPS_CMP_ROLL = 8192, 65536, 5
# phase 24: coupled steps across processes; seconds the children may take
MH_COUPLED_STEPS, MULTIHOST_TIMEOUT = 50, 600


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


# torch.profiler drops a kernel whose span it places outside its capture
# window, and it places the card's timestamps off the host's by a
# different amount in each session: a kernel up to 3.1 ms before its own
# launch, the host's return from the synchronisation up to 22 ms after
# the kernel's end; and some sessions record no kernel at all, most after
# the card sat idle (scripts/torch_profiler_window.py, one 40 ms launch a
# session, results/torch_profiler_window.log: 4 of 120 sessions made back
# to back, 16 of 24 made after 20 s idle, with the window held open 50 ms
# around the launch as often as not).  So a session stays open
# PROFILE_PAD_S around its launches, and one that recorded no kernel of
# the wanted name is made again with the window held open 4x longer, up
# to PROFILE_TRIES sessions (5.12 s at the last)
PROFILE_PAD_S, PROFILE_TRIES = 0.02, 5


def device_time_per_launch(fn, reps: int, want: str = ""):
    """({kernel name: device microseconds per launch}, device-busy share
    of the wall time) over ``reps`` calls of ``fn``, from torch.profiler's
    trace of the card, from the first of up to PROFILE_TRIES sessions that
    recorded a kernel whose name starts with ``want``; ({}, None) when
    none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(PROFILE_TRIES):
        pad = PROFILE_PAD_S * 4 ** i
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
            time.sleep(pad)
        per, total = {}, 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            # device events carry the demangled signature: "name(float*,
            # ...)"; a family's kernel ("x_fam_kernel") counts under its
            # name "x_kernel"
            name = e.key.split("(")[0].replace("_fam_", "_")
            if us > 0 and name.endswith("_kernel"):
                per[name] = us / e.count
                total += us
        if any(k.startswith(want) for k in per):
            if i:
                print(f"    (the profiler recorded {want or 'a kernel'} "
                      f"in session {i + 1}, the window open {1e3 * pad:.0f}"
                      " ms around the launches)")
            return per, total / wall_us
    print(f"    (the profiler recorded no {want or 'kernel'} in "
          f"{PROFILE_TRIES} sessions, the window open up to "
          f"{1e3 * pad:.0f} ms around the launches)")
    return {}, None


def busy_text(busy) -> str:
    return "not measured" if busy is None else f"{100 * busy:.1f}%"


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
        fn = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                # the mangled name: _Z<length><name>...
                m = re.search(r"_Z(\d+)(\w+)", line)
                fn = m.group(2)[:int(m.group(1))] if m else line.split()[-1]
            elif "registers" in line or "spill" in line:
                print(f"    {name}: {fn}: {line.strip()}")
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


def check_joint(sess, c, seed: int, n: int):
    """Kernel 1 on n rows (ll_rows) against the plain float32 and float64
    versions.  Returns (float32 rows, max |err| vs plain f32, vs plain
    f64, vetoed rows)."""
    return check_joint_rows(sess, c, ll_rows(sess, seed, n))


def check_joint_rows(sess, c, rows64, tight_below: float = math.inf):
    """Kernel 1 on the (n, D) float64 rows ``rows64``, a sixteenth of
    them vetoed each by the box, by r_c > r_s and by the HSE mass, against
    the plain float32 and float64 versions: identical -inf masks, finite
    values within RTOL / ATOL, and within TIGHT_ATOL of plain f32 where
    |log-posterior| < ``tight_below`` (far below the posterior's peak,
    blown-up Cash terms of 1e6 and more, one float32 ulp of the sum is
    itself 0.06 or more)."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain

    n = rows64.shape[0]
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
    check(n_veto >= 3 * n // 16, f"only {n_veto} vetoed rows")
    near = fin & (np.abs(p) < tight_below)
    gap = np.abs(k - p)
    # where every row is past tight_below (a bright cluster), the largest
    # gap of all, held to RTOL / ATOL only
    err32 = float(np.max(gap[near if near.any() else fin]))
    err64 = float(np.max(np.abs(k[fin] - f64[fin])))
    worst = int(np.argmax(np.where(near, gap, -1.0)))
    check(np.allclose(k[fin], p[fin], rtol=RTOL, atol=ATOL),
          f"kernel 1 vs plain f32: max abs err "
          f"{float(np.max(gap[fin]))}")
    check(not near.any() or err32 < TIGHT_ATOL,
          f"kernel 1 vs plain f32: max abs err {err32} "
          f">= {TIGHT_ATOL} (row {worst}: kernel {k[worst]}, plain f32 "
          f"{p[worst]}, plain f64 {f64[worst]})")
    check(np.allclose(k[fin], f64[fin], rtol=RTOL, atol=ATOL),
          f"kernel 1 vs plain f64: max abs err {err64}")
    return rows, err32, err64, n_veto


def phase_joint(sess, c, seed: int) -> dict:
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_plain,
                                              joint_ll_flops, joint_ll_bytes)

    rows, err32, err64, n_veto = check_joint(sess, c, seed, B_LL)
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


def compare_fused(what: str, x, lp, acc, n_steps: int, plain_half,
                  kernel, tol, swaps_ref=None):
    """The step kernel against its plain step, step for step from state x
    (G, W, D), lp/acc (G, W) on the same Philox bits.

    Step s runs as a launch of one step (``kernel(x, lp, acc, step0=s,
    n_steps=1, thin=1)`` -> (frames (Gs, 1, W, D), frames_lp, swaps
    accepted)) from the kernel's own state, against the plain step from
    the same state: ``plain_half(x, lp, acc, which, step, k1)`` (on
    kernel 1's likelihood when ``k1``, else on the plain f32 one) and, for
    rungs, ``swaps_ref(x, lp, step)`` -> (x, lp, [accept], [margin]).
    Decisions must equal the kernel-1 step's except within MARGIN of a
    threshold; unless such a decision went the other way, the kernel's
    state, frame and swap count equal the kernel-1 step's bit for bit;
    against the fully plain step thresholds move by at most ``tol`` +
    MARGIN, positions agree to 1e-5 relative and lp within RTOL / ATOL
    where decisions do.
    Then one launch of all n_steps at thin 1 and at thin 5 must give the
    same frames and state as the launches of one step.  Returns (final x,
    lp, acc, decisions, steps where a near-threshold decision flipped,
    differences from the fully plain step, largest lp error, swaps)."""
    import torch

    x0, lp0, acc0 = x.clone(), lp.clone(), acc.clone()
    G, W, _ = x.shape
    H = W // 2
    n_dec = n_near_steps = n_diff = 0
    err = 0.0
    frames, n_swaps = [], 0
    for step in range(n_steps):
        xr, lr, ar = x, lp, acc
        halves = []
        for which in (0, 1):
            xp, lpp, _, accp, margin = plain_half(xr, lr, ar, which, step,
                                                  False)
            xr, lr, ar, acc1, margin1 = plain_half(xr, lr, ar, which, step,
                                                   True)
            halves.append((which, xr, lr, accp, margin, xp, lpp, acc1,
                           margin1))
        sw_acc, near_swap = 0, False
        if swaps_ref is not None:
            xr, lr, accs, margins = swaps_ref(xr, lr, step)
            sw_acc = sum(int(a.sum()) for a in accs)
            near_swap = any(bool((m.abs() < MARGIN).any()) for m in margins)
        xk, lk, ak = x.clone(), lp.clone(), acc.clone()
        fr, fr_lp, nsw = kernel(xk, lk, ak, step, 1, 1)
        dec = (ak - acc) > 0.5
        for which, xh, lh, accp, margin, xp, lpp, acc1, margin1 in halves:
            mv = slice(which * H, (which + 1) * H)
            nd, nn, e = check_half_against_plain(
                f"{what}, step {step}, half {which}", dec[:, mv], xh[:, mv],
                lh[:, mv], (xp[:, mv], lpp[:, mv], accp, margin),
                (acc1, margin1), tol)
            n_dec, n_diff, err = n_dec + nd, n_diff + nn, max(err, e)
            flipped = not torch.equal(dec[:, mv], acc1)
            if flipped:
                break       # a near-threshold flip: half 1 saw another state
        same = (torch.equal(xk, xr) and torch.equal(lk, lr)
                and torch.equal(ak, ar) and nsw == sw_acc)
        if flipped or (near_swap and not same):
            n_near_steps += 1
        else:
            check(same, f"{what}, step {step}: the kernel's state differs "
                  "from the plain step on kernel 1's likelihood")
        cold = xk if fr.shape[0] == G else xk[:1]
        check(torch.equal(fr[:, 0], cold) and torch.equal(
            fr_lp[:, 0], (lk if fr.shape[0] == G else lk[:1])),
            f"{what}, step {step}: the frame is not the state")
        frames.append((fr[:, 0].clone(), fr_lp[:, 0].clone()))
        n_swaps += nsw
        x, lp, acc = xk, lk, ak
    for thin in (1, 5):
        if n_steps % thin:
            continue
        xl, ll, al = x0.clone(), lp0.clone(), acc0.clone()
        fr, fr_lp, nsw = kernel(xl, ll, al, 0, n_steps, thin)
        check(torch.equal(xl, x) and torch.equal(ll, lp)
              and torch.equal(al, acc) and nsw == n_swaps,
              f"{what}: one launch of {n_steps} steps differs from "
              "launches of one step")
        for f in range(n_steps // thin):
            got = frames[(f + 1) * thin - 1]
            check(torch.equal(fr[:, f], got[0])
                  and torch.equal(fr_lp[:, f], got[1]),
                  f"{what}: frame {f} at thin {thin} differs")
    check(float(acc.mean()) > 0, f"{what}: no move was accepted")
    check(swaps_ref is None or G == 1 or n_swaps > 0,
          f"{what}: no swap was accepted")
    return x, lp, acc, n_dec, n_near_steps, n_diff, err, n_swaps


def compare_steps(x, lp, acc, betas, c, step_seed: int, n_steps: int,
                  tag: str = "[4]", tol: float = TIGHT_ATOL):
    """Phase 4: the step kernel on rung state x (K, W, D) at inverse
    temperatures ``betas`` against the plain step (``compare_fused``; the
    plain float32 likelihood may move a threshold by beta ``tol``), both
    under the partner law 'auto' takes at W (one-hot up to 4096 walkers
    per rung, the hashed roll above: phase 23).  Returns the final state
    and the largest lp error."""
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import (half_step_plain, philox_stream,
                                             resolve_partner, roll_shifts,
                                             stretch_steps, swap_plain)
    from joxsz_torch.sampling.kernel import rung_tensors

    K, W, D = x.shape
    H = W // 2
    law = resolve_partner("auto", W)
    beta, db = rung_tensors(betas, c.device)
    dbs = db.tolist()
    bits = philox_stream(step_seed, c.device)
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    lp_k1 = lambda th: joint_ll(th, c)                    # noqa: E731

    def plain_half(x, lp, acc, which, step, k1):
        return half_step_plain(x, lp, acc, beta, which,
                               bits(step, which, K * H, 4),
                               lp_k1 if k1 else lp_fn,
                               roll_shifts(law, step_seed, step, which, K, H))

    def swaps_ref(x, lp, step):
        accs, margins = [], []
        for kk in range(K - 1):
            u = torch.stack([bits(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                             for hb in (0, 1)])
            x, lp, a, m = swap_plain(x, lp, kk, step_seed, step, u, dbs[kk])
            accs.append(a)
            margins.append(m)
        return x, lp, accs, margins

    def kernel(x, lp, acc, step0, n, thin):
        sacc = torch.zeros(max(K - 1, 1), dtype=torch.int32, device=c.device)
        fr, fr_lp = stretch_steps(x, lp, acc, sacc, beta, db, step_seed, n,
                                  c, thin=thin, step0=step0)
        return fr[None], fr_lp[None], int(sacc[:K - 1].sum())

    x, lp, acc, n_dec, n_near, n_diff, err, n_swaps = compare_fused(
        f"K={K}, W={W}", x, lp, acc, n_steps, plain_half, kernel,
        beta[:, None] * tol, swaps_ref if K > 1 else None)
    torch.cuda.synchronize()
    fresh = joint_ll(x.reshape(K * W, D), c).reshape(K, W)
    check(torch.equal(fresh, lp), f"K={K}: stored lp differs from a fresh "
          "kernel-1 evaluation")
    print(f"{tag} {n_steps} steps at W={W}, K={K} ({law} law): {n_dec} "
          f"half-step decisions, {n_diff} differ from the fully plain step, "
          f"{n_near} "
          f"steps where a decision within {MARGIN} of its threshold went "
          "the other way, "
          f"{n_swaps} swaps; state == the plain step on kernel 1's "
          f"likelihood elsewhere; one launch of {n_steps} steps at thin 1 "
          f"and 5 == launches of one step; max |lp err| {err:.4g}; stored "
          "lp == fresh kernel 1")
    return x, lp, acc, err


def steps_bound(c, K: int, W: int, n: int) -> float:
    """Bound ms of one launch of n steps at (K, W): the likelihood of K W
    evaluations a step (operations), or the state read and written once
    and the constants read once, whichever is longer."""
    from joxsz_torch.ops.joint_kernel import joint_ll_flops

    D = c.ints["D"]
    flops = joint_ll_flops(c) * K * W * n
    nbytes = 4 * (2 * K * W * (D + 2) + K + c.buf.numel())
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)


def phase_steps(sess, c, seed: int) -> tuple[dict, dict, float, float]:
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.sampling.tempered import default_betas
    from joxsz_torch.synth import TRUTH

    K, W, D = K_SMOKE, W_SMOKE, c.ints["D"]
    dev = c.device
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
    err1 = compare_steps(*start(1), np.ones(1), c, step_seed,
                         STEPS_CMP_K1)[3]
    # K=4, the tempered sampler
    betas = default_betas(K)
    err4 = compare_steps(*start(K), betas, c, step_seed, STEPS_CMP)[3]
    # the shapes the mesh path gives the step kernel: one shard's block of
    # W_MESH / N_SHARDS walkers, plain and tempered
    w_loc = W_MESH // N_SHARDS
    err_mesh = max(
        compare_steps(*start(1, w_loc), np.ones(1), c, step_seed,
                      STEPS_CMP)[3],
        compare_steps(*start(K, w_loc), betas, c, step_seed, STEPS_CMP)[3])
    return dict(err1=max(err1, err_mesh), err4=max(err4, err_mesh),
                start=start, step_seed=step_seed, betas=betas)


def phase_step_times(sess, c, st: dict) -> tuple[dict, dict, dict]:
    """Phase 6: the step kernel's times on the card beside its bounds."""
    import numpy as np
    import torch
    from joxsz_torch.models.multicluster import (stack_sz_data,
                                                 stack_xray_data)
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts_stack
    from joxsz_torch.ops.multicluster_kernel import stretch_steps_multicluster
    from joxsz_torch.ops.step_kernel import (philox_stream, step_kernel_config,
                                             steps_plain, stretch_steps)
    from joxsz_torch.sampling.kernel import rung_tensors

    card = card_line()
    W, K, n = W_SMOKE, K_SMOKE, TIME_STEPS
    start, step_seed = st["start"], st["step_seed"]
    dev = c.device
    for line in _build.BUILD_INFO.get("ptxas", {}).get("stretch_step",
                                                        "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[6] ptxas, stretch_step: {line.strip()}")
    rows = {}

    def run_rungs(k, w, betas):
        x, lp, acc = start(k, w)
        beta, db = rung_tensors(betas, dev)
        sacc = torch.zeros(max(k - 1, 1), dtype=torch.int32, device=dev)
        return (lambda: stretch_steps(x, lp, acc, sacc, beta, db, step_seed,
                                      n, c)), (x, lp, acc, beta, db)

    def timed(label, fn, k, w):
        ms = cuda_ms(fn, reps=5, warmup=1)
        dev_us, busy = device_time_per_launch(fn, reps=5,
                                              want="stretch_steps_kernel")
        us = dev_us.get("stretch_steps_kernel")
        blocks, smem, _, _ = step_kernel_config(c, k, w)
        step_us = us / n if us else float("nan")
        bound = steps_bound(c, k, w, n) / n * 1e3
        print(f"[6] {label}: {1e3 * ms / n:.2f} us per step by CUDA events, "
              + (f"{step_us:.2f} us of device time ({step_us / 2:.2f} us per "
                 f"half-step of {k * w // 2} rows)" if us else
                 "device time not measured")
              + f", device busy {busy_text(busy)}; bound {bound:.2f} us per "
              f"step (operations); grid {blocks} blocks x 512 threads, "
              f"{smem} B of shared memory per block; {card}")
        rows[label] = dict(ms=ms, step_us=step_us, busy=busy, bound_us=bound)
        return ms

    fn1, _ = run_rungs(1, W, np.ones(1))
    timed(f"K=1, W={W}", fn1, 1, W)
    fn16, _ = run_rungs(1, W_MESH // N_SHARDS, np.ones(1))
    timed(f"K=1, W={W_MESH // N_SHARDS}", fn16, 1, W_MESH // N_SHARDS)
    fn4, st4 = run_rungs(K, W, st["betas"])
    ms4 = timed(f"K={K}, W={W}", fn4, K, W)
    # the same 2048 moving rows a half-step on the cluster grid of K
    # copies of one cluster's constants: the K=4 step without its sweep
    m = sess.model
    copies = pack_consts_stack(sess, stack_sz_data([m.sz_data] * K),
                               stack_xray_data([m.xray_data] * K))
    xc, lpc, accc = start(K)
    fnc = lambda: stretch_steps_multicluster(          # noqa: E731
        xc, lpc, accc, step_seed, n, copies)
    msc = timed(f"C={K} copies, W={W}", fnc, K, W)
    share = rows[f"K={K}, W={W}"]["step_us"] - rows[
        f"C={K} copies, W={W}"]["step_us"]
    print(f"[6] swap sweep: {share:.2f} us of device time per K={K} step "
          f"({100 * share / rows[f'K={K}, W={W}']['step_us']:.1f}%), the "
          f"K={K} rung launch less the same 2048-row half-steps on the "
          f"cluster grid (CUDA events: {1e3 * (ms4 - msc) / n:.2f} us)")
    # plain versions of the same launches
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731

    def plain(k, w, betas, n_p):
        x, lp, acc = start(k, w)
        beta, db = rung_tensors(betas, dev)
        return cuda_ms(lambda: steps_plain(
            x, lp, acc, beta, db.tolist(), step_seed, n_p,
            philox_stream(step_seed, dev), lp_fn), reps=1, warmup=0)

    plain1 = plain(1, W, np.ones(1), n)
    plain4 = plain(K, W, st["betas"], n)
    out1 = dict(name="stretch_steps", route="cuda",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1242",
                max_abs_err=st["err1"], ms=rows[f"K=1, W={W}"]["ms"],
                plain_ms=plain1, bound_ms=steps_bound(c, 1, W, n),
                bound_by="operations", library_ms=None)
    out4 = dict(name="stretch_steps_tempered", route="cuda",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:2105",
                max_abs_err=st["err4"], ms=ms4, plain_ms=plain4,
                bound_ms=steps_bound(c, K, W, n), bound_by="operations",
                library_ms=None)
    return out1, out4, rows


def check_sz_core(cfg, sess, seed: int, n: int, rows64=None):
    """Kernel 5 on n rows drawn as ``ll_rows`` draws them (or the float64
    parameter rows ``rows64`` of the session's family), with rows whose
    temperatures leave the conversion table and rows holding a NaN,
    against its plain float32 and float64 versions.  Returns (constants,
    (pp, t_all, cal), max |err| vs plain f32, its relative size, rel err vs
    plain f64, NaN rows, rows outside the table)."""
    import numpy as np
    import torch
    from joxsz_torch.io.readers import read_conversion_table, read_xy
    from joxsz_torch.ops.sz_core import make_sz_core, sz_core, sz_core_plain

    m = sess.model
    sz = m.sz_data
    core = make_sz_core(sess.sz_operator,
                        read_conversion_table(cfg.sz.conversion_file),
                        *read_xy(cfg.sz.flux_file, ncol=3)[1:], device="cuda")
    c = core.consts
    if rows64 is None:
        rows64 = ll_rows(sess, seed, n)
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
    check(int(nan.sum()) >= 2 * (n // 64), f"only {int(nan.sum())} NaN "
          "rows")
    check(n_tab >= n // 16, f"only {n_tab} rows leave the table")
    fin = ~nan
    check(np.all(np.isfinite(k[fin])), "SZ core: non-finite value")
    err = float(np.max(np.abs(k[fin] - p[fin])))
    rel = float(np.max(np.abs(k[fin] - p[fin]) / (np.abs(p[fin]) + 1e-30)))
    err64 = float(np.max(np.abs(k[fin] - p64[fin])
                         / (np.abs(p64[fin]) + 1e-30)))
    check(np.allclose(k[fin], p[fin], rtol=SZ_RTOL, atol=SZ_ATOL),
          f"SZ core vs plain f32: max abs err {err}, max rel err {rel}")
    return c, (pp, t_all, cal), err, rel, err64, int(nan.sum()), n_tab


def phase_sz_core(cfg, sess, seed: int) -> dict:
    """Phase 7: kernel 5 (the fused SZ core) vs ``sz_core_plain``."""
    import torch
    from joxsz_torch.ops.sz_core import (sz_core, sz_core_plain,
                                         sz_core_flops, sz_core_bytes)

    c, (pp, t_all, cal), err, rel, err64, n_nan, n_tab = check_sz_core(
        cfg, sess, seed, B_LL)
    ms = cuda_ms(lambda: sz_core(pp, t_all, cal, c), reps=50)
    plain_ms = cuda_ms(lambda: sz_core_plain(pp, t_all, cal, c), reps=10)
    dev_us, _ = device_time_per_launch(lambda: sz_core(pp, t_all, cal, c),
                                       reps=100, want="sz_core_kernel")
    flops = sz_core_flops(c) * B_LL
    nbytes = sz_core_bytes(c, B_LL)
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
    dev = (f"{dev_us['sz_core_kernel']:.2f} us on the device"
           if "sz_core_kernel" in dev_us else "device us not measured")
    print(f"[7] SZ core on {B_LL} rows ({n_nan} NaN, {n_tab} "
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


def compare_cluster_grid(x, lp, acc, stk, step_seed: int, n_steps: int,
                         tol=TIGHT_ATOL):
    """n_steps steps of the cluster-grid step kernel on the stacked
    constants ``stk`` from (x, lp, acc) against the plain step
    (``compare_fused``; ``tol``: how far the plain float32 likelihood may
    move a threshold, a float or (C, 1)).  Returns (x, lp, acc,
    decisions, near-threshold steps, largest lp error)."""
    import torch
    from joxsz_torch.ops.multicluster_kernel import (
        half_step_multicluster_plain, multicluster_bits, multicluster_ll,
        stretch_steps_multicluster)

    n_c, H, dev = stk.n_clusters, x.shape[1] // 2, x.device
    lp_k1 = lambda th: multicluster_ll(th, stk)           # noqa: E731

    def plain_half(x, lp, acc, which, step, k1):
        b = multicluster_bits(step_seed, dev, step, which, n_c, H)
        return half_step_multicluster_plain(
            x, lp, acc, which, b, stk, lp_fn=lp_k1 if k1 else None)

    def kernel(x, lp, acc, step0, n, thin):
        fr, fr_lp = stretch_steps_multicluster(
            x, lp, acc, step_seed, n, stk, thin=thin, step0=step0)
        return fr, fr_lp, 0

    x, lp, acc, n_dec, n_near, _, err, _ = compare_fused(
        f"cluster grid C={n_c}", x, lp, acc, n_steps, plain_half, kernel,
        torch.as_tensor(tol, dtype=torch.float32, device=dev))
    return x, lp, acc, n_dec, n_near, err


def phase_multicluster(sess, c, seed: int) -> dict:
    """Phase 8: kernel 4 (the cluster-grid step kernel) vs its plain
    version, and the different-data negative control."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_flops,
                                              pack_consts_stack)
    from joxsz_torch.ops.multicluster_kernel import (
        multicluster_bits, multicluster_ll, steps_multicluster_plain,
        stretch_steps_multicluster)
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
        return compare_cluster_grid(x, lp, acc, stk, step_seed,
                                    STEPS_CMP_MC)

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

    n = TIME_STEPS
    run = lambda: stretch_steps_multicluster(             # noqa: E731
        x, lp, acc, step_seed, n, stack)
    ms = cuda_ms(run, reps=5, warmup=1)
    dev_us, busy = device_time_per_launch(run, reps=5,
                                          want="stretch_steps_kernel")
    plain_ms = cuda_ms(lambda: steps_multicluster_plain(
        x, lp, acc, n, lambda step, which: multicluster_bits(
            step_seed, dev, step, which, C, H), stack), reps=1, warmup=0)
    rows = C * H
    flops = joint_ll_flops(c) * 2 * rows * n
    nbytes = 4 * (2 * C * W * (D + 2) + stack.buf.numel())
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
    us = dev_us.get("stretch_steps_kernel")
    dv = (f"{us / n:.2f} us of device time per step" if us
          else "device time not measured")
    print(f"[8] {STEPS_CMP_MC} steps at C={C} and at a mesh shard's block "
          f"of C={c_loc}, W={W}: {n_dec} half-step decisions, {n_near} "
          f"steps where a decision within {MARGIN} of its threshold went "
          "the other way; state == the plain step on kernel 1's likelihood "
          f"elsewhere; max "
          f"|lp err| {err_half:.4g}; stored lp == fresh kernel 1 per "
          f"cluster; different-data gaps {gap:.1f} / {gap2:.1f}; one launch "
          f"of {n} steps {ms:.4f} ms = {1e3 * ms / n:.2f} us per step ({dv}, "
          f"device busy {busy_text(busy)}; plain {plain_ms:.1f} ms, bound "
          f"{bound:.4f} ms) on {card_line()}")
    return dict(name="stretch_steps_multicluster", route="cuda",
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


def compare_coupled(x0, lp0, c, step_seed: int, n_shards: int, devices=None,
                    partner: str = "onehot", tol: float = TIGHT_ATOL):
    """Kernel 6 over ``n_shards`` shards from the ensemble x0 (W, D), lp0
    (W,) for STEPS_CMP_COUPLED steps under the partner law ``partner``:
    every launch against its plain version on the same Philox bits, and
    after every full step the joined blocks against the step kernel at
    K = 1 on the whole ensemble (a launch of that one step, same law),
    bit for bit.
    ``devices``: one card per shard (default: all on the constants'
    card; the plain comparison runs only there); ``tol``: how far the
    plain float32 likelihood may move a threshold.  Returns (decisions,
    near-threshold differences, largest lp error, final x, lp, acc)."""
    import torch
    from joxsz_torch.ops.coupled_kernel import (coupled_half,
                                                coupled_half_plain)
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import philox_stream, stretch_steps
    from joxsz_torch.sampling.kernel import rung_tensors
    from joxsz_torch.sampling.tempered import hash_shift

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
    beta1, db1 = rung_tensors([1.0], home)
    sacc = torch.zeros(1, dtype=torch.int32, device=home)
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
            shift = (hash_shift(step_seed, step, which, H)
                     if partner == "roll" else None)
            xm, lm, am = halves[which]
            fixed_home = torch.cat([t.to(home) for t in halves[1 - which][0]])
            for s in range(n_shards):
                fixed = fixed_home.to(devices[s])
                if compare_plain:
                    xp, lpp, _, accp, margin = coupled_half_plain(
                        xm[s], lm[s], am[s], fixed, s * H_loc, b, lp_fn,
                        shift)
                    _, _, _, acc1, margin1 = coupled_half_plain(
                        xm[s], lm[s], am[s], fixed, s * H_loc, b, lp_k1,
                        shift)
                    a_before = am[s].clone()
                coupled_half(xm[s], lm[s], am[s], fixed, which, step_seed,
                             step, s * H_loc, consts[s], partner=partner)
                if not compare_plain:
                    continue
                nd, nn, e = check_half_against_plain(
                    f"coupled, W={W}, {n_shards} shards, step {step}, half "
                    f"{which}, shard {s}", (am[s] - a_before) > 0.5, xm[s],
                    lm[s], (xp, lpp, accp, margin), (acc1, margin1),
                    torch.tensor(tol, device=home))
                n_dec, n_near, err = n_dec + nd, n_near + nn, max(err, e)
        # the step kernel at K = 1 on the whole ensemble, same seed and step
        stretch_steps(xr, lr, ar, sacc, beta1, db1, step_seed, 1, c,
                      step0=step, partner=partner)
        for k, ref in enumerate((xr, lr, ar)):
            got = torch.cat([t.to(home) for h in (0, 1)
                             for t in halves[h][k]])
            check(torch.equal(got, ref[0]),
                  f"coupled: {('x', 'lp', 'acc')[k]} over {n_shards} "
                  f"shards differs from the step kernel at K=1 (W={W}, "
                  f"step {step})")
    torch.cuda.synchronize()
    x, lp, acc = (torch.cat([t.to(home) for h in (0, 1)
                             for t in halves[h][k]]) for k in range(3))
    check(float(acc.mean()) > 0, "coupled: no move was accepted")
    check(torch.equal(joint_ll(x, c), lp), "coupled: stored lp differs from "
          "a fresh kernel-1 evaluation")
    return n_dec, n_near, err, x, lp, acc


def phase_coupled(sess, c, seed: int) -> dict:
    """Phase 11: kernel 6 (the coupled half-step) vs its plain version and
    vs the step kernel at K = 1, the negative control, and its times."""
    import numpy as np
    import torch
    from joxsz_torch.ops.coupled_kernel import (coupled_half,
                                                coupled_half_plain)
    from joxsz_torch.ops.joint_kernel import joint_ll, joint_ll_plain
    from joxsz_torch.ops.step_kernel import philox_stream
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
                  f"vs plain; max |lp err| {e:.4g}; x, lp, acc == the step "
                  "kernel at K=1 after every step; stored lp == fresh "
                  "kernel 1")
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
              "cards == the step kernel at K=1 on one card, bit for bit")
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
        dev_us, _ = device_time_per_launch(run, reps=100,
                                           want="coupled_half_kernel")
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
    ms, plain_ms, bound, by = timed[W_MESH // 2 // N_SHARDS]
    return dict(name="coupled_half", route="cuda",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1657",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


class SharedOperator:
    """Inside the block, ``build_session`` makes the SZ operator once and
    hands every later session the same one: the sessions of one dataset
    (the synthetic data's own, every family's) share its geometry, beam,
    filter and SZ radii, and at 20 Mpc one operator takes ~10 s of the
    host CPU."""

    def __enter__(self):
        from joxsz_torch import build

        self.build, self.real, self.op = build, build.build_sz_operator, None

        def once(*args, **kw):
            if self.op is None:
                self.op = self.real(*args, **kw)
            return self.op

        build.build_sz_operator = once
        return self

    def __exit__(self, *exc):
        self.build.build_sz_operator = self.real


def threshold_tol(lp) -> float:
    """How far the plain float32 likelihood may move a step's threshold
    at log-posteriors up to max |lp| (finite): TIGHT_ATOL below
    TIGHT_BELOW, as phases 4, 8 and 11 hold it; above, twice TIGHT_RTOL
    of it, as phase 22 holds lp near 5e5 (a threshold is a difference of
    two lp)."""
    import torch

    peak = float(lp[torch.isfinite(lp)].abs().max())
    return TIGHT_ATOL if peak < TIGHT_BELOW else 2 * TIGHT_RTOL * peak


def card_plan(c) -> str:
    """The step kernel's launch plan on this card (``step_kernel_config``)
    as ``consts_layout.launch_plan`` names it, checked against that mirror
    at the card's own shared-memory limit."""
    import torch
    from joxsz_torch.ops.consts_layout import H100_SMEM_OPTIN, launch_plan
    from joxsz_torch.ops.step_kernel import step_kernel_config

    _, _, staged, ws = step_kernel_config(c, 1, 64)
    plan = "staged" if staged else "workspace" if ws else "in place"
    optin = getattr(torch.cuda.get_device_properties(c.device),
                    "shared_memory_per_block_optin", H100_SMEM_OPTIN)
    mirror = launch_plan(c.params, "stretch_steps", optin)
    check(plan == mirror, f"the card's plan {plan!r}, the host's mirror "
          f"{mirror!r}")
    return plan


def check_center(sess):
    """``synth.truth_theta`` as a centre for the checks at any extent:
    clipped to 1e-3 of each box's span inside it (at 20 Mpc the truth's
    pressure at the outermost knot lies below the knots' box), and with
    the double density's second component negligible at every radius
    (log(n_02) at its floor, beta_2 = 2: out to 20 Mpc the truth's r^-3
    tail outweighs the main component and the HSE mass falls)."""
    import numpy as np
    from joxsz_torch.synth import truth_theta

    p = sess.params
    th = truth_theta(sess)
    if "log(n_{02})" in p.thawed:
        th[p.thawed.index("log(n_{02})")] = p.lo[p.thawed.index(
            "log(n_{02})")]
        th[p.thawed.index(r"\beta_2")] = 2.0
    span = np.where(np.isfinite(p.hi - p.lo), p.hi - p.lo, 1.0)
    return np.clip(th, np.where(np.isfinite(p.lo), p.lo + 1e-3 * span,
                                -np.inf),
                   np.where(np.isfinite(p.hi), p.hi - 1e-3 * span, np.inf))


def second_truth(sess, center):
    """(2, D): ``center`` and a cluster 20% brighter in pressure (P_0, or
    every knot value by log10 1.2), the two clusters of kernel 4's check."""
    import numpy as np

    names = sess.params.thawed
    truths = np.tile(center, (2, 1))
    if "P_0" in names:
        truths[1, names.index("P_0")] *= 1.2
    else:
        k = [i for i, n in enumerate(names) if n.startswith("logP_")]
        truths[1, k] += np.log10(1.2)
    return truths


def shape_checks(tag: str, cfg, sess, seed: int, plan: str | None = None,
                 rows64=None, tight_below: float = TIGHT_BELOW,
                 sz_core: bool = True) -> dict:
    """Every kernel at one configuration and model family (``sess`` on the
    card, of ``cfg``'s dataset), each held against its plain version: the
    launch plan (checked to be ``plan`` where given), kernel 1 on 1024
    rows as phase 3 (``rows64``, default ``family_rows`` around
    ``check_center``; within TIGHT_ATOL where |ll| < ``tight_below``), the
    step kernel at W=64, K=1 and W=32, K=4 as phase 4, kernel 4 on two
    clusters as phase 8, kernel 5 as phase 7 (1024 rows, where
    ``sz_core``), kernel 6 over 2 shards as phase 11, each for
    STEPS_CMP_LARGE steps (thresholds within ``threshold_tol``).  Returns
    the row phase 26 prints."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_bytes,
                                              joint_ll_flops, pack_consts,
                                              pack_consts_stack)
    from joxsz_torch.ops.multicluster_kernel import multicluster_ll
    from joxsz_torch.sampling.tempered import default_betas
    from joxsz_torch.simulate import simulate_survey

    t0 = time.time()
    c = pack_consts(sess)
    I = c.ints
    got = card_plan(c)
    check(plan is None or got == plan, f"{tag} plan {got!r}, want {plan!r}")
    center = check_center(sess)
    if rows64 is None:
        rows64 = family_rows(sess, center, seed, 1024)
    rows, err1, err64, n_veto = check_joint_rows(sess, c, rows64,
                                                 tight_below)
    ms1 = cuda_ms(lambda: joint_ll(rows, c), reps=20)
    bound1 = 1e3 * max(joint_ll_bytes(c, 1024) / PEAK_BYTES_S,
                       joint_ll_flops(c) * 1024 / PEAK_F32_S)
    step_seed = int(np.random.default_rng(seed + 7).integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed + 8)
    x1, lp1, acc1 = family_start(c, center, 1, 64, rng)
    tol = threshold_tol(lp1)
    e2 = compare_steps(x1.clone(), lp1.clone(), acc1.clone(), np.ones(1), c,
                       step_seed, STEPS_CMP_LARGE, tag, tol)[3]
    e3 = compare_steps(*family_start(c, center, 4, 32, rng),
                       default_betas(4), c, step_seed, STEPS_CMP_LARGE, tag,
                       tol)[3]
    truths = second_truth(sess, center)
    survey = simulate_survey(sess.model, truths,
                             np.random.default_rng(seed + 9))
    stk = pack_consts_stack(sess, survey.sz_stack, survey.xray_stack)
    x4, lp4, acc4 = cluster_grid_start(stk, truths, 64, rng)
    x4, lp4, _, _, _, e4 = compare_cluster_grid(
        x4, lp4, acc4, stk, step_seed, STEPS_CMP_LARGE,
        tol=threshold_tol(lp4))
    check(torch.equal(multicluster_ll(x4, stk), lp4),
          f"{tag} cluster grid: stored lp differs from a fresh kernel-1 "
          "evaluation")
    k5 = ""
    if sz_core:
        _, _, e5, rel5, _, n_nan, n_tab = check_sz_core(cfg, sess, seed,
                                                        1024, rows64)
        k5 = (f"SZ core {e5:.4g} (rel {rel5:.3g}, {n_nan} NaN, {n_tab} "
              "outside the table); ")
    _, _, e6, _, _, _ = compare_coupled(x1[0], lp1[0], c, step_seed, 2,
                                        tol=tol)
    err = max(err1, e2, e3, e4, e6)
    shapes = (f"{I['n_press']} pressure radii, {I['n_pix']} map radii, "
              f"{I['n_data']} SZ points, {I['n_band']} bands x "
              f"{I['n_ann']} annuli, nT {I['nT']}, D={I['D']}")
    print(f"{tag} {shapes}; plan {got}; kernel 1 max |err| {err1:.4g} vs "
          f"plain f32 ({n_veto} vetoed of 1024), {err64:.4g} vs plain f64, "
          f"{ms1:.4f} ms at 1024 rows (bound {bound1:.4f} ms) on "
          f"{card_line()}; step kernel max |lp err| {max(e2, e3):.4g}; "
          f"cluster grid {e4:.4g}; {k5}kernel 6 over 2 shards == the step "
          f"kernel, max |lp err| {e6:.4g}; {time.time() - t0:.1f} s")
    return dict(tag=tag, shapes=shapes, plan=got, err=err, ms1=ms1,
                bound1=bound1)


def phase_large_shapes(seed: int):
    """Phase 13: every kernel at shapes where the constants do not fit in
    a block's shared memory, a cluster at z = 0.3: on a map of 200" (542
    pressure radii, 127 map radii: the constants read in place, two
    passes of map radii) and integrated out to 20 Mpc (2167 pressure
    radii: the tiles' scratch in global memory too), by ``shape_checks``
    on the rows of phase 3 (``ll_rows``)."""
    from joxsz_torch.build import build_session
    from joxsz_torch.synth import write_synthetic_dataset

    for (r_max, extent), plan in zip(LARGE_SHAPES, ("in place",
                                                    "workspace")):
        tmp = tempfile.mkdtemp(prefix="joxsz_large_")
        try:
            with SharedOperator():
                cfg = write_synthetic_dataset(tmp, seed, redshift=0.3,
                                              max_radius_arcsec=r_max,
                                              extent_kpc=extent)
                sess = build_session(cfg, device="cuda")
            shape_checks(f"[13] z=0.3, {r_max:g}\" map, {extent:g} kpc:",
                         cfg, sess, seed, plan,
                         rows64=ll_rows(sess, seed, 1024),
                         tight_below=math.inf)
            del sess
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


# phase 26: the families of phase 14 at phase 13's shapes, and the veto
# clouds of tests/test_torch_precision.py (family, run flags; spreads)
GEOMETRY_FAMILIES = tuple((t, f) for t, f, _, _ in FAMILIES if t != "widest")
VETO_FAMILIES = (("flagship", ()), ("double", ("--density", "double")),
                 ("knots", ("--pressure", "knots")))
VETO_SPREADS, VETO_ROWS = (0.1, 0.2), 512
# phase 26: production-box prior draws through kernel 1 (tests/test_torch_
# veto_box.py's dataset and families at its seed): (family, run flags,
# draws); the knots' prior keeps ~0.1% of their box, so they take fewer
# draws, from larger batches
VETO_BOX_FAMILIES = (
    ("flagship", (), 4096), ("double", ("--density", "double"), 4096),
    ("vikhlinin", ("--temperature", "vikhlinin"), 4096),
    ("knots", ("--pressure", "knots"), 1024))
# phase 26e: near-tie rows (ops/mass_veto.py::near_tie_rows) between the
# first TIE_PAIRS kept and vetoed rows of each family's veto cloud, through
# kernel 1 and the tile of the step kernel (K=1; K=4, every rung), kernel
# 4 and kernel 6 (each walker of a W=TIE_W ensemble holds the row, so that its proposal is the
# row, from the start lp TIE_LP0, which any finite proposal beats); the
# families and, on phase 13's first shape (the _large_ instances), two
TIE_FAMILIES = (("flagship", ()), ("double", ("--density", "double")),
                ("knots", ("--pressure", "knots")),
                ("vikhlinin", ("--temperature", "vikhlinin")))
TIE_LARGE = ("flagship", "vikhlinin")
TIE_PAIRS, TIE_W, TIE_LP0 = 2, 32, -3e38
CORNER_FIT = "knots"            # phase 26: the corner fitted through run
CORNER_FIT_TIMEOUT = 600


def phase_geometries(seed: int) -> list:
    """Phase 26a: ``shape_checks`` at the eight corners of ``synth.
    CORNERS`` (the JAX geometry sweep's six and two families; kernel 5
    where the corner is joint) and for every family of phase 14 at phase
    13's two shapes (kernel 5 there is phase 13's).  Returns the rows."""
    from joxsz_torch.build import build_session
    from joxsz_torch.synth import (CORNERS, write_corner,
                                   write_synthetic_dataset)

    rows = []
    for i, (name, dims) in enumerate(CORNERS.items()):
        tmp = tempfile.mkdtemp(prefix="joxsz_corner_")
        try:
            with SharedOperator():
                cfg, sz_only = write_corner(tmp, seed + 40 + i, dims)
                sess = build_session(cfg, device="cuda", sz_only=sz_only)
            rows.append(shape_checks(f"[26] {name}:", cfg, sess, seed,
                                     sz_core=not sz_only))
            del sess
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    for (r_max, extent), plan in zip(LARGE_SHAPES, ("in place",
                                                    "workspace")):
        tmp = tempfile.mkdtemp(prefix="joxsz_large_")
        try:
            with SharedOperator():
                cfg = write_synthetic_dataset(tmp, seed, redshift=0.3,
                                              max_radius_arcsec=r_max,
                                              extent_kpc=extent)
                for tag, flags in GEOMETRY_FAMILIES:
                    sess = family_session(cfg, flags)
                    rows.append(shape_checks(
                        f"[26] {tag}, z=0.3, {r_max:g}\" map, "
                        f"{extent:g} kpc:", cfg, sess, seed, plan,
                        sz_core=False))
                    del sess
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return rows


def phase_veto_clouds(cfg, seed: int) -> int:
    """Phase 26b: the veto clouds of ``tests/test_torch_precision.py``
    (VETO_ROWS rows at spreads VETO_SPREADS around the synthetic truth,
    ``np.random.default_rng(7)``) for the flagship, double density and
    knots on phase 2's dataset, through kernel 1 against the plain float32
    version (no flip; a flip is printed with its float64 verdict before
    the check fails) and the float64 model (the session's own): no flip
    either, near-ties included (row 200 of the flagship's 0.2 cloud, which
    the JAX float32 kernel vetoes, kept).  Returns the rows where kernel
    1 vetoes what float64 keeps (0)."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_plain,
                                              pack_consts)
    from joxsz_torch.synth import truth_theta

    n_f64 = 0
    for tag, flags in VETO_FAMILIES:
        sess = family_session(cfg, flags)
        c = pack_consts(sess)
        th0 = truth_theta(sess)
        for spread in VETO_SPREADS:
            rng = np.random.default_rng(7)
            rows = torch.tensor(th0[None] * (1 + spread * rng.standard_normal(
                (VETO_ROWS, th0.size))), dtype=torch.float32,
                device=c.device)
            k = torch.isfinite(joint_ll(rows, c)).cpu().numpy()
            p = torch.isfinite(joint_ll_plain(rows, c)).cpu().numpy()
            with torch.no_grad():
                f = torch.isfinite(sess.model.log_like_batch(
                    rows.double())).cpu().numpy()
            flips = np.flatnonzero(k != p)
            for i in flips:
                side = "the plain version" if f[i] == p[i] else "kernel 1"
                print(f"[26] {tag} spread {spread}: row {i} kernel 1 "
                      f"{'finite' if k[i] else '-inf'}, plain "
                      f"{'finite' if p[i] else '-inf'}; float64 sides with "
                      f"{side}; theta {rows[i].tolist()}")
            check(flips.size == 0, f"[26] {tag} spread {spread}: "
                  f"{flips.size} veto flips between kernel 1 and the plain "
                  "float32 version")
            flips64 = np.flatnonzero(k != f)
            n_f64 += int((f & ~k).sum())
            print(f"[26] {tag} veto cloud at spread {spread}: {VETO_ROWS} "
                  f"rows, {p.mean():.3f} finite, 0 flips between kernel 1 "
                  f"and plain f32; flips against float64: "
                  f"{flips64.tolist()}")
            check(flips64.size == 0, f"[26] {tag} spread {spread}: kernel "
                  f"1 and the float64 model differ on rows "
                  f"{flips64.tolist()}")
            if (tag, spread) == ("flagship", 0.2):
                check(bool(k[200]), "[26] row 200 of the flagship's 0.2 "
                      "cloud (float64 keeps it) vetoed by kernel 1")
        del sess, c
    return n_f64


def phase_veto_box(tmp: str) -> dict:
    """Phase 26c: prior draws of the production box (``sample_prior``,
    ``np.random.default_rng(2)``) on the dataset of ``tests/test_torch_
    veto_box.py`` (pressure radii 16 to 5008 kpc) through kernel 1, the
    flagship instance and the family instance, for VETO_BOX_FAMILIES,
    against the float64 model on the card: no row the float64 model
    keeps above NEGLIGIBLE_LP is -inf, near-ties included (row 2993 of
    the Vikhlinin-T draws, a rise of 1.3e-5 a grid step at ln M ~ 130,
    kept).  Lost rows are printed by cause: the mass veto (kernel 1 with
    the veto off keeps them) or the rest of the likelihood.  Returns
    {family: (lost, live)}."""
    import dataclasses
    import numpy as np
    import torch
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import joint_ll, pack_consts
    from joxsz_torch.sampling.priors import model_log_prior, sample_prior
    from joxsz_torch.sampling.sbc import NEGLIGIBLE_LP, veto_margins
    from joxsz_torch.synth import write_synthetic_dataset

    base = write_synthetic_dataset(f"{tmp}/veto_box", 3, n_annuli=6,
                                   n_sz=6, max_radius_arcsec=30.0)
    out = {}
    for tag, flags, n in VETO_BOX_FAMILIES:
        t0 = time.time()
        sess = family_session(base, flags)
        m = sess.model
        knots = "knots" in flags
        th = sample_prior(model_log_prior(m), m.params, n,
                          np.random.default_rng(2),
                          batch=65536 if knots else None,
                          max_tries=400 if knots else 64)
        c = pack_consts(sess)
        rows = torch.as_tensor(th, dtype=torch.float32, device=c.device)
        before = dict(_build.instance_launches)
        l32 = joint_ll(rows, c)
        inst = [k for k, v in _build.instance_launches.items()
                if v > before[k]]
        ms = cuda_ms(lambda: joint_ll(rows, c), reps=5)
        with torch.no_grad():
            l64 = m.log_like_batch(torch.as_tensor(
                th, device=c.device)).cpu().numpy()
        l32 = l32.cpu().numpy()
        live = l64 > NEGLIGIBLE_LP
        lost = np.flatnonzero(live & ~np.isfinite(l32))
        by_veto = 0
        margins = np.zeros(0)
        if lost.size:
            off = dataclasses.replace(c, ints={**c.ints, "mass_veto": 0},
                                      params=None)
            by_veto = int(np.isfinite(joint_ll(rows[lost], off)
                                      .cpu().numpy()).sum())
            margins = veto_margins(sess.model, th[lost])
        row_2993 = ""
        if tag == "vikhlinin" and len(th) > 2993:
            row_2993 = (f"; row 2993 (float64 margin "
                        f"{veto_margins(sess.model, th[2993:2994])[0]:.3g})"
                        f" {'finite' if np.isfinite(l32[2993]) else '-inf'}"
                        " in kernel 1")
        print(f"[26] production box, {tag} ({inst}): {len(th)} draws, "
              f"{int(live.sum())} kept by float64, {lost.size} of them "
              f"-inf in kernel 1 ({by_veto} by the mass veto, "
              f"{lost.size - by_veto} by the rest of the likelihood: "
              f"rows {lost[:8].tolist()}, float64 margins "
              f"{[float(f'{x:.3g}') for x in margins[:8]]}){row_2993}; "
              f"kernel 1 on these rows {ms:.4f} ms; {time.time() - t0:.1f} "
              "s")
        check(lost.size == 0, f"[26] production box, {tag}: kernel 1 "
              f"loses rows {lost.tolist()} that float64 keeps")
        out[tag] = (int(lost.size), int(live.sum()))
        del sess, c
    return out


def tie_rows(sess):
    """Float32 near-tie rows of ``sess``'s family (``ops.mass_veto.
    near_tie_rows``, as ``tests/test_torch_veto_ties.py`` builds them)
    between the first TIE_PAIRS rows of its veto cloud (spread 0.1, else
    0.2) that the float64 model keeps and that its mass veto vetoes
    inside the prior box; returns (rows, float64 verdict: a finite
    log-posterior, float64 veto margins)."""
    import numpy as np
    import torch
    from joxsz_torch.ops.mass_veto import near_tie_rows
    from joxsz_torch.sampling.sbc import veto_margins
    from joxsz_torch.synth import truth_theta

    m = sess.model
    th0 = truth_theta(sess)
    for spread in VETO_SPREADS:
        rng = np.random.default_rng(7)
        rows = (th0[None] * (1 + spread * rng.standard_normal(
            (VETO_ROWS, th0.size)))).astype(np.float32)
        margins = veto_margins(m, rows.astype(np.float64))
        t = torch.as_tensor(rows, dtype=torch.float64, device=sess.device)
        with torch.no_grad():
            keep = torch.isfinite(m.log_like_batch(t)).cpu().numpy()
            box = torch.isfinite(m.params.log_prior(t)).cpu().numpy()
        kept = np.flatnonzero(keep & (margins > 0))[:TIE_PAIRS]
        vetoed = np.flatnonzero(box & (margins < 0))[:TIE_PAIRS]
        if kept.size and vetoed.size:
            break
    check(kept.size > 0 and vetoed.size > 0, "no kept and vetoed cloud "
          "rows to build near-ties between")
    ties = [near_tie_rows(m, rows[i], rows[j]) for i, j in zip(kept,
                                                               vetoed)]
    out = np.concatenate([t[0] for t in ties])
    with torch.no_grad():
        f64 = torch.isfinite(m.log_like_batch(torch.as_tensor(
            out, dtype=torch.float64, device=sess.device))).cpu().numpy()
    return out, f64, np.concatenate([t[1] for t in ties])


def tile_lps(sess, c, rows) -> dict:
    """Kernel 1's log-posteriors of ``rows`` (n, D), and the tile's in the
    step kernel (K=1, and K=4 on the production ladder, every rung holding
    the row), kernel 4 (n clusters, each the session's data) and kernel 6:
    every walker of a W=TIE_W ensemble holds one row, so each proposal y =
    x_p + z (x - x_p) is that row, and the walkers start at lp TIE_LP0, so
    a proposal is accepted exactly where it is finite, on every rung (beta
    (lp - TIE_LP0) > 0), and the swaps exchange equal states: (n, TIE_W)
    lp after one step (half a step for kernel 6; (n, K x TIE_W) at K=4)."""
    import torch
    from joxsz_torch.models.multicluster import (stack_sz_data,
                                                 stack_xray_data)
    from joxsz_torch.ops import coupled_kernel as ck
    from joxsz_torch.ops import multicluster_kernel as mk
    from joxsz_torch.ops import step_kernel as sk
    from joxsz_torch.ops.joint_kernel import joint_ll, pack_consts_stack
    from joxsz_torch.sampling.kernel import rung_tensors
    from joxsz_torch.sampling.tempered import default_betas

    n, D = rows.shape
    dev = c.device
    r = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    out = {"kernel 1": joint_ll(r, c)}

    def start(shape):
        return (torch.full(shape, TIE_LP0, device=dev),
                torch.zeros(shape, device=dev))

    lps = []
    for i in range(n):
        x = r[i].expand(1, TIE_W, D).contiguous()
        lp, acc = start((1, TIE_W))
        sk.stretch_steps(x, lp, acc, torch.zeros(1, dtype=torch.int32,
                                                 device=dev),
                         torch.ones(1, device=dev), torch.zeros(0,
                                                                device=dev),
                         5, 1, c)
        lps.append(lp[0])
    out["step kernel"] = torch.stack(lps)
    K = 4
    beta, db = rung_tensors(default_betas(K), dev)
    lps = []
    for i in range(n):
        x = r[i].expand(K, TIE_W, D).contiguous()
        lp, acc = start((K, TIE_W))
        sk.stretch_steps(x, lp, acc, torch.zeros(K - 1, dtype=torch.int32,
                                                 device=dev), beta, db, 5,
                         1, c)
        lps.append(lp.reshape(-1))
    out["step kernel, K=4"] = torch.stack(lps)
    m = sess.model
    stack = pack_consts_stack(sess, stack_sz_data([m.sz_data] * n),
                              stack_xray_data([m.xray_data] * n))
    x = r[:, None, :].expand(n, TIE_W, D).contiguous()
    lp, acc = start((n, TIE_W))
    mk.stretch_steps_multicluster(x, lp, acc, 5, 1, stack)
    out["kernel 4"] = lp
    lps = []
    for i in range(n):
        xf = r[i].expand(TIE_W // 2, D).contiguous()
        lp, acc = start((TIE_W // 2,))
        ck.coupled_half(xf.clone(), lp, acc, xf, 0, 5, 0, 0, c)
        lps.append(lp)
    out["kernel 6"] = torch.stack(lps)
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_ties(tag: str, sess, c) -> int:
    """The near-tie rows of ``sess``'s family through ``tile_lps``: each
    kernel's verdict is the float64 model's, and each tile's finite value
    kernel 1's, bit for bit.  Returns the float64-tier pairs kernel 1
    decided on them."""
    import numpy as np
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import f64_pairs

    rows, f64, margins = tie_rows(sess)
    f64_pairs(reset=True)
    before = dict(_build.instance_launches)
    lps = tile_lps(sess, c, rows)
    n64 = f64_pairs(reset=True)
    inst = sorted(k for k, v in _build.instance_launches.items()
                  if v > before[k])
    k1 = lps["kernel 1"]
    check(np.array_equal(np.isfinite(k1), f64), f"[26] {tag} near-ties: "
          f"kernel 1 differs from float64 on rows "
          f"{np.flatnonzero(np.isfinite(k1) != f64).tolist()}")
    for name in ("step kernel", "step kernel, K=4", "kernel 4",
                 "kernel 6"):
        v = lps[name]
        want = np.where(f64[:, None], k1[:, None], np.float32(TIE_LP0))
        check(np.array_equal(v, np.broadcast_to(want, v.shape)),
              f"[26] {tag} near-ties: the {name}'s tile differs from "
              f"kernel 1 / float64 on rows "
              f"{np.flatnonzero((v != want).any(axis=1)).tolist()}")
    print(f"[26] {tag} near-ties: {len(rows)} rows at float64 margins "
          f"{np.abs(margins).min():.2g} to {np.abs(margins).max():.2g} "
          f"({int(f64.sum())} kept), kernel 1, the step kernel at K=1 "
          f"and K=4 (every rung), kernel 4 and kernel 6 each the float64 "
          f"verdict ({inst}); kernel 1's "
          f"float64-tier pairs {n64}")
    return n64


def phase_near_ties(cfg, tmp: str, seed: int) -> int:
    """Phase 26e: near-tie rows of every TIE_FAMILIES family on phase 2's
    dataset, and of TIE_LARGE on phase 13's first shape (z = 0.3, the
    _large_ instances), through ``check_ties``.  Returns the float64-tier
    pairs."""
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.synth import write_synthetic_dataset

    n64 = 0
    for tag, flags in TIE_FAMILIES:
        sess = family_session(cfg, flags)
        n64 += check_ties(tag, sess, pack_consts(sess))
        del sess
    r_max, extent = LARGE_SHAPES[0]
    with SharedOperator():
        big = write_synthetic_dataset(f"{tmp}/ties_large", seed,
                                      redshift=0.3, max_radius_arcsec=r_max,
                                      extent_kpc=extent)
        for tag, flags in TIE_FAMILIES:
            if tag in TIE_LARGE:
                sess = family_session(big, flags)
                c = pack_consts(sess)
                check(card_plan(c) == "in place", f"{tag} at z = 0.3: "
                      f"plan {card_plan(c)}")
                n64 += check_ties(f"{tag}, z = 0.3", sess, c)
                del sess, c
    return n64


def corner_cli(kw: dict) -> list:
    """The ``python -m joxsz_torch.synth`` flags of the arguments ``kw``
    of ``write_synthetic_dataset`` (``synth.corner_kwargs``)."""
    flags = {"redshift": "--redshift", "extent_kpc": "--extent-kpc",
             "step_arcsec": "--step", "fwhm_arcsec": "--fwhm",
             "n_sz": "--n-sz", "max_radius_arcsec": "--max-radius",
             "n_annuli": "--n-annuli", "nT": "--nT", "nh_1022": "--nh",
             "pressure_model": "--pressure",
             "n_pressure_knots": "--n-knots",
             "temperature_model": "--temperature",
             "density_mode": "--density"}
    argv = []
    for k, v in kw.items():
        if k == "bands":
            argv += ["--bands", ",".join(f"{a}-{b}" for a, b in v)]
        elif k in ("response", "keep_table", "line_systematic"):
            argv += [f"--{k.replace('_', '-')}"] if v else []
        else:
            argv += [flags[k], repr(v) if isinstance(v, float) else str(v)]
    return argv


def corner_fit(path: str):
    """The fit of a corner through ``run.main`` (a child process of phase
    26), as ``python -m joxsz_torch.run --config PATH --quick --no-plots``
    runs it: the launch counters set to 0 just before and read just after,
    printed as a JSON line, last."""
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.ops import _build

    zero_launches()
    before = dict(_build.instance_launches)
    res = run.main(["--config", path, "--quick", "--no-plots"])
    print(json.dumps({
        "launches": read_launches(),
        "instances": {k: v - before[k]
                      for k, v in _build.instance_launches.items()},
        "acceptance": float(np.mean(res.acceptance_fraction)),
        "shape": list(res.chain.shape),
        "finite": bool(np.all(np.isfinite(res.chain)))}))


def phase_corner_fit(tmp: str, seed: int) -> dict:
    """Phase 26d: another cluster fitted end to end: the CORNER_FIT corner
    written by the ``synth`` CLI, then fitted by ``run --config <it>
    --quick --no-plots`` (W=1024 x K=4, the config's production widths)
    in a child process: a posterior table (fit.dat, the summary's finite
    medians), finite chains, kernel 1 and the step kernel at K=1 and K=4
    launched, through the family instances."""
    import math as _math
    from joxsz_torch.synth import CORNERS, corner_kwargs

    kw, _ = corner_kwargs(CORNERS[CORNER_FIT])
    out = f"{tmp}/corner_{CORNER_FIT}"
    t0 = time.time()
    syn = subprocess.run([sys.executable, "-m", "joxsz_torch.synth", out,
                          "--seed", str(seed)] + corner_cli(kw),
                         capture_output=True, text=True, timeout=300)
    check(syn.returncode == 0, f"synth CLI failed: {syn.stderr[-2000:]}")
    path = syn.stdout.strip().splitlines()[-1]
    fit = subprocess.run([sys.executable, __file__, "--corner-fit", path],
                         capture_output=True, text=True,
                         timeout=CORNER_FIT_TIMEOUT)
    wall = time.time() - t0
    check(fit.returncode == 0, f"corner fit failed: {fit.stdout[-3000:]}"
          f"{fit.stderr[-3000:]}")
    res = json.loads(fit.stdout.strip().splitlines()[-1])
    summary = json.loads(open(output_files(out)["summary"]).read())
    medians = [v["median"] for v in summary["parameters"].values()]
    check(os.path.exists(output_files(out)["fit.dat"]), "no fit.dat")
    check(all(_math.isfinite(m) for m in medians) and res["finite"],
          "corner fit: non-finite medians or chain")
    check(all(f"{name} |" in fit.stdout for name in summary["parameters"]),
          "corner fit: no posterior table in run's output")
    n = res["launches"]
    check(n["joint_ll"] > 0 and n["stretch_steps"] > 0
          and n["stretch_steps_tempered"] > 0,
          f"corner fit: kernels not launched: {n}")
    check(res["instances"]["stretch_steps_fam_kernel"] > 0,
          f"corner fit: the family instance not launched: "
          f"{res['instances']}")
    print(f"[26] {CORNER_FIT} corner fitted through the synth CLI and "
          f"run --config --quick --no-plots in {wall:.1f} s: chain "
          f"{res['shape']}, acceptance {res['acceptance']:.3f}, "
          f"{len(medians)} finite medians, launches {n}")
    return res


def phase_other_clusters(cfg, tmp: str, seed: int, card: str):
    """Phase 26: other clusters' geometries (26a), the veto clouds (26b),
    the production prior box through kernel 1 (26c), a corner fitted end
    to end (26d), and every compiled instance launched over the run."""
    t0 = time.time()
    phase_geometries(seed)
    n_f64 = phase_veto_clouds(cfg, seed)
    box = phase_veto_box(tmp)
    t_ties = time.time()
    n_tie64 = phase_near_ties(cfg, tmp, seed)
    t_ties = time.time() - t_ties
    phase_corner_fit(tmp, seed)
    check_instances(card)
    print(f"[26] phase 26 in {time.time() - t0:.1f} s ({n_f64} cloud rows "
          f"vetoed by kernel 1 and kept by float64; production-box rows "
          f"lost of those float64 keeps: {box}; near-ties in {t_ties:.1f} "
          f"s, {n_tie64} float64-tier pairs) on {card}")


def check_instances(card: str):
    """Every compiled instance (``_build.INSTANCES``: kernel 1, the step
    kernel and kernel 6 as flagship / family x fit / _large_, kernel 5 as
    fit / _large_) launched at least once in this process."""
    from joxsz_torch.ops import _build

    n = _build.instance_launches
    print(f"[26] launches of each compiled instance over the run: "
          f"{json.dumps(n)} on {card}")
    missing = [k for k, v in n.items() if v == 0]
    check(len(n) == 14 and not missing,
          f"compiled instances never launched: {missing}")


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
    from joxsz_torch.ops.step_kernel import stretch_steps
    from joxsz_torch.sampling.kernel import (make_kernel_sampler,
                                             run_multicluster_steps,
                                             rung_tensors)
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
    # one launch per window and shard; prelim (100 steps a round) and
    # burn (200) on one device, one launch per chunk of 100 steps
    check(launches["stretch_steps"] == MESH_WINDOWS * N_SHARDS
          + t["prelim_rounds"] + 2 and launches["joint_ll"] > 0,
          f"mesh launches {launches}")
    check(launches["stretch_steps_tempered"] == 0,
          "the tempered step kernel ran on an untempered fit")

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
                                             mesh, thin=THIN_MESH), reps=2,
        want="coupled_half_kernel")
    check(np.all(np.isfinite(rc.log_prob)) and 0.1 < float(np.mean(
        rc.acceptance_fraction)) < 0.6, "coupled sampler acceptance")
    print(f"[12] coupled sampler alone, W={W_MESH}, {N_SHARDS} shards, "
          f"{n_c} steps: {step_us:.1f} us per coupled step (2 x {N_SHARDS} "
          f"launches + 2 gathers), kernels 1 and 6 busy {busy_text(busy)} of "
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
        # prelim 100 steps a round and burn 100: one launch each
        return r, n, r.timings["prelim_rounds"] + 1

    # a layout the per-shard sampler declines (16 walkers per shard, below
    # the floor of 28): one ensemble coupled at every step, kernel 6
    n_d = 100
    rd, ld, one_dev = short_fit(nwalkers=W_MESH // 2, nsteps=n_d,
                                n_temper_rungs=0)
    check(rd.chain.shape == (n_d // THIN_MESH, W_MESH // 2, 13)
          and rd.timings["frame_spacing"] == THIN_MESH, "declined-layout fit")
    check(ld["coupled_half"] == n_d * 2 * N_SHARDS
          and ld["stretch_steps"] == one_dev
          and ld["stretch_steps_tempered"] == 0,
          f"declined-layout launches {ld}")
    print(f"[12] run_fit at W={W_MESH // 2} ({W_MESH // 2 // N_SHARDS} "
          f"walkers per shard, declined by the per-shard sampler): the "
          f"coupled sampler, {n_d} steps in {rd.timings['sample_s']:.2f} s, "
          f"acceptance {float(np.mean(rd.acceptance_fraction)):.3f}, "
          f"launches {ld}")

    # a tempered mesh fit: an independent K-rung ensemble per shard
    # (one step-kernel launch per chunk of 100 steps and shard), then the
    # runner against per-block runs, bit for bit
    K, n_t, w_loc = K_SMOKE, 200, W_MESH // N_SHARDS
    rt, lt, one_dev = short_fit(nwalkers=W_MESH, nsteps=n_t,
                                n_temper_rungs=K)
    swaps = rt.timings["swap_acceptance"]
    check(rt.chain.shape == (n_t // THIN_MESH, W_MESH, 13)
          and len(swaps) == K - 1
          and all(math.isfinite(v) and v > 0 for v in swaps),
          f"tempered mesh fit: chain {rt.chain.shape}, swap rates {swaps}")
    check(lt["stretch_steps_tempered"] == n_t // 100 * N_SHARDS
          and lt["stretch_steps"] == one_dev
          and lt["coupled_half"] == 0, f"tempered mesh launches {lt}")
    betas = default_betas(K)
    n_b = 50
    pt = torch.tensor(rt.chain[-1], device="cuda")
    got = sampler.run_tempered_sharded(pt, betas, n_b,
                                       np.random.default_rng(seed), mesh,
                                       thin=THIN_MESH)
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31 - 1,
                                                 size=(1, N_SHARDS))[0]
    beta, db = rung_tensors(betas, "cuda")
    for d in range(N_SHARDS):
        blk = slice(d * w_loc, (d + 1) * w_loc)
        x = pt[None, blk].repeat(K, 1, 1)
        lp = joint_ll(x.reshape(K * w_loc, 13), sampler.consts).reshape(
            K, w_loc)
        acc = torch.zeros_like(lp)
        sacc = torch.zeros(K - 1, dtype=torch.int32, device="cuda")
        stretch_steps(x, lp, acc, sacc, beta, db, int(seeds[d]), n_b,
                      sampler.consts)
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
    check(ls["stretch_steps_multicluster"] == 2 * N_SHARDS
          and ls["stretch_steps"] == 0, f"survey mesh launches {ls}")
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
                   "--temper", "0", "--mesh", "1", "--seed", str(seed)]
                  + plot_flags())
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



# ---- the model families (phases 14 and 15) --------------------------------

def family_session(cfg, flags):
    """The session of the model family that the run flags ``flags`` select
    on the dataset of ``cfg``, on the card, as ``run.main`` builds it."""
    import copy
    from joxsz_torch import run
    from joxsz_torch.build import build_session

    args = run.build_parser().parse_args(list(flags))
    fcfg = run.apply_model_flags(copy.deepcopy(cfg), args)
    return build_session(fcfg, device="cuda", sz_only=args.sz_only)


def family_rows(sess, center, seed: int, n: int):
    """n rows within 3% of ``center``; every 16th out of the box, every
    16th + 1 with r_c > r_s, every 16th + 2 with a falling HSE mass (the
    knots in reverse order for knot pressure); in an X-ray session rows
    16th + 3 colder than the count-rate table's grid and 16th + 4 hot
    (T_X above the grid for UPP; T_0 out of its box for Vikhlinin)."""
    import numpy as np
    import torch

    p = sess.params
    ix = p.thawed.index
    rng = np.random.default_rng(seed)
    rows = center[None] * (1 + 0.03 * rng.standard_normal((n, center.size)))
    rows[0::16, ix("log(n_0)")] = 5.0
    rows[1::16, ix("log(r_c)")], rows[1::16, ix("log(r_s)")] = 3.0, 2.0
    knots = "logP_0" in p.thawed
    if knots:
        k = slice(ix("logP_0"), ix("logP_0") + sess.model.pressure.n_knots)
        rows[2::16, k] = rows[2::16, k][:, ::-1]
    else:
        for name, v in (("b", 14.0), ("a", 5.0), ("r_p", 150.0),
                        (r"\beta", 0.2)):
            rows[2::16, ix(name)] = v
    if sess.model.xray_data is not None:
        if "T_0" in p.thawed:
            rows[3::16, ix("T_0")], rows[3::16, ix("T_{min}/T_0")] = 0.5, 0.05
            rows[4::16, ix("T_0")] = 200.0
        elif knots:
            rows[3::16, k] -= 3.0
            rows[4::16, ix("log(T_X/T_{SZ})")] = 0.98
            rows[4::16, k] += 1.0
        else:
            rows[3::16, ix("P_0")] = 2e-4
            rows[4::16, ix("log(T_X/T_{SZ})")] = 0.98
            rows[4::16, ix("P_0")] = 1.5
    return torch.tensor(rows, dtype=torch.float64, device=sess.device)


def family_start(c, center, k: int, w: int, rng):
    """A (k, w, D) state within 1% of ``center``, rows redrawn until every
    log-posterior is finite, its lp by kernel 1 and zero accept counts."""
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll

    D = center.size
    x = torch.empty((k * w, D), dtype=torch.float32, device=c.device)
    lp = torch.full((k * w,), -float("inf"), device=c.device)
    for _ in range(50):
        bad = ~torch.isfinite(lp)
        if not bool(bad.any()):
            break
        nb = int(bad.sum())
        x[bad] = torch.tensor(center[None] * (1 + 0.01 * rng.standard_normal(
            (nb, D))), dtype=torch.float32, device=c.device)
        lp[bad] = joint_ll(x[bad].contiguous(), c)
    check(bool(torch.isfinite(lp).all()), "non-finite family start state")
    return (x.reshape(k, w, D).contiguous(), lp.reshape(k, w),
            torch.zeros((k, w), device=c.device))


def phase_families(cfg, seed: int) -> list:
    """Phase 14: every model family's branch of kernel 1, the step kernel
    and (config #4) kernel 6 against their plain versions, as phases 3, 4
    and 11 hold the flagship's, and their times beside their bounds.
    Returns one kernels-line entry per kernel and family (launches from
    phase 15)."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_bytes,
                                              joint_ll_flops, joint_ll_plain,
                                              pack_consts)
    from joxsz_torch.ops.step_kernel import (philox_stream, steps_plain,
                                             stretch_steps)
    from joxsz_torch.sampling.kernel import rung_tensors
    from joxsz_torch.sampling.tempered import default_betas
    from joxsz_torch.synth import truth_theta

    card = card_line()
    entries = []
    W, K, n = W_SMOKE, K_SMOKE, TIME_STEPS_FAM
    for tag, flags, D, _ in FAMILIES:
        sess = family_session(cfg, flags)
        c = pack_consts(sess)
        check(c.ints["D"] == D, f"{tag}: D={c.ints['D']}, want {D}")
        center = truth_theta(sess)
        rows, err1, err64, n_veto = check_joint_rows(
            sess, c, family_rows(sess, center, seed, B_LL), TIGHT_BELOW)
        ms1 = cuda_ms(lambda: joint_ll(rows, c), reps=20)
        us1 = device_time_per_launch(lambda: joint_ll(rows, c), reps=20,
                                     want="joint_ll_kernel")[0].get(
                                         "joint_ll_kernel")
        plain1 = cuda_ms(lambda: joint_ll_plain(rows, c), reps=3)
        flops = joint_ll_flops(c)
        bound1 = 1e3 * max(joint_ll_bytes(c, B_LL) / PEAK_BYTES_S,
                           flops * B_LL / PEAK_F32_S)
        print(f"[14] {tag} (D={D}, {flags}): kernel 1 on {B_LL} rows "
              f"({n_veto} vetoed): max |err| {err1:.4g} vs plain f32, "
              f"{err64:.4g} vs plain f64; {ms1:.4f} ms ("
              + (f"{us1:.2f} us on the device" if us1 else
                 "device us not measured")
              + f"; plain {plain1:.3f} ms, bound {bound1:.4f} ms: "
              f"{flops} FP32 operations a walker) on {card}")
        step_seed = int(np.random.default_rng(seed + 20).integers(
            0, 2 ** 31 - 1))
        rng = np.random.default_rng(seed + 21)
        errs, steps = {}, {}
        for k, betas in ((1, np.ones(1)), (K, default_betas(K))):
            errs[k] = compare_steps(*family_start(c, center, k, W, rng),
                                    betas, c, step_seed, STEPS_CMP_FAM,
                                    f"[14] {tag}:")[3]
            x, lp, acc = family_start(c, center, k, W, rng)
            beta, db = rung_tensors(betas, c.device)
            sacc = torch.zeros(max(k - 1, 1), dtype=torch.int32,
                               device=c.device)
            fn = lambda: stretch_steps(x, lp, acc, sacc, beta, db,  # noqa
                                       step_seed, n, c)
            ms = cuda_ms(fn, reps=3, warmup=1)
            us = device_time_per_launch(fn, reps=3,
                                        want="stretch_steps_kernel")[0].get(
                                            "stretch_steps_kernel")
            x, lp, acc = family_start(c, center, k, W, rng)
            plain = cuda_ms(lambda: steps_plain(
                x, lp, acc, beta, db.tolist(), step_seed, n,
                philox_stream(step_seed, c.device),
                lambda th: joint_ll_plain(th, c)), reps=1, warmup=0)
            bound = steps_bound(c, k, W, n)
            steps[k] = (ms, plain, bound)
            print(f"[14] {tag}: step kernel K={k}, W={W}: "
                  f"{1e3 * ms / n:.2f} us per step by CUDA events, "
                  + (f"{us / n:.2f} us of device time" if us else
                     "device time not measured")
                  + f" (bound {1e3 * bound / n:.2f} us; plain "
                  f"{plain / n:.2f} ms a step) on {card}")
        base = dict(route="cuda", library_ms=None, bound_by="operations")
        entries += [
            dict(base, name=f"joint_ll[{tag}]",
                 source="joxsz_torch/csrc/joint_ll.cu",
                 replaces="joxsz_tpu/ops/pallas_joint.py:1033",
                 max_abs_err=err1, ms=ms1, plain_ms=plain1, bound_ms=bound1,
                 bound_by=("bytes" if joint_ll_bytes(c, B_LL) / PEAK_BYTES_S
                           > flops * B_LL / PEAK_F32_S else "operations")),
            dict(base, name=f"stretch_steps[{tag}]",
                 source="joxsz_torch/csrc/stretch_step.cu",
                 replaces="joxsz_tpu/ops/pallas_joint.py:1242",
                 max_abs_err=errs[1], ms=steps[1][0], plain_ms=steps[1][1],
                 bound_ms=steps[1][2]),
            dict(base, name=f"stretch_steps_tempered[{tag}]",
                 source="joxsz_torch/csrc/stretch_step.cu",
                 replaces="joxsz_tpu/ops/pallas_joint.py:2105",
                 max_abs_err=errs[K], ms=steps[K][0], plain_ms=steps[K][1],
                 bound_ms=steps[K][2])]
        if tag == "config4":
            from joxsz_torch.ops.coupled_kernel import (coupled_half,
                                                        coupled_half_plain)

            x0, lp0, _ = family_start(c, center, 1, W, rng)
            _, n_near, e6, _, _, _ = compare_coupled(x0[0], lp0[0], c,
                                                     step_seed, 2)
            H_loc = FAMILY_MESH_W // 2
            xm, lm = x0[0, :H_loc].clone(), lp0[0, :H_loc].clone()
            am = torch.zeros_like(lm)
            fixed = x0[0, W // 2:W // 2 + H_loc].contiguous()
            run6 = lambda: coupled_half(xm, lm, am, fixed, 0,  # noqa: E731
                                        step_seed, 0, 0, c)
            ms6 = cuda_ms(run6, reps=50)
            b = philox_stream(step_seed, c.device)(0, 0, H_loc, 4)
            plain6 = cuda_ms(lambda: coupled_half_plain(
                xm, lm, am, fixed, 0, b,
                lambda th: joint_ll_plain(th, c)), reps=5)
            bound6, by6 = coupled_bound(c, H_loc, H_loc)
            print(f"[14] {tag}: kernel 6 over 2 shards at W={W}, "
                  f"{STEPS_CMP_COUPLED} steps == the step kernel at K=1 "
                  f"after every step, {n_near} near-threshold differences "
                  f"vs plain, max |lp err| {e6:.4g}; {ms6:.4f} ms at "
                  f"{H_loc} rows against {H_loc} (the mesh fit's shard; "
                  f"plain {plain6:.3f} ms, bound {bound6:.5f} ms by {by6})")
            entries.append(dict(
                base, name=f"coupled_half[{tag}]",
                source="joxsz_torch/csrc/stretch_step.cu",
                replaces="joxsz_tpu/ops/pallas_joint.py:1657",
                max_abs_err=e6, ms=ms6, plain_ms=plain6, bound_ms=bound6,
                bound_by=by6))
        del sess, c
    return entries


def family_fit(tag: str, seed: int, base: str):
    """One model family's fit through ``run.main`` (a child process of
    phase 15): the launch counters set to 0 just before it and read just
    after; prints what phase 15 checks as a JSON line, last."""
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.config import JoXSZConfig, MCMCConfig
    from joxsz_torch.sampling.kernel import chain_chunk_schedule
    from joxsz_torch.synth import config_json

    _, flags, D, how = {f[0]: f for f in FAMILIES + (FAMILY_MESH_FIT,)}[tag]
    cfg = JoXSZConfig.from_json(open(base).read())
    argv = list(flags)
    if how == "production":
        cfg.mcmc = MCMCConfig.converged_gpu()
        if tag == "config4":
            argv += ["--auto-extend", str(CONFIG4_EXTEND)]
    else:
        cfg.mcmc = MCMCConfig(nwalkers=W_SMOKE, n_temper_rungs=K_SMOKE)
        argv.append("--quick")
    if how == "mesh":
        argv += ["--mesh", "1", "--walkers", str(FAMILY_MESH_W), "--temper",
                 "0"]
    cfg.mcmc.seed = seed
    cfg.save_dir = cfg.plot_dir = f"{base}.{tag}"
    path = config_json(cfg, f"{base}.{tag}.json")
    zero_launches()
    t0 = time.time()
    res = run.main(["--config", path] + argv + plot_flags())
    wall = time.time() - t0
    launches = read_launches()
    f64 = f64_tier_pairs()
    t = res.timings
    m = cfg.mcmc
    nburn, nsteps, nthin, prelim = ((200, 400, 5, 100) if "--quick" in argv
                                    else (m.nburn, m.nsteps, m.nthin,
                                          m.prelim_iterations))
    n1 = t["prelim_rounds"] * len(chain_chunk_schedule(prelim, 1)) + len(
        chain_chunk_schedule(nburn, 1))
    n4 = (1 + t["auto_extend_rounds"]) * len(chain_chunk_schedule(nsteps,
                                                                  nthin))
    print(json.dumps({
        "tag": tag, "wall": wall, "mle_s": t["mle_s"],
        "mle_device": t["mle_device"], "split_rhat": t["split_rhat"],
        "acceptance": float(np.mean(res.acceptance_fraction)),
        "launches": launches, "want": [n1, n4 if how != "mesh" else 0],
        "f64_pairs": f64,
        "shape": list(res.chain.shape), "D": D,
        "finite": bool(np.all(np.isfinite(res.chain))
                       and np.all(np.isfinite(res.log_prob)))}))


def phase_family_fits(cfg, tmp: str, seed: int) -> dict:
    """Phase 15: every model family fitted through ``run.main`` with its
    flags, each in a child process of its own, all at once (their float64
    MLEs run on the host's cores): config #4 and SZ-only at the card's
    production schedule (config #4 with an auto-extend budget of
    CONFIG4_EXTEND), config #4 over a mesh of one card at 32 walkers (the
    coupled sampler), the others --quick at W=1024 x K=4.  Checks finite
    chains of the family's width, acceptance in FAMILY_ACCEPTANCE, one
    step-kernel launch per chunk (kernel 6 for the mesh fit), and split-
    R-hat <= 1.01 for config #4's production fit.  Returns each fit's
    record (launches by kernel)."""
    import os
    from joxsz_torch.synth import config_json

    base = config_json(cfg, f"{tmp}/family_base.json")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    fits = FAMILIES + (FAMILY_MESH_FIT,)
    print(f"[15] family fits through the CLI, {len(fits)} child processes "
          "at once: " + ", ".join(f"{t} ({h})" for t, _, _, h in fits))
    procs = []
    try:
        for tag, _, _, _ in fits:
            log = open(f"{tmp}/family_{tag}.log", "w")
            procs.append((tag, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--family-fit",
                 tag, "--seed", str(seed), "--base", base],
                stdout=log, stderr=subprocess.STDOUT, env=env)))
        t_end = time.time() + FAMILY_FIT_TIMEOUT
        for tag, log, proc in procs:
            proc.wait(timeout=max(1.0, t_end - time.time()))
            log.close()
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out = {}
    for tag, _, proc in procs:
        text = open(f"{tmp}/family_{tag}.log").read()
        lines = text.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"family fit {tag} failed (rc "
                                 f"{proc.returncode}):\n" + text[-3000:])
        r = json.loads(lines[-1])
        for line in lines:
            if line.startswith(("session built", "wall time", "split-Rhat",
                                "acceptance")):
                print(f"[15] {tag}: {line}")
        L = r["launches"]
        print(f"[15] {tag}: {r['wall']:.1f} s, MLE {r['mle_s']:.1f} s on "
              f"the {r['mle_device']}, split-R-hat {r['split_rhat']:.4f}, "
              f"acceptance {r['acceptance']:.3f}, launches {L}, the mass "
              f"veto's float64-tier pairs {r['f64_pairs']}")
        check(r["finite"] and r["shape"][1:] == [
            FAMILY_MESH_W if tag == "config4_mesh" else W_SMOKE, r["D"]],
            f"{tag}: chain {r['shape']} or non-finite values")
        lo, hi = FAMILY_ACCEPTANCE
        check(lo < r["acceptance"] < hi,
              f"{tag}: acceptance {r['acceptance']} outside ({lo}, {hi})")
        n1, n4 = r["want"]
        check(L["joint_ll"] > 0 and L["stretch_steps"] == n1
              and L["stretch_steps_tempered"] == n4,
              f"{tag}: launches {L}, want {n1} + {n4} step-kernel launches")
        if tag == "config4_mesh":
            check(L["coupled_half"] > 0, f"{tag}: kernel 6 not launched")
        if tag == "config4":
            check(r["split_rhat"] <= 1.01,
                  f"{tag}: split-R-hat {r['split_rhat']} > 1.01")
        out[tag] = r
    return out


# ---- the survey made whole and tables on the card (phases 17 and 18) -------

def cluster_grid_start(stack, truths, w: int, rng):
    """A (C, w, D) state, cluster c within 1% of ``truths[c]``, rows
    redrawn until every log-posterior (kernel 1 on cluster c's constants)
    is finite; lp by kernel 1 and zero accept counts."""
    import torch

    xs, lps = [], []
    for cc, center in zip(stack.clusters, truths):
        x, lp, _ = family_start(cc, center, 1, w, rng)
        xs.append(x[0])
        lps.append(lp[0])
    x = torch.stack(xs).contiguous()
    lp = torch.stack(lps)
    return x, lp, torch.zeros_like(lp)


def phase_cluster_grid_families(cfg, seed: int) -> tuple[list, dict]:
    """Phase 17a: kernel 4's family instance for each model family on a
    stack of C_SURVEY simulated clusters (distinct data, shared grids)
    against its plain step for STEPS_CMP_FAM steps, as phase 8 holds the
    flagship's, and one launch of TIME_STEPS_FAM steps at W=1024 timed
    beside its bound.  Returns the kernels-line entries (launches from
    phase 17b) and each family's ``family_key``."""
    import numpy as np
    from joxsz_torch.ops.consts_layout import family_key
    from joxsz_torch.ops.joint_kernel import joint_ll_flops, pack_consts_stack
    from joxsz_torch.ops.multicluster_kernel import (
        multicluster_bits, steps_multicluster_plain, stretch_steps_multicluster)
    from joxsz_torch.simulate import simulate_survey
    from joxsz_torch.survey import mock_truths

    card = card_line()
    C, W, n = C_SURVEY, W_SMOKE, TIME_STEPS_FAM
    entries, keys = [], {}
    for tag, flags, D, _ in FAMILIES:
        if tag == "widest":
            continue
        sess = family_session(cfg, flags)
        truths = mock_truths(sess.params, C)
        survey = simulate_survey(sess.model, truths,
                                 np.random.default_rng(seed + 30))
        stack = pack_consts_stack(sess, survey.sz_stack, survey.xray_stack)
        keys[tag] = family_key(stack.ints)
        check(stack.ints["D"] == D, f"{tag}: stack D {stack.ints['D']}")
        step_seed = int(np.random.default_rng(seed + 31).integers(
            0, 2 ** 31 - 1))
        rng = np.random.default_rng(seed + 32)
        x, lp, acc = cluster_grid_start(stack, truths, W, rng)
        _, _, _, n_dec, n_near, err = compare_cluster_grid(
            x, lp, acc, stack, step_seed, STEPS_CMP_FAM)
        x, lp, acc = cluster_grid_start(stack, truths, W, rng)
        fn = lambda: stretch_steps_multicluster(            # noqa: E731
            x, lp, acc, step_seed, n, stack)
        ms = cuda_ms(fn, reps=3, warmup=1)
        per = device_time_per_launch(fn, reps=3, want="stretch_steps")[0]
        us = next((v for k, v in per.items()
                   if k.startswith("stretch_steps")), None)
        if us is None:
            print(f"[17] {tag}: the profiler recorded {sorted(per)}")
        x, lp, acc = cluster_grid_start(stack, truths, W, rng)
        plain = cuda_ms(lambda: steps_multicluster_plain(
            x, lp, acc, n, lambda step, which: multicluster_bits(
                step_seed, x.device, step, which, C, W // 2), stack),
            reps=1, warmup=0)
        flops = joint_ll_flops(stack.clusters[0]) * C * W * n
        nbytes = 4 * (2 * C * W * (D + 2) + stack.buf.numel())
        bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
        print(f"[17] {tag} (D={D}): kernel 4's family instance on C={C} "
              f"clusters, W={W}: {STEPS_CMP_FAM} steps, {n_dec} half-step "
              f"decisions, {n_near} steps where a decision within {MARGIN} "
              f"of its threshold went the other way, max |lp err| "
              f"{err:.4g}; one launch of {n} steps {ms:.4f} ms = "
              f"{1e3 * ms / n:.2f} us per step ("
              + (f"{us / n:.2f} us of device time" if us else
                 "device time not measured")
              + f"; plain {plain:.1f} ms, bound {bound:.4f} ms) on {card}")
        entries.append(dict(
            name=f"stretch_steps_multicluster[{tag}]", route="cuda",
            source="joxsz_torch/csrc/stretch_step.cu",
            replaces="joxsz_tpu/ops/pallas_joint.py:1859",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S
                      else "operations"), library_ms=None))
        del sess, stack, survey
    return entries, keys


def write_family_spec(cfg, tmp: str, seed: int):
    """C_SURVEY mock clusters of every family of SURVEY_MIX, each a
    dataset of its own (``synth.write_observation``) simulated from the
    family's model at ``survey.mock_truths`` (the truths the walkers start
    beside, as ``survey --mock`` draws them); the spec lists them family
    by family.  Returns (spec path, {cluster name: (tag, truth by
    parameter)})."""
    import copy
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.simulate import simulate_survey
    from joxsz_torch.survey import mock_truths
    from joxsz_torch.synth import config_json, write_observation

    entries, truths = [], {}
    rng = np.random.default_rng(seed + 40)
    for tag, flags in SURVEY_MIX:
        args = run.build_parser().parse_args(list(flags))
        fcfg = run.apply_model_flags(copy.deepcopy(cfg), args)
        sess = family_session(cfg, flags)
        th = mock_truths(sess.params, C_SURVEY)
        survey = simulate_survey(sess.model, th, rng)
        for k, obs in enumerate(survey.mocks):
            name = f"{tag}{k}"
            kcfg = write_observation(fcfg, obs, f"{tmp}/spec/{name}")
            kcfg.name = name
            entries.append({"name": name, "config": config_json(
                kcfg, f"{tmp}/spec/{name}.json")})
            truths[name] = (tag, dict(zip(sess.params.thawed, th[k])))
        del sess, survey
    spec = f"{tmp}/spec/survey.json"
    with open(spec, "w") as f:
        json.dump({"clusters": entries}, f)
    return spec, truths


def phase_survey_families(cfg, tmp: str, seed: int, keys: dict) -> dict:
    """Phase 17b: ``survey.main`` on a --spec that mixes every family of
    SURVEY_MIX (C_SURVEY clusters each, W=1024, 1000 burn + 1000 steps,
    --save-chains) with the launch counters set to 0 just before it and
    read just after, and the survey's fallback warning an error: every
    group on kernel 4 (two launches each: burn, sampling), every truth
    within 5 sd of its median, one chain file per cluster; then
    ``--population P_0`` on a ``--mock 8`` flagship survey.  Returns the
    launches of kernel 4 per family tag."""
    import warnings
    import numpy as np
    from joxsz_torch import survey
    from joxsz_torch.io.checkpoint import load_chain
    from joxsz_torch.ops.multicluster_kernel import stretch_steps_multicluster
    from joxsz_torch.synth import config_json

    t0 = time.time()
    spec, truths = write_family_spec(cfg, tmp, seed)
    n_cl = len(truths)
    print(f"[17] mixed-family spec of {n_cl} clusters written in "
          f"{time.time() - t0:.1f} s: " + ", ".join(
              f"{t} x {C_SURVEY}" for t, _ in SURVEY_MIX))
    out = f"{tmp}/spec/summary.json"
    zero_launches()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*specialisation.*")
        bundles = survey.main(["--spec", spec, "--walkers", str(W_SMOKE),
                               "--seed", str(seed), "--save-chains",
                               "--out", out])
    wall = time.time() - t0
    launches = read_launches()
    by_family = dict(stretch_steps_multicluster.launches_by_family)
    summary = json.loads(open(out).read())
    check(isinstance(bundles, list) and len(bundles) == len(SURVEY_MIX),
          f"mixed spec: {len(bundles)} family results")
    check(summary["param_names"] is None
          and len(summary["families"]) == len(SURVEY_MIX),
          "mixed spec: the summary's families")
    names = [c["name"] for c in summary["clusters"]]
    check(names == list(truths), f"mixed spec: cluster order {names}")
    worst = {}
    for c in summary["clusters"]:
        tag, truth = truths[c["name"]]
        pulls = [abs(c["median"][k] - v) / max(c["sd"][k], 1e-12)
                 for k, v in truth.items()]
        worst[tag] = max(worst.get(tag, 0.0), max(pulls))
        check(max(pulls) < 5.0, f"{c['name']}: a truth lies "
              f"{max(pulls):.1f} sd from its median")
        lo, hi = FAMILY_ACCEPTANCE
        check(lo < c["acceptance"] < hi,
              f"{c['name']}: acceptance {c['acceptance']}")
    for fres, specs in bundles:
        check(fres.timings is not None and np.all(np.isfinite(
            fres.chain)), f"group {fres.param_names[:3]}: kernel route")
    suffix = survey.chain_suffix()
    for name in names:
        d = load_chain(f"{tmp}/spec/{name}_chain{suffix}")
        check(d["chain"].shape[1:] == (W_SMOKE, len(truths[name][1]))
              and d["burn"] == 1000, f"{name}: chain file")
    per_tag = {tag: by_family.get(keys[tag], 0) for tag in keys}
    check(all(per_tag[t] == 2 for t, _ in SURVEY_MIX if t in per_tag)
          and launches["stretch_steps_multicluster"] == 2 * len(SURVEY_MIX),
          f"mixed spec launches {launches}, by family {per_tag}")
    print(f"[17] mixed-family survey in {wall:.1f} s: {n_cl} clusters in "
          f"{len(bundles)} families, largest pull per family "
          + ", ".join(f"{t} {v:.2f}" for t, v in worst.items())
          + f" sd; kernel 4 launches {launches['stretch_steps_multicluster']}"
          f" (by family {per_tag}), kernel 1 {launches['joint_ll']}; "
          f"{n_cl} chain files ({suffix})")

    path = config_json(cfg, f"{tmp}/pop_base.json")
    out = f"{tmp}/pop_summary.json"
    t0 = time.time()
    res = survey.main(["--mock", "8", "--config", path, "--walkers",
                       str(W_SMOKE), "--seed", str(seed), "--population",
                       "P_0", "--out", out])
    pop = json.loads(open(out).read())["population"]
    lm = np.log(res.medians[:, res.param_names.index("P_0")])
    check(np.isfinite([pop["mu"], pop["sigma"]]).all()
          and lm.min() - 0.5 < pop["mu"] < lm.max() + 0.5,
          f"population {pop}")
    print(f"[17] --mock 8 --population P_0 in {time.time() - t0:.1f} s: "
          f"<ln P_0> = {pop['mu']:.4f} +- {pop['mu_sd']:.4f}, scatter "
          f"{pop['sigma']:.4f} +- {pop['sigma_sd']:.4f}, acceptance "
          f"{pop['acceptance']:.3f}, min weight n_eff "
          f"{pop['weight_n_eff_min']:.0f} of {pop['n_samples']}")
    return per_tag


def phase_tables(tmp: str, seed: int):
    """Phase 18: the count-rate table of a synthetic ~1000 x 1024 response
    generated on the card against the CPU (rtol 1e-10), both timed; then a
    synthetic cluster at z = 0.5 with no ``table_path`` fitted through
    ``run.main --quick --no-plots`` with the tables directory in ``tmp``:
    the table is generated there on the card, then the fit runs."""
    import numpy as np
    import torch
    from joxsz_torch import build, run
    from joxsz_torch.synth import (CL1226_BANDS_EV, config_json,
                                   write_synthetic_dataset,
                                   write_synthetic_response)
    from joxsz_torch.tablegen import TableSpec, generate_table

    rmf, arf = write_synthetic_response(pathlib.Path(f"{tmp}/resp"))
    spec = TableSpec(rmf=rmf, arf=arf, bands_eV=tuple(
        tuple(b) for b in CL1226_BANDS_EV), z=0.5, NH_1022pcm2=0.0183)
    times = {}
    for dev in ("cuda", "cpu"):
        tab = None
        for _ in range(2):              # the second call is timed
            t0 = time.time()
            tab = generate_table(spec, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            times[dev] = time.time() - t0
        if dev == "cuda":
            card_tab = tab
    worst = 0.0
    for k in ("lograte_Z0", "lograte_Z1", "logflux_Z0", "logflux_Z1"):
        a, b = card_tab[k], tab[k]
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
        check(np.allclose(a, b, rtol=1e-10, atol=0),
              f"table {k}: card vs CPU differ by {worst:.3g} relative")
    print(f"[18] count-rate table (1000 energies x 1024 channels, 10 bands, "
          f"64 T x 2 Z) on the card {times['cuda']:.3f} s, on the host CPU "
          f"{times['cpu']:.3f} s; largest relative gap {worst:.3g}")

    cfg = write_synthetic_dataset(f"{tmp}/z05", seed, redshift=0.5,
                                  response=True)
    check(cfg.xray.table_path is None, "z = 0.5 dataset has a table_path")
    cfg.save_dir = f"{tmp}/z05/out"
    path = config_json(cfg, f"{tmp}/z05/cfg.json")
    tables = pathlib.Path(f"{tmp}/tables")
    old = build.TABLES_DIR
    build.TABLES_DIR = tables
    try:
        t0 = time.time()
        res = run.main(["--config", path, "--quick", "--seed", str(seed)]
                       + plot_flags())
        wall = time.time() - t0
    finally:
        build.TABLES_DIR = old
    made = sorted(tables.glob("ctrate_*.npz"))
    acc = float(np.mean(res.acceptance_fraction))
    check(len(made) == 1, f"generated tables {made}")
    check(np.all(np.isfinite(res.chain)) and 0.1 < acc < 0.6,
          f"z = 0.5 fit: acceptance {acc} or non-finite chain")
    print(f"[18] z = 0.5 cluster without a table: {made[0].name} generated "
          f"on the card, then fitted in {wall:.1f} s (MLE "
          f"{res.timings['mle_s']:.1f} s), acceptance {acc:.3f}")
    return times


# ---- Laplace, evidence, HMC/NUTS and SBC on the card (phases 19-22) -------

def on_card(t, what: str):
    check(t.is_cuda, f"{what} lies on {t.device}, not on the card")


def phase_laplace(cfg, path: str, res5):
    """Phase 19: ``run --laplace`` through ``run.main`` on phase 5's
    config: the JSON keys of the JAX package's quick-look, the card's
    float64 Hessian at the MAP against the host CPU's (rtol
    LAPLACE_RTOL), ok, the pinned parameters, and the Laplace sd beside
    phase 5's posterior sd."""
    import numpy as np
    import torch
    from joxsz_torch import run
    from joxsz_torch.build import build_session
    from joxsz_torch.sampling.laplace import laplace_approximation

    t0 = time.time()
    res = run.main(["--config", path, "--laplace"])
    wall = time.time() - t0
    out = json.loads(open(f"{cfg.save_dir}/{cfg.name}_laplace.json").read())
    check(set(out) == set(LAPLACE_KEYS), f"laplace JSON keys {sorted(out)}")
    check(np.isfinite(res.log_post_map), "non-finite log-posterior at MAP")
    # the Hessian at the MAP on the card and on the host CPU, float64
    hs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        m64 = build_session(cfg, device=dev).model
        th = torch.as_tensor(res.theta_map, dtype=torch.float64, device=dev)
        if dev == "cuda":
            on_card(m64.sz_data.L, "the Laplace model")
        t1 = time.time()
        r = laplace_approximation(m64.log_like, th, m64.params.lo,
                                  m64.params.hi)
        secs[dev] = time.time() - t1
        hs[dev] = r.hessian
    scale = np.abs(hs["cpu"]).max()
    rel = float(np.max(np.abs(hs["cuda"] - hs["cpu"])) / scale)
    elem = np.abs(hs["cuda"] - hs["cpu"]) <= LAPLACE_RTOL * np.maximum(
        np.abs(hs["cpu"]), 1e-8 * scale)
    check(bool(elem.all()), f"Hessian card vs CPU: max gap {rel:.3g} "
          f"of its scale, {int((~elem).sum())} elements past rtol "
          f"{LAPLACE_RTOL}")
    names = res5.param_names
    sd5 = res5.flat_chain.std(axis=0)
    sd = res.sd if res.ok else res.sd_conditional
    pinned = [n for n, b in zip(names, res.at_boundary) if b]
    cols = ", ".join(f"{n} {a:.3g}/{b:.3g}" for n, a, b in zip(names, sd, sd5))
    print(f"[19] run --laplace in {wall:.1f} s: ok {res.ok}, pinned "
          f"{pinned or 'none'}, log_z_normalized {res.log_z_normalized}; "
          f"Hessian on the card {secs['cuda']:.2f} s, host CPU "
          f"{secs['cpu']:.2f} s, max gap {rel:.3g} of its scale (each "
          f"element within rtol {LAPLACE_RTOL}); Laplace sd / phase 5's "
          f"posterior sd: {cols}")
    return res


def phase_evidence(cfg, seed: int):
    """Phase 20: ``model_evidence`` on the card for gNFW and knots on the
    same data (EVIDENCE rungs x walkers, burn + steps, thin; the JAX
    defaults are 16 x 128, 2000 + 2000, thin 10): both log Z and errors
    finite, every bridge's swap acceptance > 0, seconds per ladder step."""
    import copy
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.build import build_session
    from joxsz_torch.sampling.evidence import model_evidence

    K, W, n_burn, n_steps, thin = EVIDENCE
    out = {}
    for tag, flags in (("gnfw", ()), ("knots", ("--pressure", "knots"))):
        args = run.build_parser().parse_args(list(flags))
        sess = build_session(run.apply_model_flags(copy.deepcopy(cfg), args),
                             device="cuda")
        t0 = time.time()
        res = model_evidence(sess.model, n_rungs=K, n_walkers=W,
                             n_steps=n_steps, n_burn=n_burn, thin=thin,
                             seed=seed)
        secs = time.time() - t0
        on_card(res.final_state[0], "the ladder's walkers")
        check(np.isfinite(res.log_z) and np.isfinite(res.log_z_err),
              f"{tag}: log Z {res.log_z} +- {res.log_z_err}")
        check(bool((res.swap_acceptance > 0).all()),
              f"{tag}: a bridge swapped nothing {res.swap_acceptance}")
        out[tag] = res
        print(f"[20] model_evidence {tag} (D={sess.params.ndim}; cut: "
              f"K={K} x W={W}, {n_burn} burn + {n_steps} steps, thin "
              f"{thin}): log Z {res.log_z:.3f} +- {res.log_z_err:.3f} (TI "
              f"{res.log_z_ti:.4g}), swap rates "
              f"{np.round(res.swap_acceptance, 3).tolist()}, acceptance "
              f"{res.acceptance_fraction.mean():.3f}; {secs:.1f} s, "
              f"{1e3 * secs / (n_burn + n_steps):.2f} ms per ladder step")
    print(f"[20] log Bayes factor gnfw - knots: "
          f"{out['gnfw'].log_z - out['knots'].log_z:.3f} +- "
          f"{np.hypot(out['gnfw'].log_z_err, out['knots'].log_z_err):.3f}")
    return out


def phase_gradient_samplers(cfg, res5, seed: int):
    """Phase 21: ``run_hmc`` and ``run_nuts`` on the flagship posterior
    (the float64 model on the card), from a 1% cloud around phase 5's
    MLE with the mass from phase 5's posterior variance (HMC_CUT): the
    acceptance statistic in ACCEPT_BAND, a finite step size, and
    gradients (one forward and backward pass of a row) per second."""
    import numpy as np
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.sampling.hmc import run_hmc
    from joxsz_torch.sampling.nuts import run_nuts
    from joxsz_torch.sampling.stretch import generate_init_positions

    sess = build_session(cfg, device="cuda")
    model, p = sess.model, sess.params
    C, hmc_warm, hmc_steps, n_leap, nuts_warm, nuts_steps, depth = HMC_CUT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.no_grad():
        p0 = generate_init_positions(model.log_like_batch, res5.mle_theta, C,
                                     gen, device="cuda",
                                     dtype=torch.float64, spread=0.01,
                                     lo=p.lo, hi=p.hi)
    on_card(p0, "the chains")
    mass = 1.0 / np.var(res5.flat_chain, axis=0)
    rows = [0]

    def log_prob(x):
        rows[0] += x.shape[0]
        return model.log_like_batch(x)

    for name, fn, kw in (
            ("HMC", run_hmc, dict(n_steps=hmc_steps, n_warmup=hmc_warm,
                                  n_leapfrog=n_leap)),
            ("NUTS", run_nuts, dict(n_steps=nuts_steps, n_warmup=nuts_warm,
                                    max_depth=depth, adapt_mass=False))):
        rows[0] = 0
        t0 = time.time()
        res = fn(log_prob, p0, gen=gen, mass_diag=mass, **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        on_card(res.final_state[0], f"{name}'s chains")
        acc = (float(res.acceptance_fraction.mean()) if name == "HMC"
               else res.mean_accept_prob)
        check(ACCEPT_BAND[0] <= acc <= ACCEPT_BAND[1],
              f"{name} acceptance {acc} outside {ACCEPT_BAND}")
        check(np.isfinite(res.step_size) and res.step_size > 0,
              f"{name} step size {res.step_size}")
        check(np.all(np.isfinite(res.log_prob)), f"{name}: non-finite lp")
        extra = (f", mean tree depth {res.mean_tree_depth:.2f}"
                 if name == "NUTS" else "")
        med = np.median(res.chain.reshape(-1, p.ndim), axis=0)
        pull = np.abs(med - np.median(res5.flat_chain, axis=0)) \
            / res5.flat_chain.std(axis=0)
        print(f"[21] {name} (C={C}, {kw}): acceptance {acc:.3f}, step "
              f"size {res.step_size:.4g}{extra}; {rows[0]} gradients in "
              f"{secs:.1f} s = {rows[0] / secs:.0f} gradients/s; largest "
              f"|median - phase 5's| {pull.max():.2f} sd")


def sbc_stack_check(sess, res, C: int, W: int, seed: int, err8: float,
                    box: str) -> tuple[float, float]:
    """Kernel 4 against its plain step for STEPS_CMP_MC steps on the
    constants stack ``run_sbc`` packed for ``res`` (C clusters, W walkers)
    from its init state, the stored lp against a fresh kernel-1
    evaluation, and kernel 1 against its plain version at that init
    state.  Returns kernel 4's largest lp error against the plain step
    and kernel 1's against its plain version."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import pack_consts_stack
    from joxsz_torch.ops.multicluster_kernel import (multicluster_ll,
                                                     multicluster_ll_plain)
    from joxsz_torch.sampling.batched import batched_init
    from joxsz_torch.sampling.sbc import sbc_mocks

    thetas, survey = sbc_mocks(sess.model, C, seed)
    check(np.array_equal(thetas, res.thetas_true),
          "sbc_mocks draws other truths than run_sbc")
    stack = pack_consts_stack(sess, survey.sz_stack, survey.xray_stack)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = batched_init(lambda th: multicluster_ll(th, stack), thetas, W, gen,
                     device=sess.device, dtype=torch.float32,
                     spread=0.05).contiguous()
    on_card(x, "the SBC init state")
    lp = multicluster_ll(x, stack)
    # kernel 1 on each cluster's constants against its plain version:
    # within TIGHT_ATOL below TIGHT_BELOW, within TIGHT_RTOL above
    plain = multicluster_ll_plain(x, stack)
    check(torch.equal(torch.isfinite(lp), torch.isfinite(plain))
          and bool(torch.isfinite(lp).all()), f"SBC init ({box}): kernel "
          "1's -inf mask differs from the plain version's, or a walker is "
          "vetoed")
    gap = (lp - plain).abs()
    err1 = float(gap.max())
    lim = torch.clamp(TIGHT_RTOL * plain.abs(), min=TIGHT_ATOL)
    worst = int(torch.argmax(gap / lim))
    check(bool((gap <= lim).all()), f"SBC init ({box}): kernel 1 vs plain "
          f"f32: |err| {float(gap.flatten()[worst])} at lp "
          f"{float(plain.flatten()[worst])} over max({TIGHT_ATOL}, "
          f"{TIGHT_RTOL:.1e} |lp|)")
    # a threshold holds two log-posteriors, each up to the cluster's peak
    # (about its truth's)
    peak = torch.maximum(plain.abs().amax(dim=1), multicluster_ll(
        torch.as_tensor(thetas, dtype=torch.float32, device=x.device)[:, None]
        .contiguous(), stack)[:, 0].abs())
    tol = 2 * torch.clamp(TIGHT_RTOL * peak, min=TIGHT_ATOL)[:, None]
    acc = torch.zeros((C, W), dtype=torch.float32, device=x.device)
    x, lp, acc, n_dec, n_near, err = compare_cluster_grid(
        x, lp, acc, stack, 2 * seed + 1, STEPS_CMP_MC, tol)
    check(torch.equal(multicluster_ll(x, stack), lp), f"SBC stack ({box}): "
          "stored lp differs from a fresh kernel-1 evaluation on each "
          "cluster's constants")
    print(f"[22] kernel 4 on run_sbc's stack ({box}; C={C}, W={W}, its "
          f"init state, the burn's seed): {STEPS_CMP_MC} steps, {n_dec} "
          f"half-step decisions, {n_near} steps where a decision within "
          f"{MARGIN} of its threshold went the other way; max |lp err| "
          f"{err:.4g} (phase 8, C={C_SURVEY}, W={W_SMOKE}: {err8:.4g}); "
          "stored lp == fresh kernel 1 per cluster; threshold tolerance "
          f"{float(tol.min()):.3g}-{float(tol.max()):.3g}; kernel 1 at the "
          f"init state ({C} x {W} rows, lp {float(plain.min()):.6g} to "
          f"{float(plain.max()):.6g}) vs plain f32: max |err| {err1:.4g}")
    return err, err1


def phase_sbc(cfg, seed: int, err8: float) -> tuple[int, float, float]:
    """Phase 22: ``run_sbc`` on the card (SBC_CUT replications, walkers,
    burn + steps, thin; the prior box SBC_BOX) through kernel 4, its
    launch counter set to 0 just before: launches > 0, no StackMismatch
    and no warning, ranks in [0, L], thetas_true bit for bit the host
    CPU's for the same seed; then ``sbc_stack_check`` on its stack; the
    float32 checks of ``run_sbc`` on kernel 1 for SBC_BOX and the
    production box: ``float32_vetoed`` within F32_VETO_TOLERANCE on both,
    and ``float32_misfits`` on SBC_MOCKS replications, none for SBC_BOX
    and printed for both; run_sbc
    on the production box (SBC_PROD_REPS replications) refused on its
    mock data, not on the veto;
    then ``EnsembleSampler(vectorize=True)`` on the card on the model's
    ``log_like_batch``, 200 steps.  Returns kernel 4's launches, its
    largest lp error against the plain step here and kernel 1's against
    its plain version."""
    import warnings
    import numpy as np
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.emcee_compat import EnsembleSampler
    from joxsz_torch.sampling.priors import model_log_prior, sample_prior
    from joxsz_torch.sampling.sbc import (F32_CHECK_DRAWS, F32_MOCK_ATOL,
                                          F32_MOCK_RTOL, F32_VETO_TOLERANCE,
                                          float32_misfits, float32_vetoed,
                                          prior_truths, run_sbc, sbc_mocks)
    from joxsz_torch.synth import truth_theta

    def session(dev, box):
        sess = build_session(cfg, device=dev)
        p = sess.params
        for name, (lo, hi) in box.items():
            p[name].minval, p[name].maxval = lo, hi
        p._refresh()
        return sess

    C, W, n_burn, n_steps, thin = SBC_CUT
    sess = session("cuda", SBC_BOX)
    on_card(sess.model.sz_data.L, "the SBC session")
    zero_launches()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = run_sbc(sess, C, n_walkers=W, n_burn=n_burn, n_steps=n_steps,
                      thin=thin, seed=seed)
    secs = time.time() - t0
    launches = read_launches()
    k4 = launches["stretch_steps_multicluster"]
    check(k4 > 0 and launches["joint_ll"] > 0,
          f"run_sbc did not run on kernel 4: {launches}")
    L = (n_steps // thin) * W
    check(res.n_draws == L and res.ranks.min() >= 0
          and res.ranks.max() <= L, f"ranks outside [0, {L}]")
    truths = prior_truths(session("cpu", SBC_BOX).model, C,
                          np.random.default_rng(seed))
    check(np.array_equal(truths, res.thetas_true),
          "thetas_true on the card differ from the host CPU's")
    print(f"[22] run_sbc (cut: C={C} replications x W={W}, {n_burn} burn + "
          f"{n_steps} steps, thin {thin}, the prior box of SBC_BOX; L={L}) "
          f"in {secs:.1f} s: launches "
          f"{launches}, acceptance {res.acceptance.mean():.3f}, "
          f"thetas_true == the CPU's; p-values "
          f"{dict(zip(res.names, np.round(res.p_values, 3).tolist()))}")
    err, err1 = sbc_stack_check(sess, res, C, W, seed, err8, "SBC_BOX")

    # run_sbc's float32 checks on kernel 1, on both boxes: the mass veto
    # keeps every draw of either box that float64 keeps; the production
    # box's mock data pass float32's range, and run_sbc refuses it there
    prod = session("cuda", {})
    for tag, s_ in (("SBC_BOX", sess), ("the production box", prod)):
        draws = sample_prior(model_log_prior(s_.model), s_.params,
                             F32_CHECK_DRAWS, np.random.default_rng(seed + 2))
        lost, live = float32_vetoed(s_, draws)
        thetas, survey = sbc_mocks(s_.model, SBC_MOCKS, seed)
        bad, n = float32_misfits(s_, thetas, survey)
        print(f"[22] float32 checks on kernel 1 ({tag}): {lost} of {live} "
              f"prior draws float64 keeps are -inf; the mock data of {bad} "
              f"of {n} replications misfit (-inf, or off float64 at the "
              f"truth by more than {F32_MOCK_RTOL:g} |lp| + "
              f"{F32_MOCK_ATOL:g})")
        check(lost <= F32_VETO_TOLERANCE * live, f"kernel 1 loses {lost} "
              f"of {live} draws of {tag} that float64 keeps")
        check(tag != "SBC_BOX" or bad == 0, f"the mock data of {bad} of {n} "
              f"replications of SBC_BOX misfit in float32")
    check(bad > F32_VETO_TOLERANCE * n, "the production box's mock data "
          "fit in float32")
    try:
        run_sbc(prod, SBC_PROD_REPS, n_walkers=W, n_burn=0, n_steps=thin,
                thin=thin, seed=seed)
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    check(refused is not None and "mock data" in refused,
          f"run_sbc on the card took the production prior box: {refused}")
    print(f"[22] run_sbc on the production box ({SBC_PROD_REPS} "
          f"replications) passes the veto check and is refused on its mock "
          f"data: {refused}")

    W_e = EMCEE_W
    seen = set()
    sess = prod                                      # the production box

    def log_like_batch(x):
        seen.add(x.device.type)
        return sess.model.log_like_batch(x)

    s = EnsembleSampler(W_e, sess.params.ndim, log_like_batch,
                        vectorize=True, seed=seed, device="cuda",
                        dtype=torch.float64)
    center = truth_theta(sess)
    p0 = center * (1 + 0.01 * np.random.default_rng(seed + 5)
                   .standard_normal((W_e, center.size)))
    t0 = time.time()
    s.run_mcmc(p0, EMCEE_STEPS)
    secs = time.time() - t0
    check(seen == {"cuda"}, f"EnsembleSampler evaluated on {seen}")
    acc = float(s.acceptance_fraction.mean())
    check(s.get_chain().shape == (EMCEE_STEPS, W_e, sess.params.ndim)
          and np.all(np.isfinite(s.get_log_prob())) and 0 < acc < 1,
          f"EnsembleSampler: acceptance {acc} or non-finite lp")
    print(f"[22] EnsembleSampler(vectorize=True) W={W_e}, {EMCEE_STEPS} "
          f"steps on the card: acceptance {acc:.3f}, "
          f"{W_e * EMCEE_STEPS / secs:.0f} evals/s ({secs:.1f} s)")
    return k4, err, err1


# ---- the roll law and the multi-process survey (phases 23 and 24) ---------

def flagship_start(sess, c, rng, k: int, w: int):
    """Rung state (k, w, D) 1% around TRUTH with its kernel-1 lp."""
    import numpy as np
    import torch
    from joxsz_torch.ops.joint_kernel import joint_ll
    from joxsz_torch.synth import TRUTH

    D, dev = c.ints["D"], c.device
    th0 = np.array([TRUTH[n] for n in sess.params.thawed])
    x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
        (k, w, D))), dtype=torch.float32, device=dev).contiguous()
    lp = joint_ll(x.reshape(k * w, D), c).reshape(k, w)
    check(bool(torch.isfinite(lp).all()), "non-finite start state")
    return x, lp, torch.zeros((k, w), dtype=torch.float32, device=dev)


def phase_roll_kernels(cfg, seed: int) -> dict:
    """Phase 23's kernels (run right after phase 17's, before the fits):
    the step kernel at K=1, W=W_ROLL and at K=4 x W=W_ROLL
    per rung ('auto' takes roll there) against its plain step for
    STEPS_CMP_ROLL steps as phase 4 holds it; kernel 6 under roll over 2
    shards against its plain version and bit for bit the K=1 roll step;
    one launch of TIME_STEPS steps at K=1, W=W_ROLL_TIME (the JAX
    package's headline shape) and at K=4, W=W_ROLL under each law, with
    the plain versions and the bounds.  Returns the times and errors."""
    import numpy as np
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
    from joxsz_torch.ops.step_kernel import (philox_stream, steps_plain,
                                             step_kernel_config,
                                             stretch_steps)
    from joxsz_torch.sampling.kernel import rung_tensors
    from joxsz_torch.sampling.tempered import default_betas

    card = card_line()
    sess = build_session(cfg, device="cuda")
    c = pack_consts(sess)
    dev = c.device
    step_seed = int(np.random.default_rng(seed + 23).integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed + 24)
    betas = default_betas(K_SMOKE)
    print(f"[23] the hashed-roll partner law: K=1 and K={K_SMOKE} at "
          f"W={W_ROLL} per rung ('auto' takes roll above 4096), "
          f"{STEPS_CMP_ROLL} steps against the plain step")
    err1 = compare_steps(*flagship_start(sess, c, rng, 1, W_ROLL),
                         np.ones(1), c, step_seed, STEPS_CMP_ROLL, "[23]")[3]
    err4 = compare_steps(*flagship_start(sess, c, rng, K_SMOKE, W_ROLL),
                         betas, c, step_seed, STEPS_CMP_ROLL, "[23]")[3]
    x0, lp0, _ = flagship_start(sess, c, rng, 1, W_ROLL)
    n_dec, n_near, err6, *_ = compare_coupled(x0[0], lp0[0], c, step_seed,
                                              2, partner="roll")
    print(f"[23] kernel 6 under roll, W={W_ROLL} over 2 shards, "
          f"{STEPS_CMP_COUPLED} steps: {n_dec} decisions, {n_near} near-"
          f"threshold differences vs plain; max |lp err| {err6:.4g}; x, lp, "
          "acc == the step kernel at K=1 under roll after every step")

    # one launch of TIME_STEPS steps under each law, alternating
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    rows = {}
    for k, w in ((1, W_ROLL_TIME), (K_SMOKE, W_ROLL)):
        bk = np.ones(1) if k == 1 else betas
        beta, db = rung_tensors(bk, dev)
        for law in ("roll", "onehot"):
            x, lp, acc = flagship_start(sess, c, rng, k, w)
            sacc = torch.zeros(max(k - 1, 1), dtype=torch.int32, device=dev)
            fn = lambda: stretch_steps(x, lp, acc, sacc, beta, db,  # noqa
                                       step_seed, TIME_STEPS, c,
                                       partner=law)
            ms = cuda_ms(fn, reps=1, warmup=1)
            dev_us, busy = device_time_per_launch(
                fn, reps=1, want="stretch_steps_kernel")
            us = dev_us.get("stretch_steps_kernel")
            step_us = us / TIME_STEPS if us else float("nan")
            bound = steps_bound(c, k, w, TIME_STEPS)
            evals = k * w * TIME_STEPS / (ms * 1e-3)
            blocks, smem, _, _ = step_kernel_config(c, k, w)
            rows[(k, law)] = dict(ms=ms, step_us=step_us, bound=bound)
            print(f"[23] K={k}, W={w}, {law}: {ms:.3f} ms per launch of "
                  f"{TIME_STEPS} steps by CUDA events, "
                  + (f"{step_us:.2f} us of device time a step"
                     if us else "device time not measured")
                  + f", device busy {busy_text(busy)}, {evals / 1e6:.1f} M "
                  f"evals/s; bound {bound:.3f} ms (operations, "
                  f"{100 * bound / ms:.1f}% of the time); grid {blocks} x "
                  f"512, {smem} B shared; {card}")
        # the plain version of the same launch under roll
        x, lp, acc = flagship_start(sess, c, rng, k, w)
        beta, db = rung_tensors(bk, dev)
        rows[(k, "plain")] = cuda_ms(lambda: steps_plain(
            x, lp, acc, beta, db.tolist(), step_seed, TIME_STEPS,
            philox_stream(step_seed, dev), lp_fn, partner="roll"),
            reps=1, warmup=0)
        r, o = rows[(k, "roll")], rows[(k, "onehot")]
        print(f"[23] K={k}, W={w}: roll / one-hot {r['ms'] / o['ms']:.3f} "
              f"by CUDA events; plain (roll) {rows[(k, 'plain')]:.1f} ms "
              f"per {TIME_STEPS} steps")
    return dict(rows=rows, err1=err1, err4=err4, err6=err6)


def phase_roll_cli(path: str, roll: dict) -> tuple[dict, dict, float]:
    """Phase 23's CLI run: ``run --walkers W_ROLL --quick`` through
    ``run.main`` on phase 5's config (its MLE cached), launch counters set
    to 0 just before: the route printed as roll, every step-kernel launch
    a roll one.  Returns the kernels line's two roll rows (the times of
    ``phase_roll_kernels``) and kernel 6's largest lp error under roll."""
    import contextlib
    import io

    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.sampling.kernel import chain_chunk_schedule

    rows = roll["rows"]
    # the CLI at W_ROLL walkers: the route the JAX run --step-kernel takes
    m_argv = ["--config", path, "--walkers", str(W_ROLL), "--quick"]
    buf = io.StringIO()
    zero_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = run.main(m_argv + plot_flags())
    wall = time.time() - t0
    launches = read_launches()
    text = buf.getvalue()
    route = [ln for ln in text.splitlines() if "partner law" in ln]
    for line in route + [ln for ln in text.splitlines()
                         if ln.startswith(("wall time", "throughput"))]:
        print(f"[23]   {line}")
    t = res.timings
    acc = float(np.mean(res.acceptance_fraction))
    n1 = t["prelim_rounds"] * len(chain_chunk_schedule(100, 1)) + len(
        chain_chunk_schedule(200, 1))
    n4 = (1 + t["auto_extend_rounds"]) * len(chain_chunk_schedule(400, 5))
    print(f"[23] run --walkers {W_ROLL} --quick in {wall:.1f} s: acceptance "
          f"{acc:.3f}, launches {launches}")
    check(len(route) == 1 and f"partner law roll at {W_ROLL}" in route[0],
          f"run --walkers {W_ROLL}: route {route}")
    check(launches["stretch_steps_roll"] == n1
          and launches["stretch_steps_tempered_roll"] == n4
          and launches["stretch_steps"] + launches["stretch_steps_tempered"]
          == 0, f"run --walkers {W_ROLL}: launches {launches}, want {n1} + "
          f"{n4} roll launches and no one-hot one")
    check(0.1 < acc < 0.6, f"run --walkers {W_ROLL}: acceptance {acc}")
    check(res.chain.shape[1:] == (W_ROLL, 13) and np.all(np.isfinite(
        res.chain)) and np.all(np.isfinite(res.log_prob)),
        f"run --walkers {W_ROLL}: chain {res.chain.shape} or non-finite")

    def row(name, k, w, replaces, err, n):
        r = rows[(k, "roll")]
        return dict(name=name, route="cuda",
                    source="joxsz_torch/csrc/stretch_step.cu",
                    replaces=replaces, launches=n, max_abs_err=err,
                    ms=r["ms"], plain_ms=rows[(k, "plain")],
                    bound_ms=r["bound"], bound_by="operations",
                    library_ms=None)

    return (row("stretch_steps[roll]", 1, W_ROLL_TIME,
                "joxsz_tpu/ops/pallas_joint.py:1242", roll["err1"],
                launches["stretch_steps_roll"]),
            row("stretch_steps_tempered[roll]", K_SMOKE, W_ROLL,
                "joxsz_tpu/ops/pallas_joint.py:2105", roll["err4"],
                launches["stretch_steps_tempered_roll"]), roll["err6"])


def coupled_spec(base: str):
    """Phase 24's coupled run: its spec and its start walkers."""
    import numpy as np
    from joxsz_torch.synth import TRUTH

    spec = json.loads(open(f"{base}/spec.json").read())
    th0 = np.array([TRUTH[n] for n in spec["thawed"]])
    rng = np.random.default_rng(spec["seed"])
    p0 = th0[None] * (1 + 0.01 * rng.standard_normal((W_MESH, th0.size)))
    return spec, p0


def coupled_worker(rank: int, base: str):
    """Process ``rank`` of phase 24's two-process coupled run: the coupled
    sampler over a walker mesh of one card shard per process; writes its
    walkers' chain, its launches of kernel 6 and its wall."""
    import numpy as np
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.parallel import multihost
    from joxsz_torch.parallel.kernel_sharded import (
        run_coupled_sharded_ensemble)

    spec, p0 = coupled_spec(base)
    info = multihost.initialize(f"file://{base}/rdv", 2, rank)
    print(f"process {rank}/2: {info.local_devices} card(s), "
          f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')}, "
          f"{torch.cuda.get_device_name(0)}")
    sess = build_session(JoXSZConfig.from_json(open(spec["config"]).read()),
                         device="cuda")
    c = pack_consts(sess)
    mesh = multihost.global_mesh(("walker",))
    zero_launches()
    t0 = time.time()
    res = run_coupled_sharded_ensemble(
        c, torch.tensor(p0, dtype=torch.float32), spec["steps"],
        spec["seed"], mesh, thin=THIN_MESH)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()["coupled_half"]
    multihost.finalize()
    np.savez(f"{base}/rank{rank}.npz", chain=res.chain, lp=res.log_prob,
             acc=res.acceptance_fraction, idx=res.walker_indices,
             x=res.final_state[0].cpu().numpy(), wall=wall,
             launches=launches)
    print(f"process {rank}: {spec['steps']} coupled steps in {wall:.2f} s, "
          f"{launches} launches of kernel 6")


def run_children(argvs: list, tmp: str, tag: str, env=None):
    """Run child processes together, each its own log, under one deadline
    (MULTIHOST_TIMEOUT); kills them all when one fails or time runs out.
    Returns their logs."""
    procs = []
    try:
        for i, argv in enumerate(argvs):
            log = open(f"{tmp}/{tag}{i}.log", "w")
            procs.append((log, subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT, env=env)))
        t_end = time.time() + MULTIHOST_TIMEOUT
        while any(p.poll() is None for _, p in procs):
            bad = [p.returncode for _, p in procs
                   if p.poll() is not None and p.returncode]
            if bad or time.time() > t_end:
                break
            time.sleep(0.2)
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [open(f"{tmp}/{tag}{i}.log").read() for i in range(len(argvs))]
    for (_, p), text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: a child failed (rc "
                                 f"{p.returncode}):\n" + text[-3000:])
    return logs


def phase_multihost(cfg5, path: str, tmp: str, seed: int) -> tuple[int, int]:
    """Phase 24: the multi-process survey and the coupled sampler across
    processes, two processes on this card.  (1) ``survey.main --mock 4
    --walkers 1024 --burn 1000 --steps 1000 --multihost-launch 2``: both
    workers on cuda:0, kernel 4 twice each; the assembled medians, sds and
    acceptances bit for bit ``fit_survey`` over a 2-shard cluster mesh on
    [cuda:0, cuda:0] in this process at the same seed; every truth within
    5 sd.  (2) the coupled sampler at phase 12's W over a walker mesh of
    one shard per process against one process with 2 shards, bit for
    bit, ``walker_indices`` covering every walker once.  With four cards
    the survey runs 2 workers x 2 cards (--mock 8) against a mesh of the
    four cards.  Returns the launches of kernels 4 and 6 in the workers."""
    import argparse
    import contextlib
    import io

    import numpy as np
    import torch
    from joxsz_torch import survey
    from joxsz_torch.build import build_session
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.parallel import make_mesh
    from joxsz_torch.parallel.kernel_sharded import (
        run_coupled_sharded_ensemble)

    def multihost_survey(C, n_cards):
        """--mock C over 2 workers of n_cards cards each (1: both on
        cuda:0) against a mesh of as many shards in this process."""
        out = f"{tmp}/multihost_{C}.json"
        argv = ["--mock", str(C), "--config", path, "--walkers",
                str(W_SMOKE), "--burn", "1000", "--steps", "1000", "--seed",
                str(seed), "--out", out, "--multihost-launch", "2"]
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            survey.main(argv)
        wall = time.time() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            if line.startswith(("worker ", "process ", "survey of")):
                print(f"[24]   {line}")
        got = re.findall(r"process (\d+): clusters \[(\d+), (\d+)\) sampled "
                         r"in [\d.]+s .* (\d+) launches of the cluster-grid",
                         text)
        check(sorted(int(g[0]) for g in got) == [0, 1]
              and all(int(g[3]) == 2 * n_cards for g in got),
              f"multihost survey: worker lines {got}, want kernel 4 "
              f"launched twice per shard ({n_cards} per worker)")
        mh = json.loads(open(out).read())
        t0 = time.time()
        ns = argparse.Namespace(config=path, data_dir=None, sz_only=False,
                                seed=seed)
        sess, sz, xr, centers, names, truths = survey._build_mock_survey(
            C, ns, torch.device("cuda"))
        shards = 2 * n_cards
        devs = ([f"cuda:{i}" for i in range(shards)] if n_cards > 1
                else ["cuda:0"] * 2)
        res = survey.fit_survey(
            sess, sz, xr, centers, cluster_names=names, n_walkers=W_SMOKE,
            n_burn=1000, n_steps=1000, thin=5, seed=seed, truths=truths,
            mesh=make_mesh(len(devs), ("cluster",), devices=devs))
        wall1 = time.time() - t0
        one = res.to_dict()["clusters"]
        for key in ("name", "median", "sd", "acceptance", "truth"):
            check([r[key] for r in mh["clusters"]] == [r[key] for r in one],
                  f"multihost survey (C={C}): '{key}' differs from the "
                  f"{len(devs)}-shard mesh run in one process: "
                  f"{[r[key] for r in mh['clusters']]} vs "
                  f"{[r[key] for r in one]}")
        check(mh["clusters"] == one, f"multihost survey (C={C}) differs")
        pulls = max(abs(row["median"][n] - row["truth"][n])
                    / max(row["sd"][n], 1e-12)
                    for row in mh["clusters"] for n in mh["param_names"])
        check(pulls < 5.0, f"multihost survey: a truth {pulls:.1f} sd off")
        print(f"[24] survey --mock {C} --multihost-launch 2 ({n_cards} "
              f"card(s) per worker): {wall:.1f} s wall (launcher), the "
              f"{len(devs)}-shard mesh in one process {wall1:.1f} s; "
              f"medians, sds, acceptances bit for bit; ranges "
              f"{mh['multihost']['ranges']}; largest pull {pulls:.2f} sd")
        return sum(int(g[3]) for g in got)

    # one card: both workers on cuda:0; four: two cards each, --mock 8
    per = max(1, torch.cuda.device_count() // 2)
    C = C_SURVEY if per == 1 else 2 * C_SURVEY
    print(f"[24] multi-process survey: 2 workers, {per} card(s) each"
          + (" (both on cuda:0)" if per == 1 else "") + f", W={W_SMOKE}, "
          f"--mock {C}, 1000 + 1000 steps")
    n4 = multihost_survey(C, per)

    # the coupled sampler across processes
    base = f"{tmp}/coupled_mh"
    os.makedirs(base)
    sess = build_session(cfg5, device="cuda")
    c = pack_consts(sess)
    spec = dict(config=path, seed=seed + 24, steps=MH_COUPLED_STEPS,
                thawed=list(sess.params.thawed))
    open(f"{base}/spec.json", "w").write(json.dumps(spec))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", OMP_NUM_THREADS="1")
    logs = run_children(
        [[sys.executable, os.path.abspath(__file__), "--coupled-worker",
          str(r), "--base", base] for r in (0, 1)], tmp, "coupled_mh", env)
    for text in logs:
        for line in text.splitlines():
            if line.startswith("process "):
                print(f"[24]   {line}")
    _, p0 = coupled_spec(base)
    t0 = time.time()
    one = run_coupled_sharded_ensemble(
        c, torch.tensor(p0, dtype=torch.float32), MH_COUPLED_STEPS,
        spec["seed"], make_mesh(2, ("walker",), devices=["cuda:0"] * 2),
        thin=THIN_MESH)
    torch.cuda.synchronize()
    wall1 = time.time() - t0
    seen, n6, walls = [], 0, []
    for r in (0, 1):
        got = np.load(f"{base}/rank{r}.npz")
        idx = got["idx"]
        seen += idx.tolist()
        n6 += int(got["launches"])
        walls.append(float(got["wall"]))
        check(np.array_equal(got["chain"], one.chain[:, idx])
              and np.array_equal(got["lp"], one.log_prob[:, idx])
              and np.array_equal(got["acc"], one.acceptance_fraction[idx])
              and np.array_equal(got["x"], one.final_state[0].cpu().numpy()
                                 [idx]),
              f"coupled sampler, process {r}: differs from one process")
    check(sorted(seen) == list(range(W_MESH)),
          "coupled sampler: walker_indices do not cover every walker once")
    check(n6 == 4 * MH_COUPLED_STEPS, f"coupled sampler: {n6} launches of "
          f"kernel 6 in the workers, want {4 * MH_COUPLED_STEPS}")
    print(f"[24] coupled sampler W={W_MESH}, {MH_COUPLED_STEPS} steps across "
          f"2 processes (1 shard each on cuda:0): {walls[0]:.2f} / "
          f"{walls[1]:.2f} s ({1e3 * max(walls) / MH_COUPLED_STEPS:.2f} ms "
          f"a step) vs {wall1:.2f} s in one process with 2 shards; chains, "
          "acceptance and final walkers bit for bit, every walker once")
    return n4, n6


# ---- the posterior-level referee and the examples (phase 25) ------------

EXAMPLES = ("torch_custom_pressure.py", "torch_model_comparison.py",
            "torch_multicluster_fit.py")


def phase_referee(cfg, tmp: str, seed: int) -> dict:
    """Phase 25: the posterior-level referee of ``tests/torch_parity.py``
    on phase 2's dataset (the calibrated one at the default ``--seed``):
    the numpy stretch sampler on kernel 1 against the step kernel at K=1
    (one-hot), at K=4 (cold rung, with the swap sweep) and at K=1 under
    the roll law, every launch counter set to 0 just before and read just
    after; each arm within MED_BAND and WIDTH_BAND of the referee, the
    (d+1) control outside WIDTH_BAND.  Then the three examples
    (``examples/torch_*.py --smoke``) on the card, in child processes.
    Returns the referee's launches."""
    import numpy as np

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    import torch_parity as tp

    card = card_line()
    if seed != tp.DATA_SEED:
        cfg = None
    sess, consts, theta_c = tp.referee_session(
        cfg, "cuda", root=f"{tmp}/referee")
    zero_launches()
    t0 = time.time()
    out = tp.run_referee(consts, theta_c)
    wall = time.time() - t0
    launches = read_launches()
    sc = tp.SCHEDULE
    print(f"[25] the posterior-level referee on {card}: W={sc.w}, "
          f"{sc.burn} burn + {sc.steps} steps (frames every {sc.thin}), "
          f"{sc.k_ref} numpy replicates and {sc.k_ctrl} of the (d-1) -> "
          f"(d+1) control in lockstep ({out['np']['wall']:.1f} s), "
          f"{sc.k_dev} per arm; {wall:.1f} s in all; launches {launches}")
    bad = []
    for arm in tp.ARMS:
        dmed, dwidth = tp.stats(out, arm, "np")
        ok = dmed < tp.MED_BAND and dwidth < tp.WIDTH_BAND
        print(f"[25] {arm:4s} vs numpy: dmed {dmed:.4f} (band "
              f"{tp.MED_BAND}), dwidth {dwidth:.4f} (band {tp.WIDTH_BAND})"
              f" -> {'pass' if ok else 'FAIL'}; {out[arm]['wall']:.2f} s "
              f"on {card}")
        if not ok:
            bad.append(arm)
    c_med, c_width = tp.stats(out, "ctrl", "k1")
    print(f"[25] control (d+1) vs k1: dmed {c_med:.4f}, dwidth "
          f"{c_width:.4f} (must reach {tp.WIDTH_BAND}) on {card}")

    # the examples, on the card, each its own child process
    repo = pathlib.Path(__file__).resolve().parent
    code = ("import runpy, sys, time; t = time.time(); sys.argv = "
            "sys.argv[1:]; runpy.run_path(sys.argv[0], run_name="
            "'__main__'); print(f'example wall {time.time() - t:.1f} s')")
    logs = run_children([[sys.executable, "-c", code,
                          str(repo / "examples" / name), "--smoke"]
                         for name in EXAMPLES], tmp, "example")
    for name, log in zip(EXAMPLES, logs):
        lines = log.strip().splitlines()
        check(lines and lines[-1].startswith("example wall"),
              f"{name}: no wall line")
        print(f"[25] examples/{name} --smoke on the card: {lines[-1][8:]} "
              f"(imports and dataset included) on {card}")

    check(not bad, f"the referee: {bad} outside the bands")
    check(c_width >= tp.WIDTH_BAND, "the broken-move control passed the "
          "width band: the referee has no power")
    check(launches["joint_ll"] > 0 and launches["stretch_steps"] > 0
          and launches["stretch_steps_tempered"] > 0
          and launches["stretch_steps_roll"] > 0,
          f"the referee launched a kernel of its path no time: {launches}")
    return launches


def all_launches() -> dict:
    from joxsz_torch.ops.coupled_kernel import coupled_half
    from joxsz_torch.ops.joint_kernel import joint_ll
    from joxsz_torch.ops.multicluster_kernel import stretch_steps_multicluster
    from joxsz_torch.ops.step_kernel import stretch_steps
    from joxsz_torch.ops.sz_core import sz_core

    return {"joint_ll": joint_ll, "stretch_steps": stretch_steps,
            "stretch_steps_multicluster": stretch_steps_multicluster,
            "sz_core": sz_core, "coupled_half": coupled_half}


def f64_tier_pairs(reset: bool = False) -> dict:
    """The mass veto's float64-tier pairs (``csrc/mass_veto.cuh``'s
    counters) of kernel 1 and of the step kernels (the step kernel,
    kernels 4 and 6) in this process."""
    from joxsz_torch.ops import joint_kernel, step_kernel

    return {"kernel 1": joint_kernel.f64_pairs(reset),
            "step kernels": step_kernel.f64_pairs(reset)}


def zero_launches():
    f64_tier_pairs(reset=True)
    for fn in all_launches().values():
        fn.launches = 0
    all_launches()["stretch_steps"].launches_tempered = 0
    all_launches()["stretch_steps"].launches_roll = [0, 0]
    all_launches()["stretch_steps_multicluster"].launches_by_family.clear()


def read_launches() -> dict:
    """Launches per kernel entry of the kernels line: the rung step
    kernel's split into K = 1 (``stretch_steps``) and K > 1
    (``stretch_steps_tempered``) under the one-hot law, and the same two
    under the roll law (``..._roll``, phase 23)."""
    fns = all_launches()
    out = {k: fn.launches for k, fn in fns.items()}
    st = fns["stretch_steps"]
    out["stretch_steps_roll"], out["stretch_steps_tempered_roll"] = \
        st.launches_roll
    out["stretch_steps_tempered"] = (st.launches_tempered
                                     - out["stretch_steps_tempered_roll"])
    out["stretch_steps"] -= (st.launches_tempered
                             + out["stretch_steps_roll"])
    return out


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
    # burn and sampling: one launch each (one Philox seed each)
    check(launches["stretch_steps_multicluster"] == 2
          and launches["joint_ll"] > 0, f"survey launches {launches}")
    check(launches["stretch_steps"] + launches["stretch_steps_tempered"]
          == 0, "the rung step kernel ran on the survey")
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
    cfg.save_dir = cfg.plot_dir = tmp
    path = config_json(cfg, f"{tmp}/fused.json")
    print(f"[10] fused-likelihood path, full width, depth cut (host-bound "
          f"plain sampler loop): W={W_SMOKE}, K=1, prelim 100 x <= 2, burn "
          f"{FUSED_BURN}, steps {FUSED_STEPS} (--quick)")
    zero_launches()
    t0 = time.time()
    res = run.main(["--config", path, "--quick", "--fused",
                    "--no-step-kernel"] + plot_flags())
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
    check(launches["stretch_steps"] + launches["stretch_steps_tempered"] == 0
          and launches["joint_ll"] == 0,
          f"the step kernels ran with --no-step-kernel: {launches}")
    return launches


def plot_flags() -> list:
    """``run`` draws its figures where matplotlib is installed; elsewhere
    it must be told ``--no-plots`` (it refuses to sample otherwise)."""
    import importlib.util

    return ([] if importlib.util.find_spec("matplotlib") is not None
            else ["--no-plots"])


def output_files(save: str, name: str = "joxsz") -> dict:
    """The files a fit writes into ``save``: the chain (HDF5 where h5py is
    installed, else its .npz twin), fit.dat, the summary and the state."""
    import glob

    chain = glob.glob(f"{save}/{name}_chain.*")
    return {"chain": chain[0] if len(chain) == 1 else None,
            "fit.dat": f"{save}/fit.dat",
            "summary": f"{save}/{name}_summary.json",
            "state": f"{save}/{name}_state.npz"}


class SeedLog:
    """Every Philox chunk seed the kernel sampler draws while active."""

    def __init__(self):
        from joxsz_torch.sampling import kernel

        self.kernel, self.real, self.seeds = kernel, kernel._seeds, []

    def __enter__(self):
        def spy(rng, n):
            out = self.real(rng, n)
            self.seeds.extend(out)
            return out

        self.kernel._seeds = spy
        return self.seeds

    def __exit__(self, *exc):
        self.kernel._seeds = self.real


def phase_main_path(cfg, tmp: str, seed: int) -> dict:
    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.config import MCMCConfig
    from joxsz_torch.sampling.kernel import chain_chunk_schedule
    from joxsz_torch.synth import config_json

    # the card's production schedule at full width (W=1024 x K=4, full
    # likelihood, 1000 x <=10 prelim / 4000 burn / 8000 steps / <=3
    # extensions): it fits the time limit, so no count is cut
    cfg.mcmc = MCMCConfig.converged_gpu()
    cfg.mcmc.seed = seed
    cfg.save_dir = cfg.plot_dir = tmp
    m = cfg.mcmc
    print(f"[5] main path, production schedule, no count cut: W="
          f"{m.nwalkers} x K={m.n_temper_rungs}, prelim "
          f"{m.prelim_iterations}, burn {m.nburn}, steps {m.nsteps}, "
          f"auto-extend {m.auto_extend}")
    if plot_flags():
        print("[5] matplotlib is not installed here: the fit runs with "
              "--no-plots (no figures)")
    path = config_json(cfg, f"{tmp}/smoke.json")
    argv = ["--config", path] + plot_flags()
    zero_launches()
    t0 = time.time()
    with SeedLog() as seeds:
        res = run.main(argv)
    wall = time.time() - t0
    launches = read_launches()
    f64 = f64_tier_pairs()
    acc = float(np.mean(res.acceptance_fraction))
    swaps = res.timings.get("swap_acceptance", [])
    print(f"[5] main path in {wall:.1f} s: acceptance {acc:.3f}, swap rates "
          f"{np.round(swaps, 3).tolist()}, launches {launches}")
    t = res.timings
    n_steps = (t["prelim_rounds"] * m.prelim_iterations + m.nburn
               + (1 + t["auto_extend_rounds"]) * m.nsteps)
    print(f"[5] the mass veto's float64-tier pairs over the fit: {f64}, "
          f"{100 * f64['step kernels'] / n_steps:.2f} per 100 of the step "
          f"kernel's {n_steps} steps (prelim and burn-in at K=1, sampling "
          f"at K={K_SMOKE}, W={W_SMOKE})")
    check(0.1 < acc < 0.6, f"acceptance {acc} outside (0.1, 0.6)")
    check(len(swaps) == K_SMOKE - 1
          and all(math.isfinite(s) and s > 0 for s in swaps),
          f"swap rates {swaps}")
    # one launch of the step kernel per chunk of a sampling call: the
    # prelim rounds and burn-in at K = 1, the sampling calls at K = 4
    n1 = (t["prelim_rounds"] * len(chain_chunk_schedule(
        m.prelim_iterations, 1)) + len(chain_chunk_schedule(m.nburn, 1)))
    n4 = (1 + t["auto_extend_rounds"]) * len(chain_chunk_schedule(
        m.nsteps, m.nthin))
    check(launches["joint_ll"] > 0 and launches["stretch_steps"] == n1
          and launches["stretch_steps_tempered"] == n4,
          f"main path launches {launches}, want {n1} + {n4} step-kernel "
          "launches (one per chunk)")
    check(np.all(np.isfinite(res.chain)) and res.chain.shape[1:] == (
        W_SMOKE, 13), f"chain shape {res.chain.shape} or non-finite values")
    check(np.all(np.isfinite(res.log_prob)), "non-finite chain log-probs")
    # every output, kept aside for phase 16 (later phases reuse tmp)
    files = output_files(tmp)
    check(all(f and os.path.isfile(f) for f in files.values()),
          f"phase 5 outputs missing: {files}")
    cache = run.mle_cache_path(cfg, sess_params(path))
    check(cache.is_file(), f"no MLE cache entry {cache}")
    keep = f"{tmp}/phase5"
    os.makedirs(keep)
    kept = {k: shutil.copy(f, keep) for k, f in files.items()}
    figures = sorted(f for f in os.listdir(tmp) if f.endswith(".pdf"))
    names = ", ".join(os.path.basename(f) for f in files.values())
    print(f"[5] outputs: {names}, MLE cache {cache.name}; figures "
          f"{figures or 'none'}")
    return launches, path, res, wall, list(seeds), kept, argv


def sess_params(path: str):
    """The thawed parameters of the session ``run`` builds from ``path``
    (the MLE cache key reads their names)."""
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig

    cfg = JoXSZConfig.from_json(open(path).read())
    return build_session(cfg, device="cpu").params


def phase_outputs(cfg, tmp: str, main_path):
    """Phase 16, on phase 5's output directory: (1) the same command
    again: the MLE cache hits with phase 5's theta bit for bit; (2)
    ``--resume`` of phase 5's state with ``--auto-extend 0``: the K-rung
    ladder restored, no burn-in counted, nsteps // nthin frames, a first
    Philox seed that is none of phase 5's; (3) ``--postprocess`` of phase
    5's chain with ``--ppc``: its summary JSON equal to phase 5's, both
    p-values finite in [0, 1], and the profile, mass and predictive bands
    of PROFILE_ROWS draws on the card equal to the same draws' on the CPU
    (both float64) within PROFILE_RTOL; (4) ``--move de`` and ``--move
    snooker`` at --quick on the plain sampler."""
    import contextlib
    import io

    import numpy as np
    from joxsz_torch import run
    from joxsz_torch.build import build_session
    from joxsz_torch.postproc import profiles

    _, res5, wall5, seeds5, kept, argv = main_path
    m = cfg.mcmc

    # (1) the same command: a cache hit
    t0 = time.time()
    res = run.main(argv)
    wall = time.time() - t0
    check(res.timings.get("mle_cached") is True, "the MLE cache missed")
    check(np.array_equal(res.mle_theta, res5.mle_theta),
          "cached theta differs from phase 5's")
    print(f"[16] same command again: MLE cache hit, theta bit for bit "
          f"phase 5's; mle_s {res5.timings['mle_s']:.2f} s cold -> "
          f"{res.timings['mle_s']:.3f} s warm, wall {wall5:.1f} s -> "
          f"{wall:.1f} s")

    # (2) resume phase 5's state
    buf = io.StringIO()
    t0 = time.time()
    with SeedLog() as seeds, contextlib.redirect_stdout(buf):
        res = run.main(argv + ["--resume", kept["state"],
                               "--auto-extend", "0"])
    wall = time.time() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("resuming", "note:", "wall time")):
            print(f"[16]   {line}")
    t = res.timings
    K, W = m.n_temper_rungs, m.nwalkers
    check(f"resuming the full {K}-rung replica ladder" in text,
          "the resumed run did not restore the ladder")
    check(t["prelim_rounds"] == 0 and t["likelihood_evals"] == m.nsteps
          * K * W, f"resumed evals {t['likelihood_evals']} != "
          f"{m.nsteps} x {K} x {W} (burn-in counted?)")
    check(res.chain.shape[0] == m.nsteps // m.nthin,
          f"resumed chain {res.chain.shape}")
    check(seeds[0] not in seeds5, "the resumed run replayed phase 5's "
          "Philox seeds")
    print(f"[16] --resume --auto-extend 0 in {wall:.1f} s: {K}-rung ladder "
          f"restored, {res.chain.shape[0]} frames, evals "
          f"{t['likelihood_evals']} (no burn-in), {t['evals_per_s']:.0f} "
          f"evals/s, split-R-hat {t['split_rhat']:.4f}, first seed "
          f"{seeds[0]} not among phase 5's {len(seeds5)}")

    # (3) post-process phase 5's chain
    summary5 = json.loads(open(kept["summary"]).read())
    t0 = time.time()
    res = run.main(argv + ["--postprocess", kept["chain"], "--ppc"])
    wall = time.time() - t0
    summary = json.loads(open(f"{tmp}/joxsz_summary.json").read())
    check(summary == summary5, "--postprocess summary != phase 5's")
    ppc = json.loads(open(f"{tmp}/joxsz_ppc.json").read())
    pv = (ppc["p_sz"], ppc["p_xray"])
    check(all(v is not None and 0.0 <= v <= 1.0 for v in pv),
          f"p-values {pv}")
    print(f"[16] --postprocess --ppc in {wall:.1f} s (summary "
          f"{res.timings['postprocess_s']:.2f} s): summary == phase 5's, "
          f"p_sz {pv[0]:.3f}, p_xray {pv[1]:.3f}")
    flat = res.flat_chain
    rows = flat[:: max(1, len(flat) // PROFILE_ROWS)][:PROFILE_ROWS]
    bands = {}
    for dev in ("cuda", "cpu"):
        sess = build_session(cfg, device=dev)
        r = sess.geometry.r_press_kpc
        t0 = time.time()
        ps = profiles.compute_profiles(sess.model, sess.cosmology, r, rows)
        mass = profiles.compute_mass_profiles(sess.model, sess.cosmology, r,
                                              rows)
        pred = profiles.posterior_predictive(sess.model, rows)
        secs = time.time() - t0
        bands[dev] = ([getattr(ps, f) for f in (
            "density", "temp_sz", "temp_x", "pressure", "entropy",
            "cooling_time", "gas_mass", "gas_fraction")] + list(mass)
            + list(pred), secs)
    worst = 0.0
    for a, b in zip(bands["cuda"][0], bands["cpu"][0]):
        check(a.shape == b.shape and np.all(np.isfinite(a)),
              "non-finite profile bands on the card")
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        worst = max(worst, float(rel.max()))
    check(worst <= PROFILE_RTOL, f"profile bands on the card vs the CPU: "
          f"max relative difference {worst:.3g} > {PROFILE_RTOL}")
    print(f"[16] profile, mass and predictive bands of {len(rows)} draws: "
          f"card {bands['cuda'][1]:.2f} s, CPU {bands['cpu'][1]:.2f} s, "
          f"max relative difference {worst:.3g} (<= {PROFILE_RTOL})")

    # (4) the DE moves on the plain sampler
    for move in ("de", "snooker"):
        t0 = time.time()
        res = run.main(argv + ["--quick", "--temper", "1", "--move", move])
        wall = time.time() - t0
        acc = float(np.mean(res.acceptance_fraction))
        check(np.all(np.isfinite(res.log_prob)) and 0.0 < acc < 0.9,
              f"--move {move}: acceptance {acc} or non-finite lp")
        print(f"[16] --move {move} --quick (W={m.nwalkers}, plain sampler) "
              f"in {wall:.1f} s: acceptance {acc:.3f}, "
              f"{res.timings['evals_per_s']:.0f} evals/s")


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def only_phases(which: str, cfg, tmp: str, seed: int, card: str) -> int:
    """``--only``: phases 13, 14, 17 (its kernel checks), 22, 23, 24, 25
    and / or 26 on phase 2's dataset, written as phase 5 writes its config; the
    kernels line holds phase 23's rows only."""
    import torch
    from joxsz_torch.config import JoXSZConfig, MCMCConfig
    from joxsz_torch.synth import config_json

    cfg.mcmc = MCMCConfig.converged_gpu()
    cfg.mcmc.seed = seed
    cfg.save_dir = cfg.plot_dir = tmp
    path = config_json(cfg, f"{tmp}/smoke.json")
    cfg5 = JoXSZConfig.from_json(open(path).read())
    rows = []
    phases = {int(p) for p in which.split(",")}
    if 13 in phases:
        phase_large_shapes(seed)
    if 14 in phases:
        phase_families(cfg5, seed)
    if 17 in phases:
        phase_cluster_grid_families(cfg5, seed)
    if 22 in phases:
        phase_sbc(cfg5, seed, float("nan"))
    if 23 in phases:
        rows += list(phase_roll_cli(path, phase_roll_kernels(cfg5, seed))
                     [:2])
    if 24 in phases:
        phase_multihost(cfg5, path, tmp, seed)
    if 25 in phases:
        phase_referee(cfg5, tmp, seed)
    if 26 in phases:
        phase_other_clusters(cfg5, tmp, seed, card)
    print(json.dumps({"kernels": [{k: r[k] for k in KERNEL_KEYS}
                                  for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--only", metavar="13,14,17,22,23,24,25,26",
                    help="run phases 1-2, then only these of phases 13, "
                         "14, 17 (its kernel checks), 22, 23, 24, 25 and "
                         "26 (a quick check of a change; the full run is "
                         "the check)")
    ap.add_argument("--family-fit", help=argparse.SUPPRESS)
    ap.add_argument("--coupled-worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--corner-fit", help=argparse.SUPPRESS)
    ap.add_argument("--base", help=argparse.SUPPRESS)
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
    if args.family_fit:
        family_fit(args.family_fit, args.seed, args.base)
        return 0
    if args.coupled_worker is not None:
        coupled_worker(args.coupled_worker, args.base)
        return 0
    if args.corner_fit:
        corner_fit(args.corner_fit)
        return 0
    from joxsz_torch.run import MLE_CACHE_DIR

    tmp = tempfile.mkdtemp(prefix="joxsz_smoke_")
    # the MLE cache keys hash the dataset's tmp paths: every run of this
    # script starts cold, and it removes the entries it wrote
    cached = set(MLE_CACHE_DIR.glob("mle_torch_*.json"))
    try:
        card = card_line()
        print(f"[1] card: {card}")
        phase_build()
        cfg, sess, c = phase_session(tmp, args.seed)
        if args.only:
            return only_phases(args.only, cfg, tmp, args.seed, card)
        k1 = phase_joint(sess, c, args.seed)
        k2, k3, rows = phase_step_times(sess, c, phase_steps(sess, c,
                                                              args.seed))
        k5 = phase_sz_core(cfg, sess, args.seed)
        k4 = phase_multicluster(sess, c, args.seed)
        k6 = phase_coupled(sess, c, args.seed)
        del sess, c
        phase_large_shapes(args.seed)
        kf = phase_families(cfg, args.seed)
        # kernel 4's family instance beside phase 14's kernels (the
        # profiler's device times are read before the fits' phases)
        k17, keys = phase_cluster_grid_families(cfg, args.seed)
        roll = phase_roll_kernels(cfg, args.seed)
        main_path = phase_main_path(cfg, tmp, args.seed)
        launches, path, res5 = main_path[:3]
        for k in (k1, k2, k3):
            k["launches"] = launches[k["name"]]
        phase_outputs(cfg, tmp, main_path[1:])
        k4["launches"] = phase_survey_path(tmp, path, args.seed)[k4["name"]]
        k5["launches"] = phase_fused_path(cfg, tmp, args.seed)[k5["name"]]
        k6["launches"] = phase_mesh_path(cfg, tmp, path, args.seed,
                                         res5.mle_theta)[k6["name"]]
        fits = phase_family_fits(cfg, tmp, args.seed)
        for k in kf:
            kernel, tag = k["name"][:-1].split("[")
            fit = fits["config4_mesh" if kernel == "coupled_half" else tag]
            k["launches"] = fit["launches"][kernel]
        per_tag = phase_survey_families(cfg, tmp, args.seed, keys)
        for k in k17:
            k["launches"] = per_tag[k["name"][:-1].split("[")[1]]
        phase_tables(tmp, args.seed)
        # the gradient and evidence samplers on phase 5's dataset
        from joxsz_torch.config import JoXSZConfig

        cfg5 = JoXSZConfig.from_json(open(path).read())
        phase_laplace(cfg5, path, res5)
        phase_evidence(cfg5, args.seed)
        phase_gradient_samplers(cfg5, res5, args.seed)
        n_sbc, err_sbc, err_k1 = phase_sbc(cfg5, args.seed,
                                           k4["max_abs_err"])
        k4["launches"] += n_sbc
        k4["max_abs_err"] = max(k4["max_abs_err"], err_sbc)
        k1["max_abs_err"] = max(k1["max_abs_err"], err_k1)
        # the roll law, then the multi-process survey and coupled sampler
        k2r, k3r, err6 = phase_roll_cli(path, roll)
        k6["max_abs_err"] = max(k6["max_abs_err"], err6)
        n4, n6 = phase_multihost(cfg5, path, tmp, args.seed)
        k4["launches"] += n4
        k6["launches"] += n6
        # the posterior-level referee and the examples
        phase_referee(cfg5, tmp, args.seed)
        # other clusters' geometries; every compiled instance launched
        phase_other_clusters(cfg5, tmp, args.seed, card)
        kernels = [{key: k[key] for key in KERNEL_KEYS}
                   for k in (k1, k2, k3, k4, k5, k6, *kf, *k17, k2r, k3r)]
        r4 = rows[f"K={K_SMOKE}, W={W_SMOKE}"]
        print(f"tempered step W={W_SMOKE} K={K_SMOKE}: "
              f"{1e3 * r4['ms'] / TIME_STEPS:.2f} us by CUDA events, "
              f"{r4['step_us']:.2f} us of device time (bound "
              f"{r4['bound_us']:.2f} us) on {card}")
        print(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for f in set(MLE_CACHE_DIR.glob("mle_torch_*.json")) - cached:
            f.unlink()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
