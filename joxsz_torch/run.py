"""End-to-end fit runner (CLI): setup -> MLE -> MCMC -> posterior table.

Torch counterpart of ``joxsz_tpu/run.py`` for the joint fit.  On the card
the default schedule is ``MCMCConfig.converged_gpu`` (W=1024 walkers x K=4
tempering rungs, 4000 burn + 8000 steps, thin 25, auto-extend 3) sampled
through the CUDA step kernels; a ``--config`` file's own schedule is kept
as written.  ``--fused`` builds the batched likelihood whose SZ core is
the fused kernel of ``ops.sz_core``; ``--no-step-kernel`` samples through
the plain ensemble samplers on the batched likelihood instead of the
step kernels (with ``--fused``, on the fused one).  The model family
flags are the JAX CLI's: ``--pressure gnfw|knots``, ``--temperature
upp|vikhlinin``, ``--density single|double``, ``--line-systematic``
(thaw the line_scale nuisance; joint fits only), ``--sz-only`` and
``--integ`` (the integrated-Y prior).  The MLE warm start runs in float64
on the host CPU.  ``--mesh N`` shards
the sampling phase over N devices (``parallel``): the cards ``cuda:0 ..
cuda:N-1``, and it refuses more shards than cards; with ``--cpu``, N
blocks on the CPU.

Usage:
    python -m joxsz_torch.run --config my.json      # on the card
    python -m joxsz_torch.run --config my.json --cpu --quick
    python -m joxsz_torch.run --config my.json --fused --no-step-kernel
    python -m joxsz_torch.run --config my.json --mesh 4 --temper 0
    python -m joxsz_torch.run --config my.json --pressure knots \
        --temperature vikhlinin
    python -m joxsz_torch.run --config my.json --sz-only
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="JoXSZ joint SZ+X-ray fit "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--config", help="JSON config file")
    ap.add_argument("--data-dir", help="CL J1226 data directory (used "
                    "when no --config is given)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--walkers", type=int, default=None,
                    help="override the walker count")
    ap.add_argument("--temper", type=int, default=None, metavar="K",
                    help="K tempering rungs for the sampling phase (1 = "
                    "plain ensemble)")
    ap.add_argument("--quick", action="store_true",
                    help="short chains for smoke testing")
    ap.add_argument("--auto-extend", type=int, default=None, metavar="K",
                    help="after the scheduled steps, keep sampling up to "
                    "K more nsteps-chunks until the chain passes the "
                    "convergence bar (20x worst tau + split-Rhat <= 1.01)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the sampling walkers over an N-device mesh")
    ap.add_argument("--fused", action="store_true",
                    help="use the batched likelihood with the fused SZ-core "
                    "kernel for the walker initialisation and, with "
                    "--no-step-kernel, for every sampling phase")
    ap.add_argument("--no-step-kernel", action="store_true",
                    help="keep the schedule but sample through the plain "
                    "ensemble samplers on the batched likelihood instead "
                    "of the step kernels")
    ap.add_argument("--sz-only", action="store_true",
                    help="SZ-only fit (the preprofit capability)")
    ap.add_argument("--pressure", choices=["gnfw", "knots"], default=None,
                    help="pressure parametrization (default gnfw; 'knots' "
                    "= non-parametric log-lerp, config #4)")
    ap.add_argument("--temperature", choices=["upp", "vikhlinin"],
                    default=None,
                    help="temperature model (default upp = T_X derived "
                    "from P/n_e; 'vikhlinin' = parametric profile "
                    "decoupled from pressure, config #4)")
    ap.add_argument("--density", choices=["single", "double"],
                    default=None,
                    help="Vikhlinin density mode ('double' adds a second "
                    "beta-model core component)")
    ap.add_argument("--line-systematic", action="store_true",
                    help="thaw the line_scale nuisance (Gaussian N(1, "
                    "0.25)) scaling the metal-line component of the "
                    "count-rate table; joint fits only")
    ap.add_argument("--integ", action="store_true",
                    help="enable the integrated-Y Gaussian prior")
    return ap


def apply_model_flags(cfg, args):
    """The model-family flags of ``args`` into ``cfg`` (in place), as
    ``joxsz_tpu/run.py`` applies them; ``--line-systematic`` needs the
    X-ray likelihood."""
    if args.integ:
        cfg.sz.calc_integ = True
    if args.line_systematic:
        if args.sz_only or cfg.xray is None:
            raise SystemExit("--line-systematic needs the X-ray "
                             "likelihood (joint fits only)")
        cfg.xray.line_systematic = True
    if args.pressure is not None:
        cfg.pressure_model = args.pressure
    if args.temperature is not None:
        cfg.temperature_model = args.temperature
    if args.density is not None:
        cfg.density_mode = args.density
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    t_start = time.time()

    import numpy as np
    from .config import JoXSZConfig, resolve_mcmc_schedule
    from .build import build_session, family_name
    from .device import resolve_device
    from .sampling.kernel import make_kernel_sampler
    from .sampling.driver import run_fit
    from .io.checkpoint import save_state

    device = resolve_device("cpu" if args.cpu else None)
    if args.config:
        cfg = JoXSZConfig.from_json(pathlib.Path(args.config).read_text())
    elif args.data_dir:
        cfg = JoXSZConfig.cl1226(args.data_dir)
    else:
        raise SystemExit("pass --config (or --data-dir with the CL J1226 "
                         "data files)")
    cfg.mcmc, production = resolve_mcmc_schedule(
        cfg.mcmc, device=device.type, quick=args.quick,
        from_config=args.config is not None)
    if args.seed is not None:
        cfg.mcmc.seed = args.seed
    if args.walkers is not None:
        cfg.mcmc.nwalkers = args.walkers
    if args.temper is not None:
        cfg.mcmc.n_temper_rungs = args.temper
    if args.auto_extend is not None:
        cfg.mcmc.auto_extend = args.auto_extend
    apply_model_flags(cfg, args)
    m = cfg.mcmc
    if args.quick:
        m.nburn, m.nsteps, m.nthin = 200, 400, 5
        prelim, rounds = 100, 2
    else:
        prelim, rounds = m.prelim_iterations, 10
    k = m.n_temper_rungs
    samp = f"K={k} tempered" if k > 1 else "plain GW"
    ext = (f", auto-extend up to {m.auto_extend}x to split-Rhat <= 1.01"
           if m.auto_extend else "")
    kind = "production default" if production else "configured"
    print(f"schedule: {kind} — W={m.nwalkers} x {samp}, {m.nburn} burn + "
          f"{m.nsteps} steps (thin {m.nthin}){ext}")
    print(f"device: {torch_device_name(device)}; likelihood float32 "
          "kernels, MLE float64 on the host CPU")
    t0 = time.time()
    sess = build_session(cfg, device=device, sz_only=args.sz_only)
    kind = "SZ-only" if sess.model.xray_data is None else "joint SZ+X"
    print(f"session built in {time.time() - t0:.1f}s (operator "
          f"{sess.sz_operator.L.shape}, {kind}; {family_name(sess.model)}, "
          f"D={sess.params.ndim})")
    ll_batch = None
    if args.fused:
        from .io.readers import read_conversion_table, read_xy

        conv = read_conversion_table(cfg.sz.conversion_file)
        flux = read_xy(cfg.sz.flux_file, ncol=3)
        ll_batch = sess.model.log_like_batch_fused(conv, flux,
                                                   sess.sz_operator)
        print("fused batched likelihood (SZ core: "
              + ("CUDA kernel)" if device.type == "cuda"
                 else "its plain torch version, CPU)"))
    if args.no_step_kernel:
        sampler = None
        print("sampling via the plain ensemble samplers on the "
              + ("fused" if args.fused else "model's") + " batched "
              "likelihood")
    else:
        sampler = make_kernel_sampler(sess)
        print("sampling via the CUDA step kernels" if device.type == "cuda"
              else "sampling via the kernels' plain torch versions (CPU)")

    mesh = None
    if args.mesh:
        from .parallel import make_mesh

        mesh = make_mesh(args.mesh, axis_names=("walker",),
                         devices=[device] * args.mesh if args.cpu else None)
        print(f"sampling sharded over {args.mesh} devices")

    p = sess.params
    res = run_fit(sess.model, sampler, p.thawed_values(), p.lo, p.hi,
                  p.thawed, log_like_batch=ll_batch, nwalkers=m.nwalkers,
                  nburn=m.nburn,
                  nsteps=m.nsteps, nthin=m.nthin, seed=m.seed,
                  initspread=m.initspread, prelim_iterations=prelim,
                  max_prelim_rounds=rounds, n_temper_rungs=m.n_temper_rungs,
                  auto_extend=m.auto_extend, mesh=mesh)
    res.print_summary([p[n].unit for n in p.thawed])
    save = pathlib.Path(cfg.save_dir)
    save.mkdir(parents=True, exist_ok=True)
    (save / f"{cfg.name}_timings.json").write_text(
        json.dumps(res.timings, indent=2, default=float))
    x, lp = res.final_state
    cold_x, cold_lp = (x[0], lp[0]) if x.ndim == 3 else (x, lp)
    save_state(str(save / f"{cfg.name}_state.npz"), cold_x, cold_lp,
               np.asarray([m.seed if m.seed is not None else 0]),
               {"param_names": p.thawed, "nburn": m.nburn,
                "nthin": m.nthin, "seed": m.seed},
               temper_state=x if x.ndim == 3 else None)
    t = res.timings
    sampling_s = t["prelim_s"] + t["burn_s"] + t["sample_s"]
    print(f"wall time {time.time() - t_start:.1f} s (MLE {t['mle_s']:.1f} s "
          f"on the {t['mle_device']}, sampling {sampling_s:.1f} s)")
    return res


def torch_device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    main()
