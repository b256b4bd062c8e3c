"""End-to-end fit runner (CLI): setup -> MLE -> MCMC -> posterior table
-> chain, best fit, summary, figures.

Torch counterpart of ``joxsz_tpu/run.py`` for the joint fit.  On the card
the default schedule is ``MCMCConfig.converged_gpu`` (W=1024 walkers x K=4
tempering rungs, 4000 burn + 8000 steps, thin 25, auto-extend 3) sampled
through the CUDA step kernels; a ``--config`` file's own schedule is kept
as written, and ``--reference-schedule`` keeps the reference's.
``--fused`` builds the batched likelihood whose SZ core is the fused
kernel of ``ops.sz_core``; ``--no-step-kernel`` samples through the plain
ensemble samplers on the batched likelihood instead of the step kernels
(with ``--fused``, on the fused one); ``--move de|snooker`` (emcee's
differential-evolution moves) samples on the plain sampler too, and
drops the production K=4 ladder.  The model family flags are the JAX
CLI's: ``--pressure gnfw|knots``, ``--temperature upp|vikhlinin``,
``--density single|double``, ``--line-systematic`` (thaw the line_scale
nuisance; joint fits only), ``--sz-only`` and ``--integ`` (the
integrated-Y prior).  The MLE warm start runs in float64 on the host CPU
behind a self-validating cache (``data/cache/mle_torch_<key>.json``;
``--fresh-mle`` bypasses it).  ``--mesh N`` shards the sampling phase
over N devices (``parallel``): the cards ``cuda:0 .. cuda:N-1``, and it
refuses more shards than cards; with ``--cpu``, N blocks on the CPU.

A fit writes into the config's ``save_dir``: ``<name>_chain.hdf5``
(emcee's layout; ``<name>_chain.npz`` with the same datasets and attrs
where h5py is not installed), ``fit.dat``, ``<name>_summary.json``,
``<name>_state.npz`` (``--resume`` continues from it),
``<name>_timings.json``, with ``--ppc`` ``<name>_ppc.json``, and the six
figures into ``plot_dir`` unless ``--no-plots`` (without matplotlib a
run asks for ``--no-plots`` before it samples).  ``--postprocess CHAIN``
rebuilds the table, summary and figures from a saved chain.
``--laplace`` replaces the sampling with the Laplace quick-look (the
MAP, error bars from the float64 Hessian on the session's device, the
Laplace evidence) and writes ``<name>_laplace.json``.

Usage:
    python -m joxsz_torch.run --config my.json      # on the card
    python -m joxsz_torch.run --config my.json --cpu --quick
    python -m joxsz_torch.run --config my.json --resume joxsz_state.npz
    python -m joxsz_torch.run --config my.json --postprocess \
        joxsz_chain.hdf5 --ppc
    python -m joxsz_torch.run --config my.json --fused --no-step-kernel
    python -m joxsz_torch.run --config my.json --mesh 4 --temper 0
    python -m joxsz_torch.run --config my.json --pressure knots \
        --temperature vikhlinin
    python -m joxsz_torch.run --config my.json --sz-only
    python -m joxsz_torch.run --config my.json --laplace
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import time

# where the MLE cache entries live (the repo's gitignored data/cache)
MLE_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / "data" / "cache"


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
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the six figures (needed where matplotlib "
                    "is not installed)")
    ap.add_argument("--fresh-mle", action="store_true",
                    help="ignore the MLE disk cache (data/cache/"
                    "mle_torch_*) and re-run the simplex warm start")
    ap.add_argument("--resume", metavar="STATE_NPZ",
                    help="resume sampling from a saved state file")
    ap.add_argument("--move", choices=["stretch", "de", "snooker"],
                    default="stretch",
                    help="ensemble move (stretch = the reference's emcee "
                    "default; de/snooker = emcee's differential-evolution "
                    "moves, on the plain sampler only)")
    ap.add_argument("--reference-schedule", action="store_true",
                    help="keep the reference's sampling schedule (30 "
                    "walkers, plain GW, 2000 burn / 5000 steps) instead "
                    "of the production default; for parity studies")
    ap.add_argument("--postprocess", metavar="CHAIN",
                    help="skip sampling: recompute the posterior table, "
                    "summary JSON and figures from a saved chain (.hdf5 "
                    "or .npz; pass the model-family flags it was sampled "
                    "with)")
    ap.add_argument("--ppc", action="store_true",
                    help="posterior-predictive check: Bayesian p-values "
                    "of the SZ chi^2 and the X-ray deviance (after the "
                    "fit, or with --postprocess)")
    ap.add_argument("--laplace", action="store_true",
                    help="quick-look mode: MAP + autodiff-Hessian error "
                    "bars and Laplace evidence instead of MCMC "
                    "(seconds; the Hessian is float64)")
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

    from .config import JoXSZConfig, resolve_mcmc_schedule
    from .build import build_session, family_name
    from .device import resolve_device
    from .io.checkpoint import has_h5py
    from .sampling.kernel import make_kernel_sampler
    from .sampling.driver import run_fit

    device = resolve_device("cpu" if args.cpu else None)
    if (not (args.no_plots or args.laplace)
            and importlib.util.find_spec("matplotlib") is None):
        raise SystemExit("matplotlib is not installed here, and the "
                         "figures need it: pass --no-plots")
    if args.config:
        cfg = JoXSZConfig.from_json(pathlib.Path(args.config).read_text())
    elif args.data_dir:
        cfg = JoXSZConfig.cl1226(args.data_dir)
    else:
        raise SystemExit("pass --config (or --data-dir with the CL J1226 "
                         "data files)")
    cfg.mcmc, production = resolve_mcmc_schedule(
        cfg.mcmc, device=device.type,
        reference_schedule=args.reference_schedule, quick=args.quick,
        from_config=args.config is not None)
    if production and args.move != "stretch":
        # the tempered and kernel paths take the stretch move only
        cfg.mcmc.n_temper_rungs = 0
        print(f"note: --move {args.move} runs on the plain sampler only; "
              "dropping the default K=4 tempering (schedule otherwise "
              "unchanged)")
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
    if not (args.postprocess or args.laplace):
        k = m.n_temper_rungs
        samp = f"K={k} tempered" if k > 1 else "plain GW"
        ext = (f", auto-extend up to {m.auto_extend}x to split-Rhat <= "
               "1.01" if m.auto_extend else "")
        kind = "production default" if production else "configured"
        print(f"schedule: {kind} — W={m.nwalkers} x {samp}, {m.nburn} burn "
              f"+ {m.nsteps} steps (thin {m.nthin}){ext}")
        if args.reference_schedule:
            print("WARNING: --reference-schedule is a parity configuration: "
                  "at W~30 the Z and epsilon posteriors pile at 0 "
                  "(ensemble-size artifact) and plain GW does not certify "
                  "convergence on this posterior")
    print(f"device: {torch_device_name(device)}; likelihood float32 "
          "kernels, MLE float64 on the host CPU")
    t0 = time.time()
    sess = build_session(cfg, device=device, sz_only=args.sz_only)
    kind = "SZ-only" if sess.model.xray_data is None else "joint SZ+X"
    print(f"session built in {time.time() - t0:.1f}s (operator "
          f"{sess.sz_operator.L.shape}, {kind}; {family_name(sess.model)}, "
          f"D={sess.params.ndim})")
    if args.laplace:
        return _laplace_quicklook(sess, cfg)
    if args.postprocess:
        return _postprocess_saved_chain(sess, cfg, args.postprocess,
                                        no_plots=args.no_plots, ppc=args.ppc)

    save = pathlib.Path(cfg.save_dir)
    save.mkdir(parents=True, exist_ok=True)
    # the chain file's format is settled before the MLE, not at the write
    chain_path = save / f"{cfg.name}_chain.hdf5"
    if not has_h5py():
        chain_path = chain_path.with_suffix(".npz")
        print(f"note: h5py is not installed here; the chain goes to "
              f"{chain_path} (the HDF5 file's datasets and attrs)")
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
    if args.no_step_kernel or args.move != "stretch":
        sampler = None
        if args.move != "stretch" and not args.no_step_kernel:
            print(f"note: --move {args.move} runs on the plain sampler; "
                  "the step kernels take the stretch move only")
        print("sampling via the plain ensemble samplers on the "
              + ("fused" if args.fused else "model's") + " batched "
              "likelihood")
    else:
        from .ops.step_kernel import PARTNER_AUTO_THRESHOLD, resolve_partner

        sampler = make_kernel_sampler(sess)
        w_run = m.nwalkers // (args.mesh or 1)
        print(("sampling via the CUDA step kernels" if device.type == "cuda"
               else "sampling via the kernels' plain torch versions (CPU)")
              + f"; partner law {resolve_partner(sampler.partner, w_run)} "
              f"at {w_run} walkers per rung (roll above "
              f"{PARTNER_AUTO_THRESHOLD})")

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
                  auto_extend=m.auto_extend, mesh=mesh,
                  chain_path=str(chain_path),
                  state_path=str(save / f"{cfg.name}_state.npz"),
                  best_path=str(save / "fit.dat"), resume_from=args.resume,
                  mle_cache=None if args.fresh_mle else mle_cache_path(cfg, p),
                  move=args.move)
    res.print_summary([p[n].unit for n in p.thawed])
    print(f"chain written to {chain_path}")
    _summary_and_figures(sess, cfg, res, no_plots=args.no_plots)
    if args.ppc:
        _ppc_report(sess, cfg, res)
    (save / f"{cfg.name}_timings.json").write_text(
        json.dumps(res.timings, indent=2, default=float))
    t = res.timings
    sampling_s = t["prelim_s"] + t["burn_s"] + t["sample_s"]
    mle = (f"MLE {t['mle_s']:.1f} s on the {t['mle_device']}"
           if t["mle_device"] != "none" else "no MLE")
    print(f"wall time {time.time() - t_start:.1f} s ({mle}, sampling "
          f"{sampling_s:.1f} s)")
    return res


def mle_cache_path(cfg, params) -> pathlib.Path:
    """The MLE cache entry of ``cfg``: the JAX package's key recipe (the
    config with ``mcmc``, ``save_dir`` and ``plot_dir`` reset, the thawed
    names, the dtype — the MLE's float64) under a name of the port's own,
    ``mle_torch_<key>.json``, so an entry the JAX package found from a
    float32 TPU likelihood is never taken for the port's."""
    mle_cfg = dataclasses.replace(cfg, mcmc=type(cfg.mcmc)(), save_dir=".",
                                  plot_dir=".")
    key = hashlib.sha256((mle_cfg.to_json() + "|" + ",".join(params.thawed)
                          + "|dtype=float64").encode()).hexdigest()[:16]
    return MLE_CACHE_DIR / f"mle_torch_{key}.json"


def _ppc_report(sess, cfg, res, n_draws=400):
    """--ppc: posterior-predictive p-values from the fit's chain, written
    to ``<name>_ppc.json``."""
    import numpy as np
    from .postproc.ppc import posterior_predictive_pvalues

    flat = res.flat_chain
    rng = np.random.default_rng((cfg.mcmc.seed or 0) + 777)
    idx = (rng.choice(len(flat), n_draws, replace=False)
           if len(flat) > n_draws else np.arange(len(flat)))
    r = posterior_predictive_pvalues(sess.model, flat[idx], rng)

    def _verdict(pv):
        return ("OK" if pv is not None and 0.05 <= pv <= 0.95
                else "MISFIT" if pv is not None else "n/a")

    print(f"posterior-predictive check ({len(idx)} draws):")
    if r.p_sz is not None:
        print(f"  SZ chi^2      p = {r.p_sz:.3f}  [{_verdict(r.p_sz)}]  "
              f"(obs median {np.median(r.sz_obs):.1f}, "
              f"rep median {np.median(r.sz_rep):.1f})")
    if r.p_xray is not None:
        print(f"  X-ray deviance p = {r.p_xray:.3f}  "
              f"[{_verdict(r.p_xray)}]  "
              f"(obs median {np.median(r.xray_obs):.1f}, "
              f"rep median {np.median(r.xray_rep):.1f})")
    print("  (p near 0: data more discrepant than the model can "
          "replicate; near 1: model overfits/overdisperses)")

    def med(a):
        return None if a is None else float(np.median(a))

    out = {"n_draws": int(len(idx)), "p_sz": r.p_sz, "p_xray": r.p_xray,
           "sz_obs_median": med(r.sz_obs), "sz_rep_median": med(r.sz_rep),
           "xray_obs_median": med(r.xray_obs),
           "xray_rep_median": med(r.xray_rep)}
    path = pathlib.Path(cfg.save_dir) / f"{cfg.name}_ppc.json"
    path.write_text(json.dumps(out, indent=2))
    print(f"written {path}")
    return r


def _summary_and_figures(sess, cfg, res, no_plots=False):
    """Posterior summary JSON + the six figures from a FitResult-shaped
    chain carrier (the fit path and --postprocess); the seconds land in
    ``res.timings["postprocess_s"]``."""
    from .postproc import (summary_dict, save_summary, compute_profiles,
                           compute_mass_profiles, posterior_predictive)

    t0 = time.time()
    p = sess.params
    save = pathlib.Path(cfg.save_dir)
    save_summary(
        str(save / f"{cfg.name}_summary.json"),
        summary_dict(res.flat_chain, p.thawed,
                     units=[p[n].unit for n in p.thawed], ci=cfg.ci,
                     chain_3d=res.chain))
    if not no_plots:
        from .plotting import (traceplot, cornerplot, fit_on_data,
                               radial_profiles, mass_plot, gas_fraction_plot)

        flat = res.flat_chain
        plotdir = cfg.plot_dir
        r_pp = sess.geometry.r_press_kpc
        traceplot(res.cube_chain(), p.thawed, seed=cfg.mcmc.seed,
                  plotdir=plotdir)
        cornerplot(flat, p.thawed, ci=cfg.ci, plotdir=plotdir)
        perc_x, perc_sz = posterior_predictive(sess.model, flat, ci=cfg.ci)
        # SZ-only fits have perc_x None but still get the SZ panel
        if ((perc_x is not None and sess.annuli is not None)
                or perc_sz is not None):
            fit_on_data(sess.bands, sess.annuli, sess.model.sz_data,
                        perc_x, perc_sz, ci=cfg.ci,
                        step_arcsec=cfg.step_arcsec, plotdir=plotdir)
        profs = compute_profiles(sess.model, sess.cosmology, r_pp, flat,
                                 ci=cfg.ci)
        # UPP: overlay T_X when the log-ratio is fitted; a parametric T
        # has t_x == t_sz by construction
        tempx_differs = ("log(T_X/T_{SZ})" in p
                         and not p["log(T_X/T_{SZ})"].frozen)
        radial_profiles(profs, tempx_differs, ci=cfg.ci, plotdir=plotdir)
        mass_bands, r_delta, m_delta = compute_mass_profiles(
            sess.model, sess.cosmology, r_pp, flat, delta=500.0, ci=cfg.ci)
        mass_plot(r_pp, mass_bands, sess.cosmology, r_delta=r_delta[:, 0],
                  m_delta=m_delta[:, 0], plotdir=plotdir)
        # f_gas came out of the thermo pass (ProfileSet.gas_fraction)
        gas_fraction_plot(r_pp, profs.gas_fraction, ci=cfg.ci,
                          plotdir=plotdir)
    res.timings["postprocess_s"] = time.time() - t0
    print(f"summary{'' if no_plots else ' and figures'} written in "
          f"{res.timings['postprocess_s']:.1f} s")


def _postprocess_saved_chain(sess, cfg, chain_path, no_plots=False,
                             ppc=False):
    """--postprocess: rebuild the table, summary and figures (and with
    ``ppc`` the p-values) from a saved chain of either format; refuses a
    chain whose parameters are not the session's."""
    import numpy as np
    from .io.checkpoint import load_chain
    from .sampling.driver import FitResult

    saved = load_chain(chain_path)
    names = list(sess.params.thawed)
    if saved["param_names"] != names:
        raise SystemExit(
            f"chain {chain_path} was sampled with parameters "
            f"{saved['param_names']} but the session thaws {names}; "
            "pass the model-family flags (--pressure/--temperature/"
            "--density/--line-systematic/--sz-only) the chain was "
            "produced with")
    chain = saved["chain"]
    res = FitResult(
        chain=chain, log_prob=saved["log_prob"],
        acceptance_fraction=np.full(chain.shape[1], np.nan),
        mle_theta=chain.reshape(-1, chain.shape[2])[
            np.argmax(saved["log_prob"].reshape(-1))],
        mle_loglike=float(saved["log_prob"].max()), param_names=names,
        timings={})
    spacing_note = ""
    if saved["frame_spacing"] != saved["thin"]:
        # hybrid coupled chains: frames lie slightly wider than thin
        spacing_note = f", frame_spacing={saved['frame_spacing']:.4g}"
    print(f"postprocessing {chain_path}: {chain.shape[0]} saved steps x "
          f"{chain.shape[1]} walkers (burn={saved['burn']}, "
          f"thin={saved['thin']}{spacing_note})")
    res.print_summary([sess.params[n].unit for n in names])
    _summary_and_figures(sess, cfg, res, no_plots=no_plots)
    if ppc:
        _ppc_report(sess, cfg, res)
    return res


def _laplace_quicklook(sess, cfg):
    """--laplace: MAP + Hessian error bars and the Laplace evidence
    without MCMC (the Hessian float64 on the session's device), written
    to ``<name>_laplace.json`` with the JAX package's keys."""
    import numpy as np
    from .sampling.laplace import model_laplace

    t0 = time.time()
    res = model_laplace(sess.model, verbose=True)
    p = sess.params
    kind = ("interior mode" if res.ok and not res.at_boundary.any()
            else "boundary-pinned mode" if res.ok
            else "non-positive-definite curvature (mode on a veto/bound)")
    print(f"Laplace quick-look in {time.time() - t0:.1f}s — {kind}")
    sd_col = res.sd if res.ok else res.sd_conditional
    print(f"{'':>18} | {'MAP':>9} | {'Sd':>8} | {'Unit':>12}")
    print("-" * 57)
    for i, n in enumerate(p.thawed):
        sd = (f"{sd_col[i]:8.3f}" if np.isfinite(sd_col[i]) else "     n/a")
        flag = " *" if res.at_boundary[i] else ""
        print(f"{n:>18} | {res.theta_map[i]:9.3f} | {sd} | "
              f"{p[n].unit:>12}{flag}")
    if res.at_boundary.any():
        print("  (* = MAP pinned at a prior bound; the remaining error "
              "bars are conditional on the pinned values)")
    if np.isfinite(res.log_z_normalized):
        print(f"Laplace log-evidence (normalized prior): "
              f"{res.log_z_normalized:.2f} "
              f"(prior log-norm {res.prior_log_norm:.2f} "
              f"+- {res.prior_log_norm_err:.3f})")
    else:
        print("Laplace evidence undefined at a boundary-pinned mode; "
              "use sampling.model_evidence (stepping-stone ladder)")

    def _j(v):          # strict JSON: non-finite -> null
        v = float(v)
        return v if np.isfinite(v) else None

    out = {
        "ok": res.ok,
        "theta_map": dict(zip(p.thawed, map(_j, res.theta_map))),
        "sd": dict(zip(p.thawed, map(_j, res.sd))),
        "sd_conditional": dict(zip(p.thawed, map(_j, res.sd_conditional))),
        "at_boundary": dict(zip(p.thawed,
                                res.at_boundary.astype(bool).tolist())),
        "eigenvalues_negH": [_j(v) for v in res.eigenvalues],
        "log_post_map": _j(res.log_post_map),
        "log_z": _j(res.log_z),
        "log_z_normalized": _j(res.log_z_normalized),
        "prior_log_norm": _j(res.prior_log_norm),
        "prior_log_norm_err": _j(res.prior_log_norm_err),
    }
    save = pathlib.Path(cfg.save_dir)
    save.mkdir(parents=True, exist_ok=True)
    path = save / f"{cfg.name}_laplace.json"
    path.write_text(json.dumps(out, indent=2, default=float))
    print(f"written {path}")
    return res


def torch_device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    main()
