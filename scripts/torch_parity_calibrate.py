"""Calibrate the port's posterior-level referee on the card.

The recipe of ``scripts/parity_power_calibrate.py`` for the port's
device samplers (``tests/torch_parity.py``), on the synthetic CL J1226
posterior at the referee's schedule and box.  For each seed base it
measures:

  1. the numpy-vs-numpy scatter: two independent sets of k_ref referee
     replicates;
  2. each arm (``k1``, ``k4`` cold rung, ``roll``) against the referee;
  3. the control's (acceptance exponent (d-1) -> (d+1)) effect on
     medians and widths, against the referee and against each arm;

with the walls, and writes ``<out-dir>/torch_parity_calibration_s<base>
.json`` with the card's name and power limit.  The bands of
``tests/torch_parity.py`` cite these files; re-run after any change of
its schedule or box.

    python scripts/torch_parity_calibrate.py [--seed-bases 0 1000 2000]
        [--out-dir results] [--replicates K]
    python scripts/torch_parity_calibrate.py --cpu    # a tiny rehearsal
    python scripts/torch_parity_calibrate.py --long 40000
    python scripts/torch_parity_calibrate.py --box-scan 0.75 1 1.5 2 3 100
    python scripts/torch_parity_calibrate.py --box-scan 1.5 2 \\
        --box-params P_0 a b r_p '\\epsilon' Z --schedules 5000:20000

``--cpu`` runs a tiny schedule on a small dataset through the kernels'
plain versions and writes nothing.  The two convergence checks behind the
schedule and the box, on the session's own prior box: ``--long N``, per
parameter, the width and the integrated autocorrelation time of one
referee chain and of two chains of each arm, N steps after the burn-in
each (``<out-dir>/torch_parity_long_<N>.json``); ``--box-scan M ...``,
the device arms in prior boxes of +-M posterior sds
(``<out-dir>/torch_parity_box_scan[_all|_part].json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import torch_parity as tp  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def per_param(out: dict, a: str, b: str) -> dict:
    """Per-parameter median differences in pooled widths and log width
    ratios of replicate sets a and b (the quantities ``parity_stats``
    takes the maximum of)."""
    wa = np.median(out[a]["widths"], axis=0)
    wb = np.median(out[b]["widths"], axis=0)
    dmed = (out[a]["medians"].mean(0) - out[b]["medians"].mean(0)) \
        / (0.5 * (wa + wb))
    dmed_val, dwidth_val = tp.stats(out, a, b)
    return {"dmed": float(dmed_val), "dwidth": float(dwidth_val),
            "dmed_per_param": dmed.tolist(),
            "log_width_ratio_per_param": np.log(wa / wb).tolist()}


def long_chains(consts, theta_c, n_steps: int, card: str, out_dir: str,
                names: list):
    """``--long``: widths and autocorrelation times of long chains."""
    from joxsz_torch.postproc import integrated_autocorr_time

    s = tp.replicate_seeds(0)
    sched = dataclasses.replace(tp.Schedule(), steps=n_steps, thin=10)
    res = {"card": card, "torch": torch.__version__, "steps": n_steps,
           "burn": sched.burn, "thin": sched.thin, "w": sched.w,
           "params": names}

    def keep(tag, chain, wall):
        tau = integrated_autocorr_time(chain) * sched.thin
        res[tag] = {"widths": np.std(chain.reshape(-1, chain.shape[-1]),
                                     axis=0).tolist(),
                    "tau_steps": tau.tolist(), "wall_s": wall}
        print(f"long {tag:6s} {wall:7.1f} s; width / referee's: "
              + " ".join(f"{w:.3f}" for w in np.array(res[tag]["widths"])
                         / np.array(res.get("np", res[tag])["widths"]))
              + "; tau " + " ".join(f"{t:.0f}" for t in tau), flush=True)

    rng = np.random.default_rng(s["ref"])
    t0 = time.perf_counter()
    ch = tp.run_lockstep(tp.referee_log_prob(consts), [tp.stretch_moves(
        tp.init(theta_c, rng), sched.burn + n_steps, rng,
        thin=sched.thin)])[0]
    keep("np", ch[sched.burn // sched.thin:].astype(np.float32),
         time.perf_counter() - t0)
    for arm in tp.ARMS:
        for r in range(2):
            t0 = time.perf_counter()
            ch = tp.arm_chain(arm, consts,
                              tp.init(theta_c, np.random.default_rng(
                                  s["dev"] + r)),
                              np.random.default_rng(s["burn"] + r),
                              np.random.default_rng(s["run"] + r), sched)
            keep(f"{arm}_{r}", ch, time.perf_counter() - t0)
    path = pathlib.Path(out_dir) / f"torch_parity_long_{n_steps}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    print(f"written {path}", flush=True)


def box_scan(sess, consts, theta_c, margins, card: str, out_dir: str,
             box_params=None, schedules=None, n_long: int = 40000):
    """``--box-scan``: the device arms in prior boxes of +-M posterior
    sds around the posterior median (the k4 arm's, n_long steps on the
    session's box) on the parameters ``box_params`` (default: all), each
    box widened to hold the start ball (4 sds of the 2% init around the
    centre).  Per box: without ``schedules``, the K=1 chain's
    autocorrelation time and the k4 / k1 width ratios at n_long steps;
    at the JAX test's schedule (1000 + 4000 steps) and at each of
    ``schedules`` ((burn, steps), thin 10), the k1-vs-k1 scatter of two
    replicate sets and k4 and roll against k1 (the numpy referee follows
    the k1 arm's law)."""
    from joxsz_torch.postproc import integrated_autocorr_time

    p = sess.params
    names = list(p.thawed)
    boxed = [names.index(n) for n in (box_params or names)]
    s = tp.replicate_seeds(0)
    long = dataclasses.replace(tp.Schedule(), steps=n_long, thin=10)

    def long_chain(arm, c, r=0):
        return tp.arm_chain(
            arm, c, tp.init(theta_c, np.random.default_rng(s["dev"] + r)),
            np.random.default_rng(s["burn"] + r),
            np.random.default_rng(s["run"] + r), long)

    flat = long_chain("k4", consts).reshape(-1, len(names))
    med, sd = np.median(flat, axis=0), np.std(flat, axis=0)
    scheds = [tp.Schedule()] + [dataclasses.replace(
        tp.Schedule(), burn=b, steps=st, thin=10) for b, st in schedules or []]
    res = {"card": card, "steps_long": n_long, "params": names,
           "box_params": [names[i] for i in boxed],
           "median_k4": med.tolist(), "sd_k4": sd.tolist(), "boxes": {}}
    ball = 4 * 0.02 * np.abs(theta_c)
    lo0, hi0 = p.lo.copy(), p.hi.copy()
    for m in margins:
        lo, hi = lo0.copy(), hi0.copy()
        lo[boxed] = np.maximum(lo0, np.minimum(med - m * sd,
                                               theta_c - ball))[boxed]
        hi[boxed] = np.minimum(hi0, np.maximum(med + m * sd,
                                               theta_c + ball))[boxed]
        box = {n: (float(a), float(b)) for n, a, b in zip(names, lo, hi)}
        _, c, _ = tp.referee_session(sess.config, consts.device, box=box)
        entry = {"lo": lo.tolist(), "hi": hi.tolist(), "schedules": {}}
        if not schedules:
            ch1 = long_chain("k1", c)
            w4 = np.std(long_chain("k4", c).reshape(-1, len(names)), axis=0)
            w1 = np.std(ch1.reshape(-1, len(names)), axis=0)
            tau = integrated_autocorr_time(ch1) * long.thin
            entry.update(tau_k1=tau.tolist(), width_k1=w1.tolist(),
                         width_k4=w4.tolist())
            print(f"box +-{m} sd: tau_k1 max {tau.max():.0f} steps "
                  f"({names[int(tau.argmax())]}); long width k4/k1 "
                  + " ".join(f"{v:.2f}" for v in w4 / w1), flush=True)
        for sched in scheds:
            sets = {tag: tp.device_replicates(arm, c, theta_c, sched.k_dev,
                                              base, sched)
                    for tag, arm, base in (("k1", "k1", 0),
                                           ("k1b", "k1", 1000),
                                           ("k4", "k4", 0),
                                           ("roll", "roll", 0))}
            st = {f"{a}_vs_k1": per_param(sets, a, "k1")
                  for a in ("k1b", "k4", "roll")}
            key = f"{sched.burn}:{sched.steps}"
            entry["schedules"][key] = st
            print(f"box +-{m} sd, {key}: " + "; ".join(
                f"{k} dmed {v['dmed']:.3f} dwidth {v['dwidth']:.3f} (lw "
                + " ".join(f"{x:+.2f}" for x in
                           v["log_width_ratio_per_param"]) + ")"
                for k, v in st.items()), flush=True)
        res["boxes"][str(m)] = entry
    tag = "" if not schedules else "_all" if box_params is None else "_part"
    path = pathlib.Path(out_dir) / f"torch_parity_box_scan{tag}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    print(f"written {path} on {card}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed-bases", type=int, nargs="+",
                    default=[0, 1000, 2000])
    ap.add_argument("--out-dir", default=str(REPO / "results"))
    ap.add_argument("--replicates", type=int, metavar="K",
                    help="K replicates of the referee, of its second set "
                         "and of each arm (the schedule's k_ref, k_dev); "
                         "the first k of them are those a run at k "
                         "replicates draws")
    ap.add_argument("--cpu", action="store_true",
                    help="a tiny rehearsal on the CPU; writes nothing")
    ap.add_argument("--long", type=int, metavar="N",
                    help="only the convergence check: chains of N steps")
    ap.add_argument("--box-scan", type=float, nargs="+", metavar="M",
                    help="only the box scan: device chains in boxes of "
                         "+-M posterior sds")
    ap.add_argument("--box-params", nargs="+", metavar="NAME",
                    help="--box-scan: box these parameters only")
    ap.add_argument("--schedules", nargs="+", metavar="BURN:STEPS",
                    help="--box-scan: replicate sets at these schedules")
    args = ap.parse_args(argv)
    if args.cpu:
        device, card = "cpu", "cpu (rehearsal)"
        shape = dict(n_annuli=6, n_sz=6, max_radius_arcsec=30.0,
                     extent_kpc=800.0)
        sched = tp.Schedule(w=32, burn=10, steps=10, k_ref=2, k_dev=2,
                            k_ctrl=2)
    else:
        if not torch.cuda.is_available():
            print("torch_parity_calibrate: no CUDA device visible "
                  "(--cpu rehearses on the CPU)", file=sys.stderr)
            return 2
        device, card, shape, sched = "cuda", card_line(), {}, tp.SCHEDULE
    if args.replicates:
        sched = dataclasses.replace(sched, k_ref=args.replicates,
                                    k_dev=args.replicates)
    print(f"card: {card}; schedule {sched}; box {tp.REFEREE_BOX}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if args.long or args.box_scan:
            # the convergence checks: on the session's own prior box
            sess, consts, theta_c = tp.session(tmp, device, box=None,
                                               **shape)
        else:
            sess, consts, theta_c = tp.session(tmp, device, **shape)
        names = list(sess.params.thawed)
        if args.long:
            long_chains(consts, theta_c, args.long, card, args.out_dir,
                        names)
            return 0
        if args.box_scan:
            scheds = [tuple(int(v) for v in a.split(":"))
                      for a in args.schedules or []]
            box_scan(sess, consts, theta_c, args.box_scan, card,
                     args.out_dir, args.box_params, scheds)
            return 0
        for base in args.seed_bases:
            t0 = time.perf_counter()
            out = tp.run_referee(consts, theta_c, seed_base=base,
                                 second_reference=True, sched=sched)
            wall = time.perf_counter() - t0
            res = {"card": card, "torch": torch.__version__,
                   "data_seed": tp.DATA_SEED, "seed_base": base,
                   "schedule": dataclasses.asdict(sched),
                   "box": tp.REFEREE_BOX, "ctrl_offset": tp.CTRL_OFFSET,
                   "n_rungs_k4": tp.N_RUNGS, "params": names,
                   "wall_s": wall,
                   "bands": {"med": tp.MED_BAND, "width": tp.WIDTH_BAND},
                   "replicates": {k: {"medians": v["medians"].tolist(),
                                      "widths": v["widths"].tolist(),
                                      "wall_s": v["wall"]}
                                  for k, v in out.items()},
                   "np_vs_np2": per_param(out, "np", "np2")}
            for arm in tp.ARMS:
                res[f"{arm}_vs_np"] = per_param(out, arm, "np")
            for ref in ("np",) + tp.ARMS:
                res[f"ctrl_vs_{ref}"] = per_param(out, "ctrl", ref)
            for key in [k for k in res if "_vs_" in k]:
                print(f"s{base} {key:12s} dmed {res[key]['dmed']:.4f} "
                      f"dwidth {res[key]['dwidth']:.4f} (lw " + " ".join(
                          f"{x:+.2f}" for x in
                          res[key]["log_width_ratio_per_param"]) + ")",
                      flush=True)
            print(f"s{base} walls: numpy sets (lockstep) "
                  f"{out['np']['wall']:.1f} s, " + ", ".join(
                      f"{a} {out[a]['wall']:.1f} s" for a in tp.ARMS)
                  + f"; total {wall:.1f} s on {card}", flush=True)
            if not args.cpu:
                path = pathlib.Path(args.out_dir) / \
                    f"torch_parity_calibration_s{base}.json"
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(json.dumps(res, indent=1))
                print(f"written {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
