"""Example (PyTorch port): Bayesian model comparison.

Which pressure / density parametrisation does a joint SZ + X-ray dataset
prefer?  Each family's log-evidence comes from the stepping-stone ladder
(``joxsz_torch.sampling.model_evidence``) on a synthetic CL J1226-shaped
dataset (``joxsz_torch.synth``, drawn from the single-component gNFW
model), and the families are ranked by Bayes factor.  Evidences are
w.r.t. each family's own normalised prior, so a family with more
parameters pays its Occam factor.

    python examples/torch_model_comparison.py [--cpu] [--quick | --smoke]
        [--out evidence.json]
"""

import argparse
import copy
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from joxsz_torch.build import build_session  # noqa: E402
from joxsz_torch.device import resolve_device  # noqa: E402
from joxsz_torch.sampling import model_evidence  # noqa: E402
from joxsz_torch.synth import write_synthetic_dataset  # noqa: E402

# --smoke: 6 annuli, 6 SZ points out to 30", an 800 kpc pressure grid
SMOKE_SHAPE = dict(n_annuli=6, n_sz=6, max_radius_arcsec=30.0,
                   extent_kpc=800.0)
FAMILIES = {
    "gnfw_single": {},
    "knots_single": {"pressure_model": "knots"},
    "gnfw_double": {"density_mode": "double"},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="small ladder / schedule")
    ap.add_argument("--smoke", action="store_true",
                    help="two families, a small dataset and a tiny ladder "
                         "for CI (numbers meaningless)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    families = FAMILIES
    if args.smoke:
        families = {k: FAMILIES[k] for k in ("gnfw_single", "gnfw_double")}
        kw = dict(n_rungs=3, n_walkers=32, n_steps=40, n_burn=40, thin=4)
    elif args.quick:
        kw = dict(n_rungs=8, n_walkers=64, n_steps=400, n_burn=400,
                  thin=10)
    else:
        kw = dict(n_rungs=16, n_walkers=256, n_steps=4000, n_burn=2000,
                  thin=20)

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = write_synthetic_dataset(tmp, args.seed,
                                       **(SMOKE_SHAPE if args.smoke else {}))
        for name, overrides in families.items():
            cfg = copy.deepcopy(base)
            for k, v in overrides.items():
                setattr(cfg, k, v)
            sess = build_session(cfg, device=dev)
            t0 = time.time()
            res = model_evidence(sess.model, seed=args.seed, **kw)
            wall = time.time() - t0
            results[name] = {
                "log_z": res.log_z, "log_z_err": res.log_z_err,
                "log_z_ti": res.log_z_ti,
                "swap_acceptance": [float(s) for s in res.swap_acceptance],
                "wall_s": wall,
            }
            print(f"{name:14s}  log Z = {res.log_z:.2f} +- "
                  f"{res.log_z_err:.2f}  (TI {res.log_z_ti:.2f}; swaps "
                  f"{min(res.swap_acceptance):.2f}-"
                  f"{max(res.swap_acceptance):.2f}; {wall:.1f} s on {dev})",
                  flush=True)

    ref = results["gnfw_single"]["log_z"]
    print("\nlog Bayes factors vs gnfw_single:")
    for name, r in results.items():
        if name != "gnfw_single":
            r["log_bf_vs_gnfw_single"] = r["log_z"] - ref
            print(f"  {name:14s} {r['log_bf_vs_gnfw_single']:+.2f}")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"schedule": kw, "seed": args.seed,
                                   "device": str(dev),
                                   "families": results}, indent=2))
        print(f"\nwritten {out}")
    return results


if __name__ == "__main__":
    main()
