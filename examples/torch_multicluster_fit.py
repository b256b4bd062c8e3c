"""Example (PyTorch port): batched multi-cluster fitting.

Fits C independent clusters at once, each with its own walker ensemble,
on one device: the clusters are mock observations simulated
(``joxsz_torch.simulate``) from known parameter vectors through one
synthetic CL J1226-shaped instrument configuration (``joxsz_torch.
synth``), and the final walker clouds' medians are compared with the
injected truths.  The likelihood is the plain batched one of
``models.multicluster``; ``python -m joxsz_torch.survey`` is the route
through the cluster-grid kernel and over several cards (``--mesh``).

    python examples/torch_multicluster_fit.py [--cpu] [--smoke]
"""

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from joxsz_torch.build import build_session  # noqa: E402
from joxsz_torch.device import resolve_device  # noqa: E402
from joxsz_torch.models.multicluster import (  # noqa: E402
    make_multicluster_log_like)
from joxsz_torch.parallel import make_mesh, run_multi_cluster  # noqa: E402
from joxsz_torch.simulate import simulate_survey  # noqa: E402
from joxsz_torch.synth import truth_theta, write_synthetic_dataset  # noqa

# --smoke: 6 annuli, 6 SZ points out to 30", an 800 kpc pressure grid
SMOKE_SHAPE = dict(n_annuli=6, n_sz=6, max_radius_arcsec=30.0,
                   extent_kpc=800.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a small dataset and a tiny schedule for CI")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_synthetic_dataset(tmp, args.seed,
                                      **(SMOKE_SHAPE if args.smoke else {}))
        sess = build_session(cfg, device=dev)

    # --- inject a mock survey: C clusters with distinct true parameters ---
    C = 4
    theta0 = truth_theta(sess)
    names = list(sess.params.thawed)
    rng = np.random.default_rng(args.seed)
    thetas_true = np.tile(theta0, (C, 1))
    thetas_true[:, names.index("P_0")] *= np.linspace(0.7, 1.3, C)
    thetas_true[:, names.index(r"\beta")] += np.linspace(-0.03, 0.03, C)
    survey = simulate_survey(sess.model, thetas_true, rng)
    batched_ll = make_multicluster_log_like(sess.model, survey.sz_stack,
                                            survey.xray_stack)

    # --- one ensemble per cluster, all on one device -----------------------
    mesh = make_mesh(1, axis_names=("cluster", "walker"), devices=[dev])
    W = 32
    p0 = torch.as_tensor(thetas_true[:, None, :] * (
        1 + 0.02 * rng.standard_normal((C, W, theta0.size))),
        dtype=survey.sz_stack.L.dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    with torch.no_grad():
        out = run_multi_cluster(batched_ll, p0,
                                n_steps=50 if args.smoke else 500, gen=gen,
                                mesh=mesh)
    print(f"{C} clusters x {W} walkers on {dev}")
    print("acceptance per cluster:",
          out["acceptance_fraction"].mean(axis=1).round(3))
    print("best log-prob per cluster:", out["log_prob"].max(axis=1).round(1))

    # --- recovery: final walker-cloud medians vs injected truths -----------
    # (500 steps is a demo schedule, not a converged posterior)
    med = np.median(out["positions"], axis=1)          # (C, ndim)
    for pname in ("P_0", r"\beta"):
        i = names.index(pname)
        print(f"{pname:8s} truth {np.round(thetas_true[:, i], 3)}"
              f"  median {np.round(med[:, i], 3)}")
    return out


if __name__ == "__main__":
    main()
