"""Example (PyTorch port): fitting with a custom pressure component.

Any object exposing ``default_params() -> ParamSet``, ``__call__(pars,
r_kpc)`` and ``derivative(pars, r_kpc)`` plugs into ``joxsz_torch`` --
here a beta-model pressure profile, fit SZ-only to a synthetic CL
J1226-shaped dataset (``joxsz_torch.synth``).  The CUDA kernels cover the
built-in model families only (``ops.consts_layout.detect_family``
returns None for this layout), so the fit runs on the plain samplers, on
the card or with ``--cpu`` on the CPU.

    python examples/torch_custom_pressure.py [--cpu] [--smoke]
"""

import argparse
import pathlib
import sys
import tempfile
from collections import OrderedDict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from joxsz_torch.build import build_session  # noqa: E402
from joxsz_torch.device import resolve_device  # noqa: E402
from joxsz_torch.models import (JointModel, Param, ParamSet,  # noqa: E402
                                VikhlininDensity, UPPTemperature,
                                gaussian_param)
from joxsz_torch.sampling import run_fit  # noqa: E402
from joxsz_torch.synth import write_synthetic_dataset  # noqa: E402


# --smoke: 6 SZ points out to 30", an 800 kpc pressure grid
SMOKE_SHAPE = dict(n_sz=6, max_radius_arcsec=30.0, extent_kpc=800.0)


class BetaPressure:
    """P(r) = P0 (1 + (r/rc)^2)^(-3 beta / 2)."""

    name = "p"

    def default_params(self) -> ParamSet:
        return ParamSet(OrderedDict([
            ("P_0", Param(0.2, 0.0, 2.0, unit="keV.cm^{-3}")),
            ("r_{c,P}", Param(300.0, 20.0, 2000.0, unit="kpc")),
            (r"\beta_P", Param(1.0, 0.1, 4.0)),
        ]))

    def __call__(self, pars, r_kpc):
        x = r_kpc / pars["r_{c,P}"]
        return pars["P_0"] * (1.0 + x * x) ** (-1.5 * pars[r"\beta_P"])

    def derivative(self, pars, r_kpc):
        """dP/dr = -3 beta P x / (rc (1 + x^2))."""
        rc = pars["r_{c,P}"]
        x = r_kpc / rc
        return -3.0 * pars[r"\beta_P"] * self(pars, r_kpc) * x \
            / (rc * (1.0 + x * x))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a small dataset, no MLE and a tiny schedule for "
                         "CI (posterior meaningless)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_synthetic_dataset(tmp, args.seed,
                                      **(SMOKE_SHAPE if args.smoke else {}))
        sess = build_session(cfg, device=dev, sz_only=True)

    pressure = BetaPressure()
    density = VikhlininDensity()
    temperature = UPPTemperature(pressure, density)
    pars = density.default_params()
    pars.update(pressure.default_params())
    pars.update(OrderedDict([("calibration",
                              gaussian_param(1.0, 1.0, 0.07))]))
    pars.freeze(r"\alpha", 0.0)
    pars.freeze(r"\gamma", 3.0)
    model = JointModel(pressure=pressure, density=density,
                       temperature=temperature, params=pars,
                       sz_data=sess.model.sz_data,
                       exclude_unphysical_mass=False)

    sched = (dict(nwalkers=30, nburn=40, nsteps=60, nthin=2,
                  prelim_iterations=20, max_prelim_rounds=1)
             if args.smoke else
             dict(nwalkers=30, nburn=300, nsteps=600, nthin=5,
                  prelim_iterations=200, max_prelim_rounds=2))
    res = run_fit(model, None, pars.thawed_values(), pars.lo, pars.hi,
                  pars.thawed, seed=args.seed, do_mle=not args.smoke,
                  verbose=False, **sched)
    print(f"beta-model pressure, SZ-only, on {dev} (plain samplers): "
          f"acceptance {res.acceptance_fraction.mean():.3f}")
    res.print_summary([pars[n].unit for n in pars.thawed])
    return res


if __name__ == "__main__":
    main()
