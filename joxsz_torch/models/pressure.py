"""Electron-pressure profile: the generalised-NFW component.

Torch counterpart of ``joxsz_tpu/models/pressure.py::GNFWPressure``
(reference ``CmptPressure``, joxsz_funcs.py:248-301):

    P(r) = P0 / [ (r/rp)^c * (1 + (r/rp)^a)^((b-c)/a) ]

with its analytic radial derivative (used by the hydrostatic-mass veto).
The non-parametric knot family waits for a later slice of the port.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .params import Param, ParamSet


def softplus(z: torch.Tensor) -> torch.Tensor:
    """ln(1 + e^z) in the overflow-free form max(z, 0) + log1p(e^-|z|)
    (``jax.nn.softplus``; torch's own softplus switches to z above a
    threshold, which is a different function there)."""
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))


class GNFWPressure:
    """gNFW pressure (keV cm^-3) with the reference's defaults/bounds."""

    def __init__(self, name: str = "p"):
        self.name = name

    def default_params(self) -> ParamSet:
        return ParamSet(OrderedDict([
            ("P_0", Param(0.4, 0.0, 2.0, unit="keV.cm^{-3}")),
            ("a", Param(1.33, 0.1, 20.0)),
            ("b", Param(4.13, 0.1, 15.0)),
            ("c", Param(0.014, 0.0, 3.0)),
            ("r_p", Param(300.0, 100.0, 3000.0, unit="kpc")),
        ]))

    def __call__(self, pars: dict, r_kpc) -> torch.Tensor:
        # log-space evaluation: the naive (1+x^a)^((b-c)/a) overflows f32
        # for in-bounds corners (x=50, a=20 -> x^a ~ 1e34); softplus(a ln x)
        # never materialises x^a
        P0, a, b, c, rp = (pars["P_0"], pars["a"], pars["b"], pars["c"],
                           pars["r_p"])
        lnx = torch.log(r_kpc / rp)
        return P0 * torch.exp(-c * lnx - ((b - c) / a) * softplus(a * lnx))

    def derivative(self, pars: dict, r_kpc) -> torch.Tensor:
        """Analytic dP/dr (keV cm^-3 kpc^-1) as -(P/r)(c + (b-c) sigmoid(a
        ln x)): underflows only where P does, so the HSE-mass veto never
        sees a spurious -0 (tests/test_precision.py pins this form)."""
        a, b, c, rp = pars["a"], pars["b"], pars["c"], pars["r_p"]
        press = self(pars, r_kpc)
        s = torch.sigmoid(a * torch.log(r_kpc / rp))
        return -press / r_kpc * (c + (b - c) * s)
