"""Electron-pressure profiles.

Torch counterparts of ``joxsz_tpu/models/pressure.py``:

* ``GNFWPressure`` (reference ``CmptPressure``, joxsz_funcs.py:248-301):

      P(r) = P0 / [ (r/rp)^c * (1 + (r/rp)^a)^((b-c)/a) ]

  with its analytic radial derivative (used by the hydrostatic-mass veto);
* ``KnotPressure`` (BASELINE config #4): log10 P interpolated linearly in
  log10 r between fixed knots (``jnp.interp`` semantics: clamped outside
  the knots), whose values are the free parameters; its derivative is
  the segment slope, as autodiff of the interpolant gives it.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
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


class KnotPressure:
    """Non-parametric pressure: log10 P interpolated linearly in log10 r
    between fixed knots (values are the free parameters)."""

    def __init__(self, knots_r_kpc=None, init_logP=None,
                 bounds_logP: tuple[float, float] = (-7.0, 2.0),
                 name: str = "p", knots_logr=None):
        self.name = name
        self.knots_logr = (np.asarray(knots_logr, dtype=float)
                           if knots_logr is not None else
                           np.log10(np.asarray(knots_r_kpc, dtype=float)))
        self.n_knots = self.knots_logr.size
        if init_logP is None:
            # seed from a typical gNFW shape
            r = 10.0 ** self.knots_logr
            x = r / 300.0
            init_logP = np.log10(0.4 / (x**0.014 * (1 + x**1.33) ** 3.08))
        self.init_logP = np.asarray(init_logP, dtype=float)
        self.bounds_logP = bounds_logP

    def param_names(self) -> list[str]:
        return [f"logP_{i}" for i in range(self.n_knots)]

    def default_params(self) -> ParamSet:
        lo, hi = self.bounds_logP
        return ParamSet(OrderedDict(
            (f"logP_{i}", Param(float(self.init_logP[i]), lo, hi,
                                unit="log(keV.cm^{-3})"))
            for i in range(self.n_knots)))

    def _segments(self, logr: torch.Tensor):
        """``jnp.interp``'s segment of each radius: i = clip(searchsorted(
        knots, logr, 'right'), 1, n - 1), the left knot i - 1, and where
        the radius lies below the first or above the last knot."""
        xp = torch.as_tensor(self.knots_logr, dtype=logr.dtype,
                             device=logr.device)
        i = torch.clamp(torch.searchsorted(xp, logr.contiguous(),
                                           right=True), 1, self.n_knots - 1)
        return xp, i, logr < xp[0], logr > xp[-1]

    def _values(self, pars: dict) -> torch.Tensor:
        return torch.cat([pars[n] for n in self.param_names()], dim=-1)

    @staticmethod
    def _at(fp: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Knot values ``fp`` (B, n_knots) at segment indices ``i``: (n_r,)
        shared by every row, or (B, n_r) per row (per-draw radii)."""
        if i.dim() == 1:
            return fp[:, i]
        return torch.gather(fp, 1, i.expand(fp.shape[0], -1))

    def _log_press(self, pars: dict, logr: torch.Tensor) -> torch.Tensor:
        """(B, n_r) clamped lerp of the knot values at ``logr``: (n_r,), or
        (B, n_r) radii of their own per row."""
        fp = self._values(pars)                          # (B, n_knots)
        xp, i, below, above = self._segments(logr)
        f0, f1 = self._at(fp, i - 1), self._at(fp, i)
        f = f0 + ((logr - xp[i - 1]) / (xp[i] - xp[i - 1])) * (f1 - f0)
        f = torch.where(below, fp[:, :1], f)
        return torch.where(above, fp[:, -1:], f)

    def __call__(self, pars: dict, r_kpc) -> torch.Tensor:
        return 10.0 ** self._log_press(pars, torch.log10(r_kpc))

    def derivative(self, pars: dict, r_kpc) -> torch.Tensor:
        """dP/dr = P * ln10 * (dlog10 P / dlog10 r) / (r ln10), the slope
        of the radius's segment and zero where the lerp is clamped (what
        autodiff of ``jnp.interp`` gives)."""
        logr = torch.log10(r_kpc)
        fp = self._values(pars)
        xp, i, below, above = self._segments(logr)
        slope = (self._at(fp, i) - self._at(fp, i - 1)) / (xp[i] - xp[i - 1])
        slope = torch.where(below | above, torch.zeros_like(slope), slope)
        ln10 = float(np.log(10.0))
        return self(pars, r_kpc) * ln10 * slope / (r_kpc * ln10)

    def mass_veto_radii(self) -> np.ndarray:
        """Segment midpoints (log-space) for the HSE-mass physicality
        veto: the piecewise log-lerp makes dP/dr, hence the mass,
        discontinuous at the knots, so the veto reads the segment-averaged
        mass at one midpoint per segment (``JointModel._mass_veto_ok``)."""
        return 10.0 ** ((self.knots_logr[:-1] + self.knots_logr[1:]) / 2.0)
