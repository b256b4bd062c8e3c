"""Temperature profiles.

Torch counterparts of ``joxsz_tpu/models/temperature.py``:

* ``UPPTemperature`` (reference ``CmptUPPTemperature``,
  joxsz_funcs.py:303-339): T_SZ = P/ne, and a free log-ratio maps it to
  the spectroscopic X-ray temperature;
* ``VikhlininTemperature`` (BASELINE config #4): the Vikhlinin+2006 form
  with b_t fixed at 2, decoupled from the pressure,

      T(r) = T0 * (x^ac + Tmin/T0)/(x^ac + 1) / (1 + (r/rt)^2)^(ct/2),
      x = r / rcool.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .params import Param, ParamSet


class UPPTemperature:
    """T_SZ = P/ne (keV); T_X = T_SZ * 10^log(T_X/T_SZ)."""

    def __init__(self, pressure, density, name: str = "T"):
        self.name = name
        self.pressure = pressure
        self.density = density

    def default_params(self) -> ParamSet:
        return ParamSet(OrderedDict([
            ("log(T_X/T_{SZ})", Param(0.0, -1.0, 1.0)),
        ]))

    def t_sz(self, pars: dict, r_kpc) -> torch.Tensor:
        return self.pressure(pars, r_kpc) / self.density(pars, r_kpc)

    def t_x(self, pars: dict, r_kpc) -> torch.Tensor:
        return self.t_sz(pars, r_kpc) * 10.0 ** pars["log(T_X/T_{SZ})"]


class VikhlininTemperature:
    """Parametric 3D temperature profile (keV), decoupled from pressure
    (b_t = 2; six free parameters)."""

    def __init__(self, name: str = "T"):
        self.name = name

    def default_params(self) -> ParamSet:
        return ParamSet(OrderedDict([
            ("T_0", Param(8.0, 0.5, 30.0, unit="keV")),
            ("T_{min}/T_0", Param(0.7, 0.05, 1.0)),
            ("r_{cool}", Param(100.0, 1.0, 1000.0, unit="kpc")),
            ("a_{cool}", Param(2.0, 0.1, 10.0)),
            ("r_t", Param(1000.0, 100.0, 5000.0, unit="kpc")),
            ("c_t", Param(1.0, 0.0, 4.0)),
        ]))

    def t_x(self, pars: dict, r_kpc) -> torch.Tensor:
        r = r_kpc
        x = (r / pars["r_{cool}"]) ** pars["a_{cool}"]
        cool = (x + pars["T_{min}/T_0"]) / (x + 1.0)
        outer = (1.0 + (r / pars["r_t"]) ** 2) ** (-pars["c_t"] / 2.0)
        return pars["T_0"] * cool * outer

    t_sz = t_x
