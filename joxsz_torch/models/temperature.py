"""Temperature profile: the UPP ideal-gas temperature.

Torch counterpart of ``joxsz_tpu/models/temperature.py::UPPTemperature``
(reference ``CmptUPPTemperature``, joxsz_funcs.py:303-339): T_SZ = P/ne,
and a free log-ratio maps it to the spectroscopic X-ray temperature.
The parametric Vikhlinin temperature waits for a later slice.
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
