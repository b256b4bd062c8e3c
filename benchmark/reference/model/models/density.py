"""Electron-density profile: Vikhlinin, single or double mode.

Torch counterpart of ``joxsz_tpu/models/density.py`` (reference patched
``CmptVikhDensity``, joxsz_funcs.py:341-407):

    ne^2(r) = n0^2 (r/rc)^-alpha / [ (1+(r/rc)^2)^(3 beta - alpha/2)
                                     (1+(r/rs)^gamma)^(eps/gamma) ]
    (+ in mode "double" the beta-model term n02^2 / (1+(r/rc2)^2)^(3 beta2))

with the reference's renamed parameters/bounds and the r_c < r_s shape
prior (-inf veto).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .params import Param, ParamSet


class VikhlininDensity:
    """Vikhlinin-parametrised ne(r) in cm^-3; mode 'single' or
    'double'."""

    def __init__(self, name: str = "ne", mode: str = "single"):
        if mode not in ("single", "double"):
            raise ValueError(f"unknown mode {mode!r}")
        self.name = name
        self.mode = mode

    def default_params(self) -> ParamSet:
        pars = OrderedDict([
            ("log(n_0)", Param(-3.0, -7.0, 2.0, unit="log(cm^{-3})")),
            (r"\beta", Param(2.0 / 3.0, 0.0, 4.0)),
            ("log(r_c)", Param(2.3, -1.0, 3.7, unit="log(kpc)")),
            ("log(r_s)", Param(2.7, 0.0, 3.7, unit="log(kpc)")),
            (r"\alpha", Param(0.0, -1.0, 2.0)),
            (r"\epsilon", Param(3.0, 0.0, 5.0)),
            (r"\gamma", Param(3.0, 0.0, 10.0, frozen=True)),
        ])
        if self.mode == "double":
            # the second component starts negligible, so the default start
            # passes the HSE-mass veto (joxsz_tpu/models/density.py)
            pars.update([
                ("log(n_{02})", Param(-6.0, -7.0, 2.0,
                                      unit="log(cm^{-3})")),
                (r"\beta_2", Param(0.5, 0.0, 4.0)),
                ("log(r_{c2})", Param(1.7, -1.0, 3.7, unit="log(kpc)")),
            ])
        return ParamSet(pars)

    def __call__(self, pars: dict, r_kpc) -> torch.Tensor:
        n0 = 10.0 ** pars["log(n_0)"]
        beta = pars[r"\beta"]
        rc = 10.0 ** pars["log(r_c)"]
        rs = 10.0 ** pars["log(r_s)"]
        alpha = pars[r"\alpha"]
        eps = pars[r"\epsilon"]
        gamma = pars[r"\gamma"]
        r = r_kpc
        ne2 = (n0**2 * (r / rc) ** (-alpha)
               / ((1.0 + (r / rc) ** 2) ** (3.0 * beta - alpha / 2.0)
                  * (1.0 + (r / rs) ** gamma) ** (eps / gamma)))
        if self.mode == "double":
            n02 = 10.0 ** pars["log(n_{02})"]
            rc2 = 10.0 ** pars["log(r_{c2})"]
            beta2 = pars[r"\beta_2"]
            ne2 = ne2 + n02**2 / (1.0 + (r / rc2) ** 2) ** (3.0 * beta2)
        return torch.sqrt(ne2)

    def log_prior(self, pars: dict) -> torch.Tensor:
        """Shape prior r_c <= r_s (reference veto, joxsz_funcs.py:397-407);
        (B,) zeros or -inf."""
        bad = (pars["log(r_c)"] > pars["log(r_s)"])[:, 0]
        zero = torch.zeros(bad.shape, dtype=pars["log(r_c)"].dtype,
                           device=bad.device)
        return torch.where(bad, zero - float("inf"), zero)
