"""SZ forward model + likelihood (batched torch).

Torch counterpart of ``joxsz_tpu/models/sz.py`` (reference
``get_sz_like``, joxsz_funcs.py:439-493).  The linear chain (Abel ->
spline-to-map -> beam -> transfer function -> central profile) is the
precomposed ``ops.szkernel.SZOperator``; per walker batch:

    raw   = P(r_pp) @ L^T                         (B, n_pix)
    T_SZ  = P/ne on r_pp[:sep];  T(0) = T_SZ @ w_T0
    conv  = lerp(conversion table, [T(0), T_SZ])
    prof  = raw * conv * calibration
    model = prof @ G^T                            (B, n_data)
    ll    = -chi^2/2  (+ optional integrated-Y Gaussian term)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.splines import lerp_lookup
from ..ops.szkernel import SZOperator
from ..precision import mm


@dataclasses.dataclass(frozen=True)
class SZData:
    """Device-resident constants for the SZ likelihood of one cluster."""

    L: torch.Tensor            # (n_pix, n_press)
    G: torch.Tensor            # (n_data, n_pix)
    w_T0: torch.Tensor         # (sep,)
    integ_w: torch.Tensor      # (n_press,)
    conv_T: torch.Tensor       # conversion table: temperatures (keV)
    conv_val: torch.Tensor     # conversion table: mJy/beam per unit y
    flux_r: torch.Tensor       # data radii (arcsec)
    flux: torch.Tensor         # (n_data,) flux densities (mJy/beam)
    flux_err: torch.Tensor     # (n_data,)
    r_press_kpc: torch.Tensor  # (n_press,)
    sep: int
    calc_integ: bool = False
    integ_mu: float = 0.0
    integ_sig: float = 1.0

    @classmethod
    def build(cls, op: SZOperator, conv_table, flux_data, r_press_kpc,
              sep: int, *, dtype, device, calc_integ: bool = False,
              integ_mu: float = 0.0, integ_sig: float = 1.0) -> "SZData":
        t_tab, v_tab = conv_table

        def asx(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   dtype=dtype, device=device)

        return cls(
            L=asx(op.L), G=asx(op.G), w_T0=asx(op.w_T0),
            integ_w=asx(op.integ_w), conv_T=asx(t_tab), conv_val=asx(v_tab),
            flux_r=asx(flux_data[0]), flux=asx(flux_data[1]),
            flux_err=asx(flux_data[2]), r_press_kpc=asx(r_press_kpc),
            sep=int(sep), calc_integ=bool(calc_integ),
            integ_mu=float(integ_mu), integ_sig=float(integ_sig),
        )


def sz_brightness(pars: dict, sz: SZData, pressure, temperature):
    """Model surface-brightness profiles (B, n_pix) in mJy/beam on the map
    radius axis (the reference's ``output='bright'``)."""
    pp = pressure(pars, sz.r_press_kpc)
    raw = mm(pp, sz.L.T)
    t_prof = temperature.t_sz(pars, sz.r_press_kpc[: sz.sep])
    t0 = mm(t_prof, sz.w_T0)
    t_all = torch.cat([t0[:, None], t_prof], dim=1)
    conv = lerp_lookup(sz.conv_T, sz.conv_val, t_all)
    return raw * conv * pars["calibration"]


def sz_log_like(pars: dict, sz: SZData, pressure, temperature):
    """(B,) -chi^2/2 against the flux profile (+ integrated-Y term)."""
    prof = sz_brightness(pars, sz, pressure, temperature)
    model = mm(prof, sz.G.T)
    resid = (sz.flux - model) / sz.flux_err
    ll = -0.5 * torch.nansum(resid * resid, dim=1)
    if sz.calc_integ:
        cint = mm(pressure(pars, sz.r_press_kpc), sz.integ_w)
        ll = ll - 0.5 * ((cint - sz.integ_mu) / sz.integ_sig) ** 2
    return ll


def sz_integrated_y(pars: dict, sz: SZData, pressure) -> torch.Tensor:
    """(B,) integrated Compton parameter (arcmin^2), the reference's
    'integ' output."""
    return pressure(pars, sz.r_press_kpc) @ sz.integ_w


def sz_outputs(pars: dict, sz: SZData, pressure, temperature,
               output: str = "ll") -> torch.Tensor:
    """Named-output selector mirroring the reference's
    ``get_sz_like(output=...)`` API (joxsz_funcs.py:439-493):
    'll' | 'chisq' | 'pp' | 'bright' | 'integ', each batched over the
    rows of ``pars``."""
    if output == "pp":
        return pressure(pars, sz.r_press_kpc)
    if output == "bright":
        return sz_brightness(pars, sz, pressure, temperature)
    if output == "integ":
        return sz_integrated_y(pars, sz, pressure)
    if output == "ll":
        return sz_log_like(pars, sz, pressure, temperature)
    if output == "chisq":
        # flux chi^2 only, excluding any integrated-Y prior term (the
        # reference computes chisq before that addition)
        prof = sz_brightness(pars, sz, pressure, temperature)
        resid = (sz.flux - prof @ sz.G.T) / sz.flux_err
        return torch.nansum(resid * resid, dim=1)
    raise ValueError(
        "output must be one of 'll', 'chisq', 'pp', 'bright', 'integ'")
