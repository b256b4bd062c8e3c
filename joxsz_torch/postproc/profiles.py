"""Posterior post-processing: thermodynamic / mass / gas-fraction profiles.

Torch counterpart of ``joxsz_tpu/postproc/profiles.py`` (reference
plot-support machinery, joxsz_plots.py:104-132, 194-273, 316-399,
451-478, which re-runs the forward model once per posterior sample).
Here every profile is one batched evaluation of a (B, D) block of the
chain on the model's device, in batches of 4096 rows; the percentile
bands are taken on the host with numpy (``equal_tailed``:
``torch.quantile`` refuses inputs above 2^24 elements, and 131072 draws
x 313 radii is past that).

Quantities (reference parity): density ne(r), T_SZ, T_X, pressure P(r),
entropy K = T/ne^(2/3), cooling time (through the count-rate table's
bolometric flux), cumulative gas mass (with the inner/outer half-shell
split), hydrostatic mass M(<r), overdensity radius/mass r_Delta/M_Delta
(a batched bisection, one radius per draw), gas fraction M_gas/M_HSE.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import constants as K
from ..models.mass import mass_overdensity
from ..models.sz import lerp_lookup


def equal_tailed(data: np.ndarray, ci: float = 95.0) -> np.ndarray:
    """(3, ...) array of [lower, median, upper] over axis 0 — the
    reference's get_equal_tailed (joxsz_plots.py:93-102)."""
    lo, med, up = np.percentile(
        np.asarray(data), [50 - ci / 2, 50.0, 50 + ci / 2], axis=0)
    return np.array([np.atleast_1d(lo), np.atleast_1d(med),
                     np.atleast_1d(up)])


# gas-mass conversion: M[Msun] = ne[cm^-3] * V[kpc^3] * C_GAS
_C_GAS = K.kpc_cm**3 * K.mu_e * K.mu_g / K.solar_mass_g


def _gas_shell_edges_kpc(r_kpc: torch.Tensor) -> torch.Tensor:
    """Shell edges r_0/2, r_i + r_0/2 (reference cum_gas_mass,
    joxsz_plots.py:215)."""
    return torch.cat([r_kpc[:1] / 2.0, r_kpc + r_kpc[0] / 2.0])


def _frac_inner(edges: torch.Tensor) -> torch.Tensor:
    """Fraction of a shell's mass inside its midpoint radius (reference
    frac_int, joxsz_plots.py:194-206)."""
    lo, hi = edges[:-1], edges[1:]
    v_in = (lo + hi) ** 3 / 24.0 - lo**3 / 3.0
    v_out = hi**3 / 3.0 - (lo + hi) ** 3 / 24.0
    return v_in / (v_in + v_out)


def cumulative_gas_mass(ne: torch.Tensor, r_kpc: torch.Tensor) -> torch.Tensor:
    """Cumulative gas mass (Msun) at each radius from density profiles
    ne (..., n_r) on the radii ``r_kpc`` (n_r,)."""
    e = _gas_shell_edges_kpc(r_kpc)
    shell_m = ne * (e[1:] ** 3 - e[:-1] ** 3) * (4.0 / 3.0 * math.pi * _C_GAS)
    csum = torch.cat([torch.zeros_like(shell_m[..., :1]),
                      torch.cumsum(shell_m, dim=-1)[..., :-1]], dim=-1)
    return shell_m * _frac_inner(e) + csum


@dataclasses.dataclass
class ProfileSet:
    """Equal-tailed (3, n_r) bands of each thermodynamic quantity."""

    r_kpc: np.ndarray
    density: np.ndarray
    temp_sz: np.ndarray
    temp_x: np.ndarray
    pressure: np.ndarray
    entropy: np.ndarray
    cooling_time: np.ndarray
    gas_mass: np.ndarray
    # f_gas = M_gas/M_HSE, from the same batched pass as the thermo
    # profiles (compute_gas_fraction remains the standalone API)
    gas_fraction: np.ndarray | None = None


def _radii(model, r_kpc) -> torch.Tensor:
    L = model.sz_data.L
    return torch.as_tensor(np.asarray(r_kpc, dtype=np.float64),
                           dtype=L.dtype, device=L.device)


def _rows(model, block: np.ndarray) -> torch.Tensor:
    L = model.sz_data.L
    return torch.as_tensor(np.asarray(block, dtype=np.float64),
                           dtype=L.dtype, device=L.device)


def make_profile_fns(model, cosmo, r_kpc, Z_name: str = "Z"):
    """Batched profile functions of a ``JointModel`` on its device:
    ``thermo(theta (B, D))`` -> (ne, T_SZ, T_X, P, K, t_cool, M_gas,
    f_gas), each (B, n_r), and ``hse_mass(theta)`` -> (B, n_r)."""
    r = _radii(model, r_kpc)
    zf2 = (1.0 + cosmo.z) ** 2
    # luminosity per cm^3 = bolo_rate(T,Z) * ne^2 * 1e-14 (1+z)^2 / ne_nH
    # (D_L = D_A (1+z)^2 cancels the distances of the XSPEC-norm
    # prefactor — float32-safe)
    lum_scale = 1e-14 * zf2 / K.ne_nH
    table = model.xray_data.table if model.xray_data is not None else None
    if table is not None and table.logflux_Z0 is None:
        raise ValueError("the count-rate table carries no bolometric flux "
                         "(logflux_Z0/Z1): the cooling time needs it")

    def thermo(theta: torch.Tensor):
        pars = model.params.unpack(theta)
        ne = model.density(pars, r)
        press = model.pressure(pars, r)
        # T_SZ/T_X through the temperature component, so the parametric
        # Vikhlinin T post-processes too
        t_sz = model.temperature.t_sz(pars, r)
        t_x = model.temperature.t_x(pars, r)
        entropy = t_sz / ne ** (2.0 / 3.0)
        mgas = cumulative_gas_mass(ne, r)
        if table is not None:
            # line_scale scales the metal-line part of the flux table too
            # (models/xray.py::predicted_counts)
            Z = pars[Z_name] * pars.get("line_scale", 1.0) \
                * torch.ones_like(t_sz)
            tl = torch.log(t_sz)
            f0 = torch.exp(lerp_lookup(table.Tlog, table.logflux_Z0, tl))
            f1 = torch.exp(lerp_lookup(table.Tlog, table.logflux_Z1, tl))
            lum = (f0 * (1 - Z) + f1 * Z) * ne * ne * lum_scale
            # t_cool = (5/2) ne (1 + 1/ne_nH) T keV_erg / lum / yr_s
            tcool = (2.5 * ne * (1.0 + 1.0 / K.ne_nH) * t_sz
                     * (K.keV_erg / K.yr_s) / lum)
        else:
            tcool = torch.full_like(t_sz, float("nan"))
        fgas = mgas / model.mass(pars, r)
        return ne, t_sz, t_x, press, entropy, tcool, mgas, fgas

    def hse_mass(theta: torch.Tensor):
        return model.mass(model.params.unpack(theta), r)

    return thermo, hse_mass


# cap on posterior samples used for profile BANDS: beyond ~1e5 samples
# the percentile bands are converged far below line width while the
# device-to-host transfer keeps growing (the reference uses its full 30k
# samples, joxsz_plots.py:117).  A deterministic stride keeps walker/time
# coverage uniform.
_MAX_BAND_SAMPLES = 131072


def _band_subsample(flat_chain: np.ndarray,
                    max_samples: int | None) -> np.ndarray:
    if max_samples and len(flat_chain) > max_samples:
        stride = -(-len(flat_chain) // max_samples)
        return flat_chain[::stride]
    return flat_chain


def _batched(fn, model, flat_chain: np.ndarray, batch: int) -> list:
    """``fn`` over the chain in ``batch``-row blocks on the model's
    device; each output concatenated over blocks as float64 numpy."""
    outs = None
    with torch.no_grad():
        for i in range(0, len(flat_chain), batch):
            res = fn(_rows(model, flat_chain[i:i + batch]))
            res = res if isinstance(res, tuple) else (res,)
            if outs is None:
                outs = [[] for _ in res]
            for o, a in zip(outs, res):
                o.append(a.detach().cpu().numpy().astype(np.float64))
    return [np.concatenate(o) for o in outs]


def compute_profiles(model, cosmo, r_kpc, flat_chain: np.ndarray,
                     ci: float = 95.0, batch: int = 4096,
                     max_samples: int | None = _MAX_BAND_SAMPLES
                     ) -> ProfileSet:
    """Equal-tailed bands of all thermodynamic profiles over the chain."""
    flat_chain = _band_subsample(flat_chain, max_samples)
    thermo_fn, _ = make_profile_fns(model, cosmo, r_kpc)
    bands = [equal_tailed(c, ci)
             for c in _batched(thermo_fn, model, flat_chain, batch)]
    return ProfileSet(
        r_kpc=np.asarray(r_kpc),
        density=bands[0], temp_sz=bands[1], temp_x=bands[2],
        pressure=bands[3], entropy=bands[4], cooling_time=bands[5],
        gas_mass=bands[6], gas_fraction=bands[7],
    )


def overdensity_radius(model, cosmo, theta: torch.Tensor, lo: float,
                       hi: float, delta: float = 500.0, n_bisect: int = 60):
    """(r_Delta, M_Delta), each (B,), of a (B, D) batch: ``n_bisect``
    halvings of [lo, hi] on M(r) - M_Delta(r), every draw at a radius of
    its own (a (B, 1) column through the profile components)."""
    pars = model.params.unpack(theta)
    B = theta.shape[0]
    a = torch.full((B, 1), lo, dtype=theta.dtype, device=theta.device)
    b = torch.full((B, 1), hi, dtype=theta.dtype, device=theta.device)
    for _ in range(n_bisect):
        mid = 0.5 * (a + b)
        fm = model.mass(pars, mid) - mass_overdensity(mid, cosmo, delta)
        # M - M_delta is positive inside r_delta (M grows slower than r^3
        # asymptotically): move the bracket accordingly
        inside = fm > 0
        a = torch.where(inside, mid, a)
        b = torch.where(inside, b, mid)
    rd = 0.5 * (a + b)
    return rd[:, 0], model.mass(pars, rd)[:, 0]


def compute_mass_profiles(model, cosmo, r_kpc, flat_chain: np.ndarray,
                          delta: float = 500.0, ci: float = 95.0,
                          batch: int = 4096, n_bisect: int = 60,
                          max_samples: int | None = _MAX_BAND_SAMPLES):
    """HSE mass bands + overdensity radius/mass bands (a batched bisection
    on M(r) - M_Delta(r) = 0, the reference's per-sample
    scipy.optimize.newton at joxsz_plots.py:335)."""
    flat_chain = _band_subsample(flat_chain, max_samples)
    _, mass_fn = make_profile_fns(model, cosmo, r_kpc)
    lo0, hi0 = float(r_kpc[0]), float(r_kpc[-1])

    def both(theta):
        rd, md = overdensity_radius(model, cosmo, theta, lo0, hi0, delta,
                                    n_bisect)
        return mass_fn(theta), rd, md

    masses, rds, mds = _batched(both, model, flat_chain, batch)
    return (equal_tailed(masses, ci), equal_tailed(rds, ci),
            equal_tailed(mds, ci))


def compute_gas_fraction(model, cosmo, r_kpc, flat_chain: np.ndarray,
                         ci: float = 95.0, batch: int = 4096,
                         max_samples: int | None = _MAX_BAND_SAMPLES
                         ) -> np.ndarray:
    """f_gas = M_gas / M_HSE bands (reference frac_gas_prof)."""
    flat_chain = _band_subsample(flat_chain, max_samples)
    r = _radii(model, r_kpc)

    def fgas(theta):
        pars = model.params.unpack(theta)
        return (cumulative_gas_mass(model.density(pars, r), r)
                / model.mass(pars, r))

    return equal_tailed(_batched(fgas, model, flat_chain, batch)[0], ci)


def posterior_predictive(model, flat_chain: np.ndarray, ci: float = 95.0,
                         batch: int = 4096,
                         max_samples: int | None = _MAX_BAND_SAMPLES):
    """Bands of the X-ray predicted count profiles and the SZ brightness
    profile over the chain (reference best_fit_prof); either None where
    the model has no such data."""
    flat_chain = _band_subsample(flat_chain, max_samples)

    def both(theta):
        out = ()
        if model.sz_data is not None:
            out += (model.sz_profile(theta),)
        if model.xray_data is not None:
            out += (model.xray_profiles(theta),)
        return out

    outs = _batched(both, model, flat_chain, batch)
    perc_sz = (equal_tailed(outs.pop(0), ci)
               if model.sz_data is not None else None)
    perc_x = (equal_tailed(outs.pop(0), ci)
              if model.xray_data is not None else None)
    return perc_x, perc_sz
