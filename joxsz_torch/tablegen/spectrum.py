"""Thermal-plasma spectral model of the count-rate table generator.

The port's copy of ``joxsz_tpu/tablegen/spectrum.py`` as functions on
float64 tensors: free-free continuum with the non-relativistic Born Gaunt
factor, an 18-complex metal-line model, Morrison & McCammon (1983)
photoelectric absorption and the redshifted, absorbed photon flux per
unit XSPEC norm.  Every function broadcasts its arguments, so a whole
(Z, T, E) grid is one batched evaluation on the device the tensors lie
on: pass T as (nT, 1) and Z as (nZ, 1, 1) against energies (nE,).

Units/conventions (the XSPEC 'norm' convention of the X-ray model,
``geometry.annuli.xspec_norm_per_cm3``): photon flux density per unit
norm at observed energy E,

    f(E) = 1e14 * lambda(E*(1+z); T, Z) / (1+z)      [ph/cm^2/s/keV]

with lambda the photon emissivity per (n_e n_H) in ph cm^3 s^-1 keV^-1.
The line complexes' calibration is the JAX package's
(``tests/test_spectrum_anchors.py`` pins it there); the reference gets
these rates from XSPEC's APEC instead.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as K

# Rybicki & Lightman eq. 5.14b prefactor, converted to photons/keV:
#   6.842e-38 [erg s^-1 cm^-3 Hz^-1] * 2.41799e17 [Hz/keV]
#     / 1.60218e-9 [erg/keV] / sqrt(1.16045e7 [K/keV])
_C_FF = 6.842e-38 * 2.41799e17 / 1.60218e-9 / np.sqrt(1.16045e7)
# sum of Z_i^2 n_i / n_H over H + He (He/H = 0.0977, Anders & Grevesse)
_ZSUM_HHE = 1.0 + 4.0 * 0.0977

# Line complexes: (centroid keV, Gaussian width keV, amplitude [ph cm^3
# s^-1 at solar Z before the T response], log10 T_keV of the ion-balance
# peak, left and right log-T widths); the response is an asymmetric
# Gaussian in log10 T times exp(-E0/kT)
_LINES = np.array([
    # E0      sigE    amp       lt0    sltL   sltR
    [0.654, 0.020, 8.206e-16, -0.55, 0.30, 0.40],   # O VIII Ly-a
    [0.729, 0.025, 2.675e-15, -0.28, 0.22, 0.25],   # Fe XVII 2p-3s
    [0.826, 0.030, 3.478e-15, -0.25, 0.22, 0.28],   # Fe XVII/XVIII 2p-3d
    [0.950, 0.045, 4.013e-15, -0.10, 0.25, 0.30],   # Fe XIX/XX + Ne IX
    [1.070, 0.050, 3.210e-15,  0.00, 0.25, 0.32],   # Ne X + Fe XXI
    [1.170, 0.060, 2.140e-15,  0.15, 0.25, 0.35],   # Fe XXII-XXIV L
    [1.472, 0.030, 1.340e-16,  0.08, 0.30, 0.40],   # Mg XII Ly-a
    [1.865, 0.030, 3.927e-16,  0.00, 0.30, 0.30],   # Si XIII He-a
    [2.006, 0.030, 9.786e-17,  0.26, 0.30, 0.40],   # Si XIV Ly-a
    [2.461, 0.035, 1.248e-16,  0.15, 0.30, 0.30],   # S XV He-a
    [2.623, 0.035, 3.156e-17,  0.45, 0.30, 0.40],   # S XVI Ly-a
    [3.140, 0.045, 3.000e-17,  0.30, 0.30, 0.35],   # Ar XVII He-a
    [3.323, 0.045, 1.200e-17,  0.57, 0.30, 0.45],   # Ar XVIII Ly-a
    [3.902, 0.050, 2.200e-17,  0.40, 0.30, 0.35],   # Ca XIX He-a
    [4.107, 0.050, 1.200e-17,  0.67, 0.30, 0.45],   # Ca XX Ly-a
    [6.685, 0.060, 5.164e-16,  0.10, 0.606, 0.361],  # Fe XXV He-a complex
    [6.966, 0.050, 6.952e-17,  0.90, 0.190, 0.342],  # Fe XXVI Ly-a
    [7.850, 0.090, 7.000e-17,  0.60, 0.50, 0.45],   # Fe K-beta + Ni K-a
])

# Morrison & McCammon (1983): sigma * E^3 = c0 + c1 E + c2 E^2 (sigma in
# 1e-24 cm^2, E in keV) on [Emin, Emax)
_MM83 = np.array([
    # Emin   Emax    c0      c1      c2
    [0.030, 0.100, 17.3, 608.1, -2150.0],
    [0.100, 0.284, 34.6, 267.9, -476.1],
    [0.284, 0.400, 78.1, 18.8, 4.3],
    [0.400, 0.532, 71.4, 66.8, -51.4],
    [0.532, 0.707, 95.5, 145.8, -61.1],
    [0.707, 0.867, 308.9, -380.6, 294.0],
    [0.867, 1.303, 120.6, 169.3, -47.7],
    [1.303, 1.840, 141.3, 146.8, -31.5],
    [1.840, 2.471, 202.7, 104.7, -17.0],
    [2.471, 3.210, 342.7, 18.7, 0.0],
    [3.210, 4.038, 352.2, 18.7, 0.0],
    [4.038, 7.111, 433.9, -2.4, 0.75],
    [7.111, 8.331, 629.0, 30.9, 0.0],
    [8.331, 10.000, 701.2, 25.2, 0.0],
])


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    """``a`` as a float64 tensor on ``ref``'s device."""
    return torch.as_tensor(a, dtype=torch.float64, device=ref.device)


def gaunt_ff(E_keV: torch.Tensor, T_keV: torch.Tensor) -> torch.Tensor:
    """Non-relativistic Born free-free Gaunt factor:
    g = (sqrt(3)/pi) e^x K0(x), x = E/(2kT)."""
    x = torch.clamp(E_keV / (2.0 * T_keV), 1e-8, 600.0)
    return (np.sqrt(3.0) / np.pi * torch.exp(x)
            * torch.special.modified_bessel_k0(x))


def ff_photon_emissivity(E_keV: torch.Tensor, T_keV: torch.Tensor,
                         zsum: float = _ZSUM_HHE) -> torch.Tensor:
    """Free-free photon emissivity per (n_e n_H): ph cm^3 s^-1 keV^-1."""
    T = _like(T_keV, E_keV)
    g = gaunt_ff(E_keV, T)
    return _C_FF * zsum * g * torch.exp(
        -torch.clamp(E_keV / T, 0.0, 600.0)) / (E_keV * torch.sqrt(T))


def line_photon_emissivity(E_keV: torch.Tensor, T_keV: torch.Tensor,
                           Z_solar) -> torch.Tensor:
    """Metal-line photon emissivity per (n_e n_H), linear in Z: the
    complexes on a last axis of their own, summed."""
    lines = _like(_LINES, E_keV)
    E0, sE, amp = lines[:, 0], lines[:, 1], lines[:, 2]
    lt0, sltL, sltR = lines[:, 3], lines[:, 4], lines[:, 5]
    T = _like(T_keV, E_keV)[..., None]
    logT = torch.log10(T)
    slt = torch.where(logT < lt0, sltL, sltR)
    t_resp = torch.exp(-0.5 * ((logT - lt0) / slt) ** 2)
    t_resp = t_resp * torch.exp(-torch.clamp(
        E0 / torch.clamp(T, min=1e-3), 0.0, 600.0))
    E = E_keV[..., None]
    prof = torch.exp(-0.5 * ((E - E0) / sE) ** 2) / (sE * np.sqrt(2 * np.pi))
    return Z_solar * (prof * (amp * t_resp)).sum(dim=-1)


def photon_emissivity(E_keV, T_keV, Z_solar) -> torch.Tensor:
    """Total photon emissivity lambda(E; T, Z) per (n_e n_H)."""
    return (ff_photon_emissivity(E_keV, T_keV)
            + line_photon_emissivity(E_keV, T_keV, Z_solar))


def mm83_sigma_1e24cm2(E_keV: torch.Tensor) -> torch.Tensor:
    """Effective photoelectric cross-section per H atom (units 1e-24 cm^2),
    solar abundances; constant extension below 0.03 and above 10 keV."""
    mm = _like(_MM83, E_keV)
    E = torch.clamp(E_keV, 0.030, 10.0)
    idx = torch.clamp(torch.searchsorted(mm[:, 1].contiguous(),
                                         E.contiguous(), right=False),
                      0, mm.shape[0] - 1)
    c0, c1, c2 = mm[idx, 2], mm[idx, 3], mm[idx, 4]
    return (c0 + c1 * E + c2 * E * E) / (E * E * E)


def phabs_transmission(E_keV: torch.Tensor, NH_1022pcm2) -> torch.Tensor:
    """exp(-NH sigma(E)); NH in 10^22 cm^-2."""
    return torch.exp(-(NH_1022pcm2 * mm83_sigma_1e24cm2(E_keV) * 1e-2))


def observed_photon_flux(E_obs_keV: torch.Tensor, T_keV, Z_solar, z: float,
                         NH_1022pcm2: float) -> torch.Tensor:
    """Absorbed, redshifted photon flux density per unit norm
    [ph/cm^2/s/keV] at observed energies."""
    lam = photon_emissivity(E_obs_keV * (1.0 + z), T_keV, Z_solar)
    return (1e14 * lam / (1.0 + z)
            * phabs_transmission(E_obs_keV, NH_1022pcm2))


def bolometric_flux_per_norm(T_keV, Z_solar, z: float, device=None,
                             e_lo: float = 0.01, e_hi: float = 100.0,
                             n: int = 4000) -> torch.Tensor:
    """Unabsorbed bolometric energy flux per unit norm [erg/cm^2/s] (the
    cooling-time profile's), the trapezoid over ``n`` log-spaced energies
    on the last axis; T and Z broadcast as in ``line_photon_emissivity``."""
    E = torch.as_tensor(np.geomspace(e_lo, e_hi, n), dtype=torch.float64,
                        device=device)
    lam = photon_emissivity(E * (1.0 + z), T_keV, Z_solar) / (1.0 + z)
    return torch.trapezoid(1e14 * lam * E * K.keV_erg, E, dim=-1)
