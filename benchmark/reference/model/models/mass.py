"""Hydrostatic-equilibrium mass profile.

Torch counterpart of ``joxsz_tpu/models/mass.py::HSEMass`` (reference
``CmptMyMass``, joxsz_funcs.py:409-437):

    M(<r) = - (dP/dr) r^2 / (mu_gas m_u n_e G)   [solar masses]

and the overdensity mass M_Delta(r) of the critical density (reference
joxsz_plots.py:378-399) that the r_500/M_500 bisection solves against.
"""

from __future__ import annotations

import math

from .. import constants as K


class HSEMass:
    def __init__(self, pressure, density, mu_gas: float = K.mu_gas,
                 name: str = "m"):
        self.name = name
        self.pressure = pressure
        self.density = density
        self.mu_gas = mu_gas
        # all CGS conversions folded into one O(1e10) scalar so float32
        # never sees 1e49 intermediates:
        # M[Msun] = -dP/dr[keV cm^-3 kpc^-1] * r[kpc]^2 / ne * C
        self._C = (K.keV_erg * K.kpc_cm
                   / (mu_gas * K.mu_g * K.G_cgs) / K.solar_mass_g)

    def __call__(self, pars: dict, r_kpc):
        dp_dr_kpc = self.pressure.derivative(pars, r_kpc)
        ne = self.density(pars, r_kpc)
        return -dp_dr_kpc * r_kpc * r_kpc / ne * self._C


def mass_overdensity(r_kpc, cosmo, delta: float = 500.0):
    """M_Delta(r) = (4/3) pi rho_c(z) Delta r^3 in solar masses, for a
    tensor or an array of radii (``joxsz_tpu/models/mass.py``): the
    prefactor folds to one host float (~1e5 Msun per kpc^3), so r^3 in
    cm never appears."""
    C = (4.0 / 3.0 * math.pi * cosmo.critical_density_cgs() * delta
         * K.kpc_cm**3 / K.solar_mass_g)
    return C * r_kpc * r_kpc * r_kpc
