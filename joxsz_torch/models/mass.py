"""Hydrostatic-equilibrium mass profile.

Torch counterpart of ``joxsz_tpu/models/mass.py::HSEMass`` (reference
``CmptMyMass``, joxsz_funcs.py:409-437):

    M(<r) = - (dP/dr) r^2 / (mu_gas m_u n_e G)   [solar masses]
"""

from __future__ import annotations

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
