"""Flat (optionally curved) FLRW cosmology distances.

Replaces the reference's use of ``mb.Cosmology`` (constructed at
reference joxsz_main.py:28-31 with z=0.888, H0=67.32, WM=0.3158,
WV=0.6842; consumed via ``.kpc_per_arcsec`` at joxsz_main.py:96 and ``.D_L``
at joxsz_plots.py:244).

The distance integrals follow the standard Ned-Wright-style quadrature
(including the radiation term WR = 4.165e-5/h^2) evaluated once at setup on
the host with numpy; nothing here runs in the fit hot path.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from . import constants as K

_ARCSEC_RAD = np.pi / (180.0 * 3600.0)


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """FLRW cosmology pinned at a single redshift.

    Attributes
    ----------
    z : cluster redshift
    H0 : Hubble constant (km/s/Mpc)
    WM : matter density parameter
    WV : vacuum (dark energy) density parameter
    """

    z: float
    H0: float = 70.0
    WM: float = 0.27
    WV: float = 0.73
    _n_quad: int = 4096

    def _distances_mpc(self) -> tuple[float, float]:
        """Comoving and angular-diameter distances in Mpc (flat or curved)."""
        h = self.H0 / 100.0
        WR = 4.165e-5 / (h * h)       # radiation (incl. ~3 massless neutrinos)
        WK = 1.0 - self.WM - WR - self.WV
        az = 1.0 / (1.0 + self.z)
        n = self._n_quad
        # midpoint rule over scale factor a in [az, 1]
        a = az + (1.0 - az) * (np.arange(n) + 0.5) / n
        adot = np.sqrt(WK + self.WM / a + WR / (a * a) + self.WV * a * a)
        dcmr = (1.0 - az) * np.sum(1.0 / (a * adot)) / n   # in c/H0 units
        # curvature transform of the comoving radial distance
        x = np.sqrt(abs(WK)) * dcmr
        if x > 0.1:
            ratio = (0.5 * (np.exp(x) - np.exp(-x)) if WK > 0 else np.sin(x)) / x
        else:
            y = x * x
            if WK < 0:
                y = -y
            ratio = 1.0 + y / 6.0 + y * y / 120.0
        dcmt = ratio * dcmr
        c_H0 = K.c_km_s / self.H0  # Hubble distance in Mpc
        d_cm_mpc = c_H0 * dcmt
        d_a_mpc = az * d_cm_mpc
        return d_cm_mpc, d_a_mpc

    @property
    def D_A(self) -> float:
        """Angular-diameter distance (Mpc)."""
        return self._distances_mpc()[1]

    @property
    def D_L(self) -> float:
        """Luminosity distance (Mpc)."""
        return self._distances_mpc()[1] * (1.0 + self.z) ** 2

    @property
    def kpc_per_arcsec(self) -> float:
        """Transverse proper kpc subtended by one arcsec."""
        return self.D_A * 1000.0 * _ARCSEC_RAD

    @property
    def H_z_per_s(self) -> float:
        """Hubble rate at z in s^-1 (used for overdensity masses,
        cf. reference joxsz_plots.py:390-392)."""
        H0_s = self.H0 / K.Mpc_km
        return H0_s * np.sqrt(self.WM * (1.0 + self.z) ** 3 + self.WV)

    def critical_density_cgs(self) -> float:
        """Critical density at z (g/cm^3)."""
        hz = self.H_z_per_s
        return 3.0 * hz * hz / (8.0 * np.pi * K.G_cgs)
