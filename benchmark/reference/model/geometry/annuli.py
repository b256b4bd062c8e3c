"""X-ray annulus geometry and the shell->annulus projection volume matrix.

Replacement for the used subset of ``mbproj2.Annuli``
(constructed at reference joxsz_main.py:116; attributes consumed:
``edges_arcmin``, ``edges_logkpc``, ``midpt_kpc``, ``cosmology`` and the
projection volumes inside ``calcProfiles`` — see SURVEY.md §2.3).

The projection matrix is the classical onion-peeling operator: entry (i, j)
is the volume (cm^3) of the spherical shell j that projects into the sky
annulus i, assuming spherical symmetry and integrating the full line of
sight.  With g(r, y) = max(r^2 - y^2, 0)^(3/2), the volume of the ball of
radius r seen outside projected radius y is (4*pi/3) * g(r, y), from which

    V[i, j] = 4*pi/3 * [ g(r_{j+1}, y_i) - g(r_{j+1}, y_{i+1})
                        - g(r_j,    y_i) + g(r_j,    y_{i+1}) ].

At runtime this matrix is a constant; projecting emissivities is one
(n_ann x n_shell) matrix product per band, trivially batched.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from .. import constants as K
from ..cosmology import Cosmology


def projection_volume_matrix(edges_cm: np.ndarray) -> np.ndarray:
    """(n_ann, n_shell) matrix of intersection volumes in cm^3."""
    r = edges_cm  # shared edges for shells and annuli

    def g(rr, yy):
        d = np.maximum(rr * rr - yy * yy, 0.0)
        return d * np.sqrt(d)

    r_lo, r_hi = r[:-1][None, :], r[1:][None, :]   # shells (columns)
    y_lo, y_hi = r[:-1][:, None], r[1:][:, None]   # annuli (rows)
    vol = g(r_hi, y_lo) - g(r_hi, y_hi) - g(r_lo, y_lo) + g(r_lo, y_hi)
    return (4.0 * np.pi / 3.0) * vol


@dataclasses.dataclass(frozen=True)
class Annuli:
    """Annulus geometry for the X-ray data, all radii derived from the
    edges in arcmin and the cluster cosmology."""

    edges_arcmin: np.ndarray
    cosmology: Cosmology

    @property
    def nshells(self) -> int:
        return self.edges_arcmin.size - 1

    @property
    def edges_kpc(self) -> np.ndarray:
        return self.edges_arcmin * 60.0 * self.cosmology.kpc_per_arcsec

    @property
    def edges_cm(self) -> np.ndarray:
        return self.edges_kpc * K.kpc_cm

    @property
    def edges_logkpc(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.log10(self.edges_kpc)

    @property
    def midpt_kpc(self) -> np.ndarray:
        e = self.edges_kpc
        return 0.5 * (e[1:] + e[:-1])

    @property
    def geom_areas_arcmin2(self) -> np.ndarray:
        e = self.edges_arcmin
        return np.pi * (e[1:] ** 2 - e[:-1] ** 2)

    @property
    def vols_cm3(self) -> np.ndarray:
        return projection_volume_matrix(self.edges_cm)

    def xspec_norm_per_cm3(self, ne_nH: float = K.ne_nH) -> float:
        """XSPEC 'norm' contributed by unit emission volume at ne = 1 cm^-3:
        norm = 1e-14 / (4 pi [D_A (1+z)]^2) * ne * nH * V.  The ne^2 factor
        is applied at runtime; this returns the pure geometric prefactor
        1e-14 / (4 pi [D_A(1+z)]^2) / ne_nH."""
        d_cm = self.cosmology.D_A * K.Mpc_cm * (1.0 + self.cosmology.z)
        return 1e-14 / (4.0 * np.pi * d_cm * d_cm) / ne_nH
