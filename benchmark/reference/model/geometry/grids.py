"""Map-plane grids and frequency matrices for the SZ forward model.

Host-side (numpy) geometry, computed once at setup.  Reference behaviors
replicated: the symmetric distance matrix (reference joxsz_funcs.py:78-88),
the IDL-DIST-style radial frequency matrix (joxsz_funcs.py:104-116) and the
map radius axis construction (joxsz_main.py:100-105).
"""

from __future__ import annotations

import dataclasses
import numpy as np


def centered_distance_matrix(r: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """Symmetric matrix of radial distances sqrt(x^2+y^2)+offset over a
    signed radius axis centred on zero."""
    return np.hypot(r[None, :], r[:, None]) + offset


def radial_freq_matrix(n: int) -> np.ndarray:
    """IDL ``DIST``-convention radial frequency matrix: element (i,j) is
    proportional to the FFT frequency radius, with the zero bin at [0,0].

    Note the reference's ``-naxis//2+1`` start (joxsz_funcs.py:114) is a
    *floored* negative division, i.e. -(n+1)//2 + 1 for odd n — the axis is
    the integers -((n-1)//2)..n//2 for even n and -(n//2)..(n//2) for odd n.
    """
    axis = np.linspace(-n // 2 + 1, n // 2, n)
    m = np.hypot(axis[None, :], axis[:, None])
    return np.roll(m, n // 2 + 1, axis=(0, 1))


def signed_radius_axis(max_r: float, step: float) -> np.ndarray:
    """[-R..0..R] axis with the given step (R inclusive)."""
    pos = np.arange(0.0, max_r + step, step)
    return np.append(-pos[:0:-1], pos)


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """All fixed SZ map-plane geometry for one cluster dataset."""

    step_arcsec: float
    kpc_per_arcsec: float
    radius_arcsec: np.ndarray     # full signed axis, length 2*sep+1
    sep: int                      # index of radius zero
    r_press_kpc: np.ndarray       # line-of-sight pressure integration radii
    dist_kpc: np.ndarray          # (side, side) distances from map centre

    @property
    def side(self) -> int:
        return self.radius_arcsec.size


def build_map_geometry(
    step_arcsec: float,
    max_data_radius_arcsec: float,
    fwhm_beam_arcsec: float,
    kpc_per_arcsec: float,
    cluster_extent_kpc: float,
) -> MapGeometry:
    """Build the map grid exactly as the reference does
    (reference joxsz_main.py:100-105): the axis extends to the largest
    multiple of `step` below (max data radius + 3*FWHM); pressure radii run
    from one step (in kpc) out to the cluster extent R_b."""
    max_r = (max_data_radius_arcsec + 3.0 * fwhm_beam_arcsec) // step_arcsec * step_arcsec
    radius = signed_radius_axis(max_r, step_arcsec)
    sep = radius.size // 2
    step_kpc = step_arcsec * kpc_per_arcsec
    r_pp = np.arange(step_kpc, cluster_extent_kpc + step_kpc, step_kpc)
    d_mat = centered_distance_matrix(radius * kpc_per_arcsec)
    return MapGeometry(
        step_arcsec=step_arcsec,
        kpc_per_arcsec=kpc_per_arcsec,
        radius_arcsec=radius,
        sep=sep,
        r_press_kpc=r_pp,
        dist_kpc=d_mat,
    )
