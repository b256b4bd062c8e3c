"""Beam model: measured radial profile -> normalised 2D kernel.

Mirrors the behavior of ``mybeam`` (reference joxsz_funcs.py:46-76):
cubic interpolation of the mirrored measured profile, FWHM from a root find
on f(x) - f(0)/2, kernel support |r| <= 3*FWHM, optional Gaussian
approximation, and normalisation so that sum(beam)*step^2 = 1.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize
from scipy.interpolate import interp1d

from .grids import centered_distance_matrix, signed_radius_axis
from ..io.readers import read_beam_profile


def build_beam(
    step_arcsec: float,
    max_data_radius_arcsec: float,
    approx: bool = False,
    filename: str | None = None,
    normalize: bool = True,
    fwhm_arcsec: float | None = None,
) -> tuple[np.ndarray, float]:
    """Return (beam_2d, fwhm_arcsec).

    With ``approx=False`` the kernel comes from the measured radial profile;
    with ``approx=True`` it is a normal pdf with the supplied FWHM.
    """
    if not approx:
        r_meas, b_meas = read_beam_profile(filename)
        # mirrored cubic spline; zero outside the measured support.
        # Profiles measured from r = 0 (legitimate, though the bundled
        # NIKA file starts at r > 0) must not duplicate the origin in
        # the mirror — scipy rejects duplicate abscissae (found by the
        # geometry-generalization sweep, r4)
        pos = r_meas > 0.0
        spline = interp1d(
            np.concatenate([-r_meas[pos][::-1], r_meas]),
            np.concatenate([b_meas[pos][::-1], b_meas]),
            kind="cubic",
            bounds_error=False,
            fill_value=(0.0, 0.0),
        )
        half = lambda x: spline(x) - spline(0.0) / 2.0
        fwhm_arcsec = 2.0 * optimize.newton(half, x0=5.0)
    if fwhm_arcsec is None:
        raise ValueError("fwhm_arcsec required when approx=True")

    max_r = (max_data_radius_arcsec + 3.0 * fwhm_arcsec) // step_arcsec * step_arcsec
    rad = signed_radius_axis(max_r, step_arcsec)
    rad_cut = rad[np.abs(rad) <= 3.0 * fwhm_arcsec]
    dist = centered_distance_matrix(rad_cut)
    if approx:
        from scipy.stats import norm

        sigma = fwhm_arcsec / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        beam_2d = norm.pdf(dist, loc=0.0, scale=sigma)
    else:
        beam_2d = spline(dist)
    if normalize:
        beam_2d = beam_2d / (beam_2d.sum() * step_arcsec**2)
    return beam_2d, float(fwhm_arcsec)
