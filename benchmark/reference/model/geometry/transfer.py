"""Transfer-function filter image.

Replicates ``filt_image`` (reference joxsz_funcs.py:118-134): the
measured transmission curve is cubic-interpolated onto the map's radial
frequency grid, with the wavenumber axis normalised so the *corner* frequency
equals 1/step (the reference's convention — note this is NOT the standard
Nyquist convention; parity requires keeping it), and constant fill beyond the
measured range.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d

from .grids import radial_freq_matrix


def build_filter_image(
    wavenumber_arcsec: np.ndarray,
    transmission: np.ndarray,
    side: int,
    step_arcsec: float,
) -> np.ndarray:
    """(side, side) transmission image in FFT layout (zero bin at [0,0])."""
    spline = interp1d(
        wavenumber_arcsec,
        transmission,
        kind="cubic",
        bounds_error=False,
        fill_value=(transmission[0], transmission[-1]),
    )
    k = radial_freq_matrix(side) / side
    k = k / k.max() * (1.0 / step_arcsec)
    return spline(k)
