"""SZ surface-brightness forward model: reference pipeline + fused operator.

The reference's per-evaluation SZ chain (reference joxsz_funcs.py:439-493):

    pressure on r_pp (313)
      -> forward Abel transform                       (PyAbel, 4.7 ms)
      -> Compton y, mirrored cubic spline onto the
         171x171 distance matrix                      (1.3 ms)
      -> linear beam convolution (fftconvolve 'same') (pocketfft)
      -> *circular* transfer-function filtering
         (plain fft2 -> multiply -> ifft2; reference
          quirk documented in SURVEY.md §2.6.3)
      -> central half-row extraction (86 px)
      -> T-dependent Compton->mJy conversion x calibration
      -> cubic interpolation to the 19 data radii -> chi^2

Everything from the pressure values to the extracted raw profile is LINEAR
with fixed geometry, so at setup we compose it into one (86, 313) matrix
``L`` (and a (19, 86) matrix ``G`` for the data-radius resampling).  A
walker batch is then two small matrix products that replace the Abel loop,
both FFTs and three cubic splines.  The non-linear tail (temperature-
dependent conversion) stays pointwise.

``sz_map_pipeline`` keeps the explicit map-space path (numpy/scipy, float64)
both as the golden reference for tests and as the constructor of ``L`` (the
operator columns are the pipeline's response to basis vectors — so the
matrix inherits scipy's exact spline/FFT conventions by construction).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import scipy.fft as sfft
from scipy.signal import fftconvolve

from .abel import forward_abel_matrix
from .splines import mirrored_interp_matrix, interp_matrix
from ..geometry.grids import MapGeometry
from .. import constants as K


def compton_y_prefactor(m_e_keV: float = K.m_e_keV,
                        sigma_T_cm2: float = K.sigma_T_cm2) -> float:
    """y = (sigma_T / m_e c^2) * kpc_cm * AbelIntegral[P_e] with P_e in
    keV cm^-3 and radii in kpc (reference joxsz_funcs.py:459)."""
    return K.kpc_cm * sigma_T_cm2 / m_e_keV


def sz_map_pipeline(
    pp: np.ndarray,
    geom: MapGeometry,
    beam_2d: np.ndarray,
    filt: np.ndarray,
    abel_mat: np.ndarray | None = None,
) -> np.ndarray:
    """Explicit map-space forward model: pressure values -> raw brightness
    profile (86 px, before conversion/calibration).  float64 host path."""
    A = forward_abel_matrix(geom.r_press_kpc) if abel_mat is None else abel_mat
    y = compton_y_prefactor() * (A @ pp)
    S = mirrored_interp_matrix(geom.r_press_kpc, geom.dist_kpc.ravel(),
                               kind="cubic", fill_value=(0.0, 0.0))
    y_2d = (S @ y).reshape(geom.dist_kpc.shape)
    conv_2d = fftconvolve(y_2d, beam_2d, mode="same") * geom.step_arcsec**2
    map_out = np.real(np.fft.ifft2(np.fft.fft2(conv_2d) * filt))
    half = map_out.shape[0] // 2
    return map_out[half, half:]


@dataclasses.dataclass(frozen=True)
class SZOperator:
    """Fused linear pieces of the SZ forward model (host numpy, float64)."""

    L: np.ndarray          # (n_pix, n_press): pressure -> raw profile
    G: np.ndarray          # (n_data, n_pix): raw profile -> data radii
    w_T0: np.ndarray       # (n_pix-1,): T_SZ profile -> T at r=0 (spline)
    w_y0: np.ndarray       # (n_press,): pressure -> y(0) (mirrored spline)
    integ_w: np.ndarray    # (n_press,): pressure -> integrated Y (arcmin^2)
    y_prefactor: float
    n_pix: int
    n_press: int


def build_sz_operator(
    geom: MapGeometry,
    beam_2d: np.ndarray,
    filt: np.ndarray,
    data_radii_arcsec: np.ndarray,
    abel_scheme: str = "pyabel",
) -> SZOperator:
    """Compose the full linear SZ chain into dense operators.

    Implementation: run all n_press basis vectors through the map-space
    pipeline at once (batched spline matmul + batched FFTs), then read the
    operator columns off the outputs.  ~1 s one-time host cost.
    """
    r_pp = geom.r_press_kpc
    n = r_pp.size
    side = geom.side
    sep = geom.sep
    c_y = compton_y_prefactor()

    A = forward_abel_matrix(r_pp, scheme=abel_scheme)  # (n, n)
    S = mirrored_interp_matrix(r_pp, geom.dist_kpc.ravel(),
                               kind="cubic", fill_value=(0.0, 0.0))  # (side^2, n)
    # pressure basis -> y values at all map pixels, all basis columns at once
    Y2D = np.ascontiguousarray(
        np.moveaxis((S @ (c_y * A)).reshape(side, side, n), -1, 0)
    )                                                  # (n, side, side)

    # linear beam convolution ('same' mode) via zero-padded real FFTs,
    # multithreaded; equivalent to scipy.signal.fftconvolve(mode='same')
    mb = beam_2d.shape[0]
    full = side + mb - 1
    Bf = sfft.rfft2(beam_2d, s=(full, full), workers=-1)
    conv_full = sfft.irfft2(
        sfft.rfft2(Y2D, s=(full, full), axes=(1, 2), workers=-1) * Bf[None],
        s=(full, full), axes=(1, 2), workers=-1,
    )
    lo = (mb - 1) // 2
    conv = conv_full[:, lo : lo + side, lo : lo + side] * geom.step_arcsec**2

    # circular transfer-function filtering (reference quirk: unpadded fft2,
    # SURVEY.md §2.6.3); the filter is real but not conjugate-symmetric on
    # the grid, so keep the complex transform
    filtered = np.real(
        sfft.ifft2(sfft.fft2(conv, axes=(1, 2), workers=-1) * filt[None],
                   axes=(1, 2), workers=-1)
    )
    L = filtered[:, sep, sep:].T                        # (n_pix, n)
    n_pix = L.shape[0]

    # data-radius resampling of the brightness profile
    # (reference joxsz_funcs.py:476: cubic, fill_value='extrapolate')
    G = interp_matrix(geom.radius_arcsec[sep:], data_radii_arcsec,
                      kind="cubic", fill_value="extrapolate",
                      assume_sorted=True)

    # T_SZ(0) spline weights: mirrored cubic spline of the temperature
    # profile on r_pp[:sep], evaluated at r=0
    # (reference joxsz_funcs.py:470-473)
    w_T0 = mirrored_interp_matrix(
        r_pp[:sep], np.array([0.0]), kind="cubic",
        fill_value=(0.0, 0.0),  # fill irrelevant: 0 is interior
    )[0]

    # y(0) spline weights (for the integrated-Y option,
    # reference joxsz_funcs.py:481): mirrored spline of y on r_pp at 0
    w_y0_on_y = mirrored_interp_matrix(r_pp, np.array([0.0]), kind="cubic",
                                       fill_value=(0.0, 0.0))[0]
    w_y0 = w_y0_on_y @ (c_y * A)

    # integrated Compton parameter: 2*pi*simpson((y0, y...)*theta, theta)
    # on the arcmin angular grid (reference joxsz_funcs.py:481-483).
    # Constructed with an explicit count (n+1 points matching [y0, y...]):
    # the reference's float-endpoint arange is off-by-one for some
    # kpc/arcsec values, which would break its own simps broadcast.
    theta_arcmin = np.arange(n + 1) * (geom.step_arcsec / 60.0)
    sw = _simpson_weights(theta_arcmin) * theta_arcmin * 2.0 * np.pi
    # value vector is [y(0), y_1..y_n]; fold onto pressure basis
    integ_w = sw[0] * w_y0 + sw[1:] @ (c_y * A)

    return SZOperator(
        L=L, G=G, w_T0=w_T0, w_y0=w_y0, integ_w=integ_w,
        y_prefactor=c_y, n_pix=n_pix, n_press=n,
    )


def _simpson_weights(x: np.ndarray) -> np.ndarray:
    """Weights of scipy's composite Simpson rule on the grid ``x``
    (including its even-interval-count handling), obtained by integrating
    the identity basis."""
    from scipy.integrate import simpson

    m = x.size
    eye = np.eye(m)
    return np.array([simpson(eye[i], x=x) for i in range(m)])
