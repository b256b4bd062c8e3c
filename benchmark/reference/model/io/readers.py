"""Setup-time readers for the bundled cluster data products.

Covers the reference's data-ingest surface:
  * generic XY(err) reader from FITS bintable / whitespace text
    (reference joxsz_funcs.py:16-28),
  * beam profile truncation at the first NaN or negative sample
    (reference joxsz_funcs.py:30-44),
  * transfer-function reading with optional normal-CDF approximation
    (reference joxsz_funcs.py:90-102),
  * Compton->mJy/beam conversion table (reference joxsz_main.py:108-109),
  * X-ray foreground/background annular count profiles
    (reference joxsz_funcs.py:172-211).

All of this runs once on the host; arrays are plain numpy float64.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from .fitsio import read_fits, find_hdu


def read_xy(filename: str, ncol: int) -> np.ndarray:
    """Read the first `ncol` columns of a FITS bintable row-0 / text table.

    FITS branch: the NIKA products store each column as a fixed-length array
    in a single table row; we return the first `ncol` columns stacked,
    matching the reference's ``fits.open(f)[''].data[0]`` access
    (reference joxsz_funcs.py:22-23).
    """
    ext = filename[filename.rfind(".") + 1 :].lower()
    if ext == "fits":
        hdu = find_hdu(read_fits(filename), extname=None)
        cols = hdu.columns()[:ncol]
        data = [np.atleast_1d(np.asarray(hdu.column(c), dtype=float)).ravel()
                for c in cols]
        return np.vstack(data)
    if ext in ("txt", "dat"):
        return np.loadtxt(filename, unpack=True)[:ncol]
    raise ValueError(f"unrecognised extension for {filename!r} "
                     "(expected fits/dat/txt)")


def read_beam_profile(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """Radial beam profile, truncated at the first NaN or negative value."""
    radius, prof = read_xy(filename, ncol=2)
    nan = np.flatnonzero(np.isnan(prof))
    if nan.size:
        radius, prof = radius[: nan[0]], prof[: nan[0]]
    neg = np.flatnonzero(prof < 0.0)
    if neg.size:
        radius, prof = radius[: neg[0]], prof[: neg[0]]
    return radius, prof


def read_transfer_function(
    filename: str | None,
    approx: bool = False,
    loc: float = 0.0,
    scale: float = 0.02,
    c: float = 0.95,
) -> tuple[np.ndarray, np.ndarray]:
    """Wavenumber (arcsec^-1) and transmission; optional c*Phi((k-loc)/s)
    approximation (reference's `tf_approx` mode).

    A file is required even in approx mode — the wavenumber GRID comes
    from it, only the transmission values are replaced."""
    if filename is None:
        raise ValueError(
            "sz.tf_file is required: the transfer-function wavenumber "
            "grid is read from it even with tf_approx=True (only the "
            "transmission values are synthesised)")
    wn, tf = read_xy(filename, ncol=2)
    if approx:
        from scipy.stats import norm

        tf = c * norm.cdf(wn, loc, scale)
    return wn, tf


def read_conversion_table(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """Temperature (keV) -> Compton-to-mJy/beam factors.

    The bundled table is in Jy/beam; the reference scales by 1e3 to mJy at
    load (reference joxsz_main.py:109); we do the same here so the
    model works in mJy throughout.
    """
    t_kev, jy = np.loadtxt(filename, skiprows=1, unpack=True)
    return t_kev, 1e3 * jy


@dataclasses.dataclass(frozen=True)
class BandData:
    """Counts and instrument bookkeeping for one X-ray energy band."""

    emin_keV: float
    emax_keV: float
    radii_arcmin: np.ndarray      # annulus centres
    halfwidths_arcmin: np.ndarray
    counts: np.ndarray            # observed counts per annulus (may hold NaN)
    areas_arcmin2: np.ndarray     # pixelised annulus areas
    exposures_s: np.ndarray
    backrates: np.ndarray         # background cts/s/arcmin^2 per annulus

    @property
    def geom_areas_arcmin2(self) -> np.ndarray:
        r, hw = self.radii_arcmin, self.halfwidths_arcmin
        return np.pi * ((r + hw) ** 2 - (r - hw) ** 2)

    @property
    def edges_arcmin(self) -> np.ndarray:
        """Annulus edges [r0-hw0, r_i+hw_i...] — same construction as
        :func:`annuli_edges_arcmin` without re-reading the file."""
        r, hw = self.radii_arcmin, self.halfwidths_arcmin
        return np.hstack((r[0] - hw[0], r + hw))

    @property
    def areascales(self) -> np.ndarray:
        return self.areas_arcmin2 / self.geom_areas_arcmin2


def load_band(
    fg_template: str, bg_template: str, band_eV: tuple[int, int]
) -> BandData:
    """Load one band's foreground/background annular profiles.

    File layout (5 whitespace columns): radius, half-width (arcmin), counts,
    area (arcmin^2), exposure (s) for the foreground; the background file
    carries the rate (cts/s/arcmin^2) in its 5th column.
    """
    lo, hi = band_eV
    fg = np.loadtxt(fg_template % (lo, hi))
    bg = np.loadtxt(bg_template % (lo, hi))
    n = fg.shape[0]
    # validate the FULL radial grid, not just the last radius: a bg
    # profile with different interior binning but the same outer edge
    # would otherwise silently assign wrong background rates per
    # annulus, and a short bg file would die in a raw IndexError
    if bg.shape[0] < n:
        raise ValueError(
            f"background profile for band {band_eV} has {bg.shape[0]} "
            f"annuli but the foreground has {n}")
    if np.max(np.abs(bg[:n, 0] - fg[:, 0])) > 1e-3:
        i = int(np.argmax(np.abs(bg[:n, 0] - fg[:, 0])))
        raise ValueError(
            f"fg/bg radial grids disagree for band {band_eV} at "
            f"annulus {i}: {bg[i, 0]} vs {fg[i, 0]}"
        )
    return BandData(
        emin_keV=lo / 1000.0,
        emax_keV=hi / 1000.0,
        radii_arcmin=fg[:, 0],
        halfwidths_arcmin=fg[:, 1],
        counts=fg[:, 2],
        areas_arcmin2=fg[:, 3],
        exposures_s=fg[:, 4],
        backrates=bg[:n, 4],
    )


def annuli_edges_arcmin(fg_template: str, band_eV: tuple[int, int]) -> np.ndarray:
    """Annulus edges from a foreground profile: [r0-hw0, r_i+hw_i...]."""
    lo, hi = band_eV
    fg = np.loadtxt(fg_template % (lo, hi))
    return np.hstack((fg[0, 0] - fg[0, 1], fg[:, 0] + fg[:, 1]))
