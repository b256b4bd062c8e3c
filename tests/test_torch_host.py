"""The port's host code: readers, FITS parser, geometry and operators.

``tests/test_io_geometry.py``, ``tests/test_fitsio_hardening.py`` and
``tests/test_ops.py`` rewritten on ``joxsz_torch``'s own copies
(``cosmology``, ``io.readers``, ``io.fitsio``, ``geometry``,
``ops.{abel,splines,szkernel}``), parametrised where they repeat each
other.  Tests that read the CL J1226 data products skip where they are not
mounted (the ``ref_data`` fixture); the rest run on synthetic inputs.

Expected shapes/values of the bundled data (SURVEY.md §2.5): beam valid
out to 62.36", FWHM ~= 18.56", map grid 171x171 @2" (sep=85), beam kernel
55x55, pressure grid 313 pts, kpc/arcsec ~= 8.001, 16 annulus edges
spanning 0-7.667'.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d

from joxsz_torch.cosmology import Cosmology
from joxsz_torch.geometry import (Annuli, build_beam, build_filter_image,
                                  build_map_geometry,
                                  centered_distance_matrix,
                                  radial_freq_matrix)
from joxsz_torch.io.fitsio import (BLOCK, UnsupportedFITSError, find_hdu,
                                   read_fits)
from joxsz_torch.io.readers import (annuli_edges_arcmin, load_band,
                                    read_beam_profile, read_conversion_table,
                                    read_transfer_function, read_xy)
from joxsz_torch.ops.abel import forward_abel, forward_abel_matrix
from joxsz_torch.ops.splines import (interp_matrix, lerp_lookup,
                                     mirrored_interp_matrix)

FLUX = "SZ/press_data_cl1226_flagsource_Xraycent.dat"
BEAM = "SZ/Beam150GHz.fits"
TF = "SZ/TransferFunction150GHz_CLJ1227.fits"
FG = "X/fg_profnew_%04i_%04i.dat"
BG = "X/bg_profnew_%04i_%04i.dat"


@pytest.fixture(scope="module")
def cosmo():
    return Cosmology(z=0.888, H0=67.32, WM=0.3158, WV=0.6842)


def gnfw_like(r, slope=(4.13 - 0.014) / 1.33):
    x = r / 300.0
    return 0.4 / (x ** 0.014 * (1 + x ** 1.33) ** slope)


# --- cosmology, readers, geometry -----------------------------------------


def test_cosmology_scale(cosmo):
    assert abs(cosmo.kpc_per_arcsec - 8.001) < 0.01
    assert np.isclose(cosmo.D_L, cosmo.D_A * 1.888 ** 2)


def test_read_flux_data(ref_data):
    flux = read_xy(str(ref_data / FLUX), 3)
    assert flux.shape == (3, 19)
    assert np.isclose(flux[0][0], 3.136)
    assert np.isclose(flux[0][-1], 116.1, atol=0.05)
    assert np.all(flux[1][:5] < 0)  # SZ decrement in the inner region


def test_read_beam_fits(ref_data):
    r, b = read_beam_profile(str(ref_data / BEAM))
    assert r.size == b.size
    assert r[0] > 2.0 and r[-1] < 63.0
    assert np.all(np.isfinite(b)) and np.all(b >= 0)


def test_build_beam(ref_data):
    beam_2d, fwhm = build_beam(2.0, 116.1, filename=str(ref_data / BEAM))
    assert abs(fwhm - 18.56) < 0.05
    assert beam_2d.shape == (55, 55)
    assert np.isclose(beam_2d.sum() * 4.0, 1.0)


def test_transfer_function(ref_data):
    wn, tf = read_transfer_function(str(ref_data / TF))
    assert wn.size == 76
    assert wn[0] == 0.0 and wn[-1] < 0.5
    filt = build_filter_image(wn, tf, 171, 2.0)
    assert filt.shape == (171, 171)
    assert np.isclose(filt[0, 0], tf[0])
    assert np.all(np.isfinite(filt))


def test_conversion_table(ref_data):
    t, conv = read_conversion_table(
        str(ref_data / "SZ/Compton_to_Jy_per_beam.dat"))
    assert t.size == 6
    assert np.all(conv < 0)  # decrement at 150 GHz
    assert np.isclose(conv[0], -11.63e3)


def test_map_geometry(ref_data, cosmo):
    _, fwhm = build_beam(2.0, 116.1, filename=str(ref_data / BEAM))
    geom = build_map_geometry(2.0, 116.1, fwhm, cosmo.kpc_per_arcsec,
                              5000.0)
    assert geom.side == 171 and geom.sep == 85
    assert geom.r_press_kpc.size == 313
    assert geom.dist_kpc.shape == (171, 171)
    assert np.isclose(geom.r_press_kpc[0], 2.0 * cosmo.kpc_per_arcsec)
    # arange(step, R_b + step, step): the last point may exceed R_b by
    # less than one step (reference joxsz_main.py:104)
    step_kpc = 2.0 * cosmo.kpc_per_arcsec
    assert 5000.0 <= geom.r_press_kpc[-1] < 5000.0 + step_kpc


def test_distance_matrix_props():
    d = centered_distance_matrix(np.array([-4.0, -2.0, 0.0, 2.0, 4.0]))
    assert d[2, 2] == 0.0
    assert np.allclose(d, d.T)
    assert np.isclose(d[0, 0], np.hypot(4, 4))


def test_radial_freq_matrix():
    m = radial_freq_matrix(8)
    assert m[0, 0] == 0.0           # DC bin at origin after roll
    assert np.isclose(m.max(), np.hypot(4, 4))
    assert np.isclose(m[1, 0], m[-1, 0])


def test_bands_and_annuli(ref_data, cosmo):
    band = load_band(str(ref_data / FG), str(ref_data / BG), (700, 1000))
    assert band.counts.size == 15
    assert band.emin_keV == 0.7 and band.emax_keV == 1.0
    assert np.all((band.areascales > 0.3) & (band.areascales < 1.5))

    edges = annuli_edges_arcmin(str(ref_data / FG), (700, 1000))
    assert edges.size == 16 and edges[0] == 0.0
    assert abs(edges[-1] - 7.667) < 0.01
    ann = Annuli(edges_arcmin=edges, cosmology=cosmo)
    assert abs(ann.edges_kpc[-1] - 3681) < 10
    assert ann.nshells == 15 and ann.midpt_kpc.size == 15
    _check_projection(ann)


def test_annuli_projection_synthetic(cosmo):
    """The same projection properties on synthetic edges widening
    outwards (what ``joxsz_torch.synth`` writes)."""
    edges = 4.0 * (np.arange(9) / 8) ** 1.4
    ann = Annuli(edges_arcmin=edges, cosmology=cosmo)
    assert ann.nshells == 8 and ann.midpt_kpc.size == 8
    _check_projection(ann)


def _check_projection(ann):
    """Upper-triangular projection (inner shells cannot appear in outer
    annuli) whose columns sum to each shell's volume."""
    V = ann.vols_cm3
    n = ann.nshells
    assert V.shape == (n, n)
    assert np.allclose(np.tril(V, -1), 0.0)
    e = ann.edges_cm
    shell_vols = 4.0 / 3.0 * np.pi * (e[1:] ** 3 - e[:-1] ** 3)
    assert np.allclose(V.sum(axis=0), shell_vols, rtol=1e-10)


def test_read_transfer_function_requires_file():
    with pytest.raises(ValueError, match="tf_file"):
        read_transfer_function(None, approx=True)


def test_load_band_validates_full_bg_grid(tmp_path):
    """A bg file with other interior binning, or fewer annuli, raises
    naming the fault; an aligned one loads with the file helper's edges."""
    fg = np.column_stack([np.arange(1, 6, dtype=float), np.full(5, 0.5),
                          np.arange(5, dtype=float), np.ones(5),
                          np.ones(5)])
    np.savetxt(tmp_path / "fg_700_1000.txt", fg)
    fg_t, bg_t = str(tmp_path / "fg_%d_%d.txt"), str(tmp_path / "bg_%d_%d.txt")

    bad = fg.copy()
    bad[2, 0] += 0.5                 # interior radius misaligned
    for rows, msg in ((bad, "annulus 2"), (fg[:3], "3 annuli")):
        np.savetxt(tmp_path / "bg_700_1000.txt", rows)
        with pytest.raises(ValueError, match=msg):
            load_band(fg_t, bg_t, (700, 1000))

    np.savetxt(tmp_path / "bg_700_1000.txt", fg)
    band = load_band(fg_t, bg_t, (700, 1000))
    np.testing.assert_allclose(band.edges_arcmin,
                               annuli_edges_arcmin(fg_t, (700, 1000)))


# --- the FITS parser ---------------------------------------------------------


def _card(key, value=None, string=False):
    if value is None:
        return key.ljust(80)
    v = f"'{value}'" if string else (
        "T" if value is True else "F" if value is False else str(value))
    return f"{key.ljust(8)}= {v}".ljust(80)


def _header(cards):
    text = "".join(cards) + "END".ljust(80)
    return (text + " " * ((-len(text)) % BLOCK)).encode("ascii")


def write_fits(path, extra_table_cards=(), extra_primary_cards=(),
               tform2="1J", naxis1=None):
    """Minimal 2-column BINTABLE (3E array col + scalar col) with
    injectable header cards."""
    nrows = 2
    col1 = np.arange(6, dtype=">f4").reshape(nrows, 3)
    col2 = np.array([7, 9], dtype=">i4")
    rowlen = naxis1 if naxis1 is not None else 12 + col2.itemsize
    primary = _header([_card("SIMPLE", True), _card("BITPIX", 8),
                       _card("NAXIS", 0), *extra_primary_cards])
    table_hdr = _header([
        _card("XTENSION", "BINTABLE", string=True), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", rowlen), _card("NAXIS2", nrows),
        _card("PCOUNT", 0), _card("GCOUNT", 1), _card("TFIELDS", 2),
        _card("TTYPE1", "ARR", string=True),
        _card("TFORM1", "3E", string=True),
        _card("TTYPE2", "VAL", string=True),
        _card("TFORM2", tform2, string=True),
        _card("EXTNAME", "TAB", string=True),
        *extra_table_cards,
    ])
    rows = b"".join(col1[i].tobytes() + col2[i:i + 1].tobytes()
                    for i in range(nrows))
    rows += b"\0" * ((-len(rows)) % BLOCK)
    path.write_bytes(primary + table_hdr + rows)
    return path


@pytest.mark.parametrize("cards", [
    [], [_card("TSCAL2", 1.0), _card("TZERO2", 0)]],
    ids=["baseline", "trivial-scaling"])
def test_synthetic_table_reads(tmp_path, cards):
    """The builder's file reads exactly (guarding every rejection test
    below against a broken file); TSCAL=1 / TZERO=0 are the identity and
    must still read."""
    tab = find_hdu(read_fits(str(write_fits(tmp_path / "ok.fits",
                                            extra_table_cards=cards))),
                   "TAB")
    np.testing.assert_array_equal(tab.column("ARR"),
                                  np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(tab.column("VAL"), [7, 9])


@pytest.mark.parametrize("cards,msg", [
    ([_card("TSCAL2", 2.0)], "TSCAL2"),
    ([_card("TZERO2", 32768)], "TZERO2"),        # unsigned-int convention
    ([_card("TNULL2", -999)], "TNULL2"),
    ([_card("ZIMAGE", True)], "compressed"),
    ([_card("ZTABLE", True)], "compressed"),
])
def test_unscaled_only_columns(tmp_path, cards, msg):
    hdus = read_fits(str(write_fits(tmp_path / "f.fits",
                                    extra_table_cards=cards)))
    with pytest.raises(UnsupportedFITSError, match=msg):
        find_hdu(hdus, "TAB").column("VAL")


@pytest.mark.parametrize("tform", ["1X", "1C", "1M", "1QE(5)", "??"])
def test_unimplemented_column_types(tmp_path, tform):
    hdus = read_fits(str(write_fits(tmp_path / "f.fits", tform2=tform)))
    with pytest.raises(UnsupportedFITSError,
                       match="TFORM|not implemented"):
        find_hdu(hdus, "TAB").column("ARR")


def test_row_width_mismatch(tmp_path):
    hdus = read_fits(str(write_fits(tmp_path / "f.fits", naxis1=99)))
    with pytest.raises(UnsupportedFITSError, match="NAXIS1"):
        find_hdu(hdus, "TAB").column("ARR")


def test_random_groups_rejected(tmp_path):
    p = write_fits(tmp_path / "f.fits",
                   extra_primary_cards=[_card("GROUPS", True),
                                        _card("PCOUNT", 1),
                                        _card("GCOUNT", 3)])
    with pytest.raises(UnsupportedFITSError, match="random-groups"):
        read_fits(str(p))


def test_bundled_files_still_parse(ref_data):
    r, b = read_beam_profile(str(ref_data / BEAM))
    assert r.size > 10 and np.all(np.isfinite(b))


# --- Abel ------------------------------------------------------------------


@pytest.mark.parametrize("scheme,rtol_inner,rtol_3sigma", [
    # exact-linear: the piecewise-linear integrand's O(h^2 w'') error
    ("exact-linear", 1.5e-3, 1e-2),
    # pyabel: the near-singularity trapezoid bias the reference pays
    ("pyabel", 3e-2, 3e-2),
])
def test_abel_gaussian_analytic(scheme, rtol_inner, rtol_3sigma):
    """F(y) = sigma sqrt(pi) exp(-y^2/sigma^2) for f = exp(-r^2/sigma^2)."""
    sigma = 300.0
    r = np.arange(16.0, 5000.0, 16.0)
    f = np.exp(-(r / sigma) ** 2)
    expected = sigma * np.sqrt(np.pi) * f
    F = forward_abel(f, r, scheme=scheme)
    inner, sel = r < sigma, r < 3 * sigma
    assert np.allclose(F[inner], expected[inner], rtol=rtol_inner)
    assert np.allclose(F[sel], expected[sel], rtol=rtol_3sigma)
    if scheme == "pyabel":
        rel = (F[sel] - expected[sel]) / expected[sel]
        assert np.all(rel > 0) and rel[0] < 2e-3


@pytest.mark.parametrize("scheme,gain", [("exact-linear", 2.5),
                                         ("pyabel", 1.0)])
def test_abel_convergence(scheme, gain):
    """Halving the step shrinks the exact-linear error ~4x (O(h^2)); the
    pyabel scheme improves more slowly but monotonically."""
    sigma = 300.0

    def err(step):
        r = np.arange(step, 3000.0, step)
        exact = sigma * np.sqrt(np.pi) * np.exp(-(r / sigma) ** 2)
        F = forward_abel(np.exp(-(r / sigma) ** 2), r, scheme=scheme)
        sel = r < 2.0 * sigma
        return np.max(np.abs(F[sel] - exact[sel]) / exact[sel])

    assert err(8.0) < err(16.0) / gain


def test_abel_pyabel_transcription_parity():
    """The 'pyabel' matrix against the vendored numpy transcription of
    PyAbel's direct forward path at <= 1e-12 relative, on the 313-point
    reference-style grid and on a non-uniform one."""
    from pyabel_direct_transcription import pyabel_direct_forward

    for r in (np.arange(1, 314) * 16.00139123,
              np.geomspace(3.0, 5000.0, 200)):
        f = gnfw_like(r, 3.08)
        ours = forward_abel_matrix(r, scheme="pyabel") @ f
        theirs = pyabel_direct_forward(f, r, correction=True)
        rel = np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-300)
        assert rel[:-1].max() < 1e-12      # last row is exactly zero
        assert ours[-1] == theirs[-1] == 0.0


def test_abel_matrix_linear():
    r = np.arange(10.0, 1000.0, 10.0)
    A = forward_abel_matrix(r)
    rng = np.random.default_rng(0)
    f1, f2 = rng.random(r.size), rng.random(r.size)
    assert np.allclose(A @ (2 * f1 + 3 * f2), 2 * (A @ f1) + 3 * (A @ f2))
    assert np.allclose(np.tril(A, -1), 0.0)
    assert np.allclose(A[-1], 0.0)


# --- spline matrices and the table lookup ------------------------------------


def test_interp_matrix_matches_scipy():
    rng = np.random.default_rng(1)
    knots = np.sort(rng.uniform(0, 10, 25))
    vals = rng.normal(size=25)
    q = rng.uniform(-1, 11, 200)  # includes extrapolation region
    M = interp_matrix(knots, q, kind="cubic", fill_value="extrapolate",
                      assume_sorted=True)
    direct = interp1d(knots, vals, kind="cubic", fill_value="extrapolate",
                      bounds_error=False)(q)
    assert np.allclose(M @ vals, direct, atol=1e-12)


def test_interp_matrix_fill_values():
    knots = np.linspace(0, 1, 10)
    vals = np.sin(knots)
    out = interp_matrix(knots, np.array([-0.5, 0.5, 1.5]), kind="cubic",
                        fill_value=(0.0, 0.0)) @ vals
    assert out[0] == 0.0 and out[2] == 0.0
    assert np.isclose(out[1], interp1d(knots, vals, kind="cubic")(0.5))


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp_matrix_nonzero_fill_rejected(kind):
    """A non-zero constant fill would build a wrong matrix (rows of c, so
    M @ v = c sum(v)): it raises; zero fill stays supported."""
    knots = np.linspace(0.0, 1.0, 8)
    q = np.array([-0.5, 0.5, 1.5])
    with pytest.raises(NotImplementedError, match="constant fills"):
        interp_matrix(knots, q, kind=kind, fill_value=(7.0, 7.0))
    M = interp_matrix(knots, q, kind=kind, fill_value=0.0)
    v = np.linspace(2.0, 3.0, 8)
    assert M.shape == (3, 8)
    assert M[0] @ v == 0.0 and M[2] @ v == 0.0


def test_mirrored_interp_matrix_matches_reference_trick():
    """scipy on the unsorted mirrored knot/value arrays exactly as the
    reference builds them (joxsz_funcs.py:460)."""
    rng = np.random.default_rng(2)
    r = np.linspace(1.0, 50.0, 40)
    v = rng.random(40)
    q = rng.uniform(0.0, 60.0, 300)
    M = mirrored_interp_matrix(r, q, kind="cubic", fill_value=(0.0, 0.0))
    ref = interp1d(np.append(-r, r), np.append(v, v), kind="cubic",
                   bounds_error=False, fill_value=(0.0, 0.0))(q)
    assert np.allclose(M @ v, ref, atol=1e-12)


@pytest.mark.parametrize("extrapolate", [True, False])
def test_lerp_lookup_matches_scipy(extrapolate):
    """Linear extrapolation past both ends (scipy ``fill_value=
    'extrapolate'``) or the ends' values (``np.interp``)."""
    tx = np.array([1.0, 5.0, 7.0, 10.0, 20.0, 30.0, 50.0])
    ty = np.array([-11.6, -11.3, -11.1, -10.9, -10.5, -10.2, -9.9])
    q = np.array([0.5, 1.0, 6.0, 25.0, 50.0, 80.0])
    ours = lerp_lookup(torch.tensor(tx), torch.tensor(ty), torch.tensor(q),
                       extrapolate=extrapolate).numpy()
    ref = (interp1d(tx, ty, kind="linear", fill_value="extrapolate")(q)
           if extrapolate else np.interp(q, tx, ty))
    assert np.allclose(ours, ref, atol=1e-12)


# --- the fused SZ operator ------------------------------------------------


@pytest.fixture(scope="module")
def sz_setup(ref_data, cosmo):
    flux = read_xy(str(ref_data / FLUX), 3)
    beam_2d, fwhm = build_beam(2.0, flux[0][-1],
                               filename=str(ref_data / BEAM))
    geom = build_map_geometry(2.0, flux[0][-1], fwhm, cosmo.kpc_per_arcsec,
                              5000.0)
    wn, tf = read_transfer_function(str(ref_data / TF))
    filt = build_filter_image(wn, tf, geom.side, 2.0)
    return geom, beam_2d, filt, flux


def test_sz_operator_matches_pipeline(sz_setup):
    from joxsz_torch.ops.szkernel import build_sz_operator, sz_map_pipeline

    geom, beam_2d, filt, flux = sz_setup
    op = build_sz_operator(geom, beam_2d, filt, flux[0])
    assert op.L.shape == (86, 313) and op.G.shape == (19, 86)
    pp = gnfw_like(geom.r_press_kpc)
    direct = sz_map_pipeline(pp, geom, beam_2d, filt)
    fused = op.L @ pp
    assert np.allclose(fused, direct, rtol=1e-10, atol=1e-14)
    g = interp1d(geom.radius_arcsec[geom.sep:], direct, kind="cubic",
                 fill_value="extrapolate")(flux[0])
    assert np.allclose(op.G @ fused, g, rtol=1e-10, atol=1e-14)


def test_sz_operator_magnitude(sz_setup):
    """Raw central Compton-y ~1e-4 for a realistic pressure profile, the
    profile peaked at the centre."""
    from joxsz_torch.ops.szkernel import build_sz_operator

    geom, beam_2d, filt, flux = sz_setup
    op = build_sz_operator(geom, beam_2d, filt, flux[0])
    y_prof = op.L @ gnfw_like(geom.r_press_kpc, 2.97)
    assert 1e-5 < y_prof[0] < 1e-3
    assert y_prof[0] == np.max(y_prof)
