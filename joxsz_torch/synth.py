"""A synthetic joint SZ + X-ray dataset at the CL J1226.9+3332 shapes.

The CL J1226 data files are not in the repository, so the port's chip
check and its tests fit a dataset made here from a seed with numpy:

  * SZ: step 2", z = 0.888, extent 5000 kpc -> 313 pressure radii and 86
    map radii; ``n_sz`` flux points out to ``max_radius_arcsec`` with a
    Gaussian beam of ``FWHM_ARCSEC`` and a smooth transfer function;
  * X-ray: the ten CL J1226 bands x ``n_annuli`` annuli, with the bundled
    count-rate table (NH = 0.0183) and the reference parametrisation's
    13 thawed parameters.

At another ``redshift`` the same recipe gives more pressure radii (542
for a cluster at z = 0.3); the dataset then carries a copy of the
count-rate table relabelled at that redshift, so its X-ray rates are CL
J1226's, and the data are drawn from the same model, so a fit still
recovers ``TRUTH``.  With ``response=True`` the dataset carries a
synthetic Chandra-like response instead (an RMF of Gaussian
redistribution, 1000 energies x 1024 channels, and an ARF) and no
``table_path``: ``build_session`` generates the count-rate table at the
dataset's own redshift (``build.find_table``), and the data are drawn
through that table.

The counts and fluxes are the port's own float64 model at ``TRUTH`` plus
Poisson / Gaussian noise, so a fit should recover ``TRUTH``.  Smaller
``n_annuli``, ``n_sz``, ``max_radius_arcsec`` and ``extent_kpc`` give the
small sessions the CPU tests use.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .config import (JoXSZConfig, SZConfig, XrayConfig, MCMCConfig,
                     CL1226_BANDS_EV)
from .tablegen.generate import DEFAULT_NT

REPO = pathlib.Path(__file__).resolve().parents[1]
TABLE_PATH = REPO / "data" / "tables" / "cl1226_ctrate.npz"
FWHM_ARCSEC = 17.6

# the parameter values the synthetic data are drawn at (thawed names)
TRUTH = {
    "log(n_0)": -1.8, r"\beta": 0.75, "log(r_c)": 2.0, "log(r_s)": 2.9,
    r"\epsilon": 3.0, "log(T_X/T_{SZ})": 0.02, "Z": 0.3, "P_0": 0.06,
    "a": 1.3, "b": 4.3, "r_p": 450.0, "backscale": 1.0, "calibration": 1.0,
}


def truth_theta(sess) -> np.ndarray:
    """``TRUTH`` on the thawed layout of ``sess``'s model family: the
    flagship's values where a name is one of them; for knot pressure, the
    gNFW pressure at ``TRUTH`` at the knots; for the Vikhlinin
    temperature, the six values whose profile fits T_X at ``TRUTH`` best
    in log over the pressure grid; a negligible second density component
    (log(n_02) = -5); line_scale 1."""
    from scipy.optimize import least_squares

    from .models import GNFWPressure, UPPTemperature, VikhlininDensity

    p, m = sess.params, sess.model
    flag = GNFWPressure("p")
    dens = VikhlininDensity("ne")
    pars = {k: torch.tensor([[v]], dtype=torch.float64)
            for k, v in TRUTH.items()}
    pars.update(c=0.014, **{r"\alpha": 0.0, r"\gamma": 3.0})
    out = dict(TRUTH)
    out.update({"log(n_{02})": -5.0, r"\beta_2": 0.5, "log(r_{c2})": 1.7,
                "line_scale": 1.0})
    knots = getattr(m.pressure, "knots_logr", None)
    if knots is not None:
        pk = flag(pars, torch.tensor(10.0 ** knots))[0].numpy()
        out.update({f"logP_{i}": float(v)
                    for i, v in enumerate(np.log10(pk))})
    if "T_0" in p.thawed:
        r = m.sz_data.r_press_kpc.detach().cpu().double()
        t_x = UPPTemperature(flag, dens).t_x(pars, r)[0].numpy()
        names = ("T_0", "T_{min}/T_0", "r_{cool}", "a_{cool}", "r_t", "c_t")
        lo = np.array([p[n].minval for n in names])
        hi = np.array([p[n].maxval for n in names])
        x0 = np.clip([float(t_x.max()), 0.5, 100.0, 2.0, 1000.0, 1.0],
                     lo + 1e-6, hi - 1e-6)
        rn = r.numpy()

        def resid(v):
            x = (rn / v[2]) ** v[3]
            t = v[0] * (x + v[1]) / (x + 1.0) * (1.0 + (rn / v[4]) ** 2) \
                ** (-v[5] / 2.0)
            return np.log(t) - np.log(t_x)

        fit = least_squares(resid, x0, bounds=(lo, hi))
        out.update(dict(zip(names, fit.x)))
    return np.array([out[n] for n in p.thawed], dtype=np.float64)


def _write_files(root: pathlib.Path, n_annuli: int, n_sz: int,
                 max_radius_arcsec: float, bands, counts=None, flux=None):
    (root / "SZ").mkdir(parents=True, exist_ok=True)
    (root / "X").mkdir(parents=True, exist_ok=True)
    r_sz = np.linspace(max_radius_arcsec / n_sz, max_radius_arcsec, n_sz)
    err = 0.03 + 0.02 * r_sz / max_radius_arcsec
    if flux is None:
        flux = -np.ones(n_sz)
    np.savetxt(root / "SZ" / "flux.dat", np.column_stack([r_sz, flux, err]))
    wn = np.linspace(0.0, 0.6, 301)
    tf = 0.95 * (1.0 - np.exp(-(wn / 0.012) ** 2))
    np.savetxt(root / "SZ" / "tf.dat", np.column_stack([wn, tf]))
    t_kev = np.arange(0.0, 41.0)
    jy = -11.0 * (1.0 - 0.017 * t_kev + 1.2e-4 * t_kev ** 2)
    np.savetxt(root / "SZ" / "conv.dat", np.column_stack([t_kev, jy]),
               header="T_keV Jy_per_beam", comments="")

    # annuli out to ~4 arcmin, widening outwards
    edges = 4.0 * (np.arange(n_annuli + 1) / n_annuli) ** 1.4
    mid = 0.5 * (edges[1:] + edges[:-1])
    hw = 0.5 * (edges[1:] - edges[:-1])
    geom_area = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
    for bi, (lo, hi) in enumerate(bands):
        area = geom_area * (0.93 + 0.04 * np.cos(np.arange(n_annuli) + bi))
        expo = np.full(n_annuli, 3.0e5)
        back = np.full(n_annuli, 8.0e-5 * (hi - lo) / 1000.0)
        c = (np.ones(n_annuli) if counts is None else counts[bi])
        np.savetxt(root / "X" / f"fg_{lo:04d}_{hi:04d}.dat",
                   np.column_stack([mid, hw, c, area, expo]))
        np.savetxt(root / "X" / f"bg_{lo:04d}_{hi:04d}.dat",
                   np.column_stack([mid, hw, np.zeros(n_annuli), area,
                                    back]))
    return err


def _table_at(root: pathlib.Path, redshift: float) -> str:
    """The bundled count-rate table, or a copy of it under ``root``
    relabelled at ``redshift``."""
    d = dict(np.load(TABLE_PATH))
    meta = json.loads(bytes(d["meta"]).decode())
    if meta["z"] == redshift:
        return str(TABLE_PATH)
    meta["z"] = redshift
    d["meta"] = np.bytes_(json.dumps(meta))
    out = root / "X" / "ctrate.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **d)
    return str(out)


# the synthetic response: energy bins (keV), channels of 14.6 eV (the ACIS
# channel width), Gaussian redistribution of sigma RMF_SIGMA(E) over a
# window of RMF_WINDOW channels, and an effective area peaking near 1.5 keV
RMF_ENERGIES = np.linspace(0.3, 10.3, 1001)
RMF_CHANNELS, RMF_CHANNEL_KEV, RMF_WINDOW = 1024, 0.0146, 64


def _fits_card(key: str, value) -> str:
    v = (f"'{value}'" if isinstance(value, str) else
         "T" if value is True else "F" if value is False else str(value))
    return f"{key.ljust(8)}= {v}".ljust(80)


def _fits_block(text_or_bytes) -> bytes:
    b = (text_or_bytes.encode("ascii") if isinstance(text_or_bytes, str)
         else text_or_bytes)
    pad = b" " if isinstance(text_or_bytes, str) else b"\0"
    return b + pad * ((-len(b)) % 2880)


def _write_bintables(path: pathlib.Path, tables: list):
    """A FITS file of an empty primary HDU and one BINTABLE per entry of
    ``tables``: ``(extname, [(name, tform, (nrows, repeat) big-endian
    array)], extra header cards)``."""
    out = _fits_block("".join(_fits_card(k, v) for k, v in (
        ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0))) + "END".ljust(80))
    for extname, cols, extra in tables:
        nrows = cols[0][2].shape[0]
        rows = np.concatenate([a.reshape(nrows, -1).view(np.uint8)
                               for _, _, a in cols], axis=1)
        cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
                 ("NAXIS1", rows.shape[1]), ("NAXIS2", nrows),
                 ("PCOUNT", 0), ("GCOUNT", 1), ("TFIELDS", len(cols))]
        for i, (name, tform, _) in enumerate(cols, 1):
            cards += [(f"TTYPE{i}", name), (f"TFORM{i}", tform)]
        cards += list(extra) + [("EXTNAME", extname)]
        out += _fits_block("".join(_fits_card(k, v) for k, v in cards)
                           + "END".ljust(80))
        out += _fits_block(rows.tobytes())
    path.write_bytes(out)


def write_synthetic_response(root: pathlib.Path) -> tuple[str, str]:
    """Write ``root/X/synthetic.rmf`` and ``synthetic.arf`` (see the
    constants above; F_CHAN 1-based with TLMIN4 = 1) and return their
    paths."""
    lo, hi = RMF_ENERGIES[:-1], RMF_ENERGIES[1:]
    mid = 0.5 * (lo + hi)
    nE, nC, win = mid.size, RMF_CHANNELS, RMF_WINDOW
    ch_lo = RMF_CHANNEL_KEV * np.arange(nC)
    centre = np.floor(mid / RMF_CHANNEL_KEV).astype(int)
    first = np.clip(centre - win // 2, 0, nC - win)
    cols = first[:, None] + np.arange(win)
    sigma = 0.02 + 0.01 * np.sqrt(mid)[:, None]
    w = np.exp(-0.5 * ((ch_lo[cols] + 0.5 * RMF_CHANNEL_KEV - mid[:, None])
                       / sigma) ** 2)
    w = 0.98 * w / w.sum(axis=1, keepdims=True)
    f4, i4 = ">f4", ">i4"
    (root / "X").mkdir(parents=True, exist_ok=True)
    rmf, arf = root / "X" / "synthetic.rmf", root / "X" / "synthetic.arf"
    _write_bintables(rmf, [
        ("MATRIX", [("ENERG_LO", "1E", lo.astype(f4)),
                    ("ENERG_HI", "1E", hi.astype(f4)),
                    ("N_GRP", "1J", np.ones(nE, i4)),
                    ("F_CHAN", "1J", (first + 1).astype(i4)),
                    ("N_CHAN", "1J", np.full(nE, win, i4)),
                    ("MATRIX", f"{win}E", w.astype(f4))], [("TLMIN4", 1)]),
        ("EBOUNDS", [("CHANNEL", "1J", np.arange(1, nC + 1).astype(i4)),
                     ("E_MIN", "1E", ch_lo.astype(f4)),
                     ("E_MAX", "1E", (ch_lo + RMF_CHANNEL_KEV).astype(f4))],
         [])])
    area = 20.0 + 600.0 * np.exp(-0.5 * (np.log(mid / 1.5) / 0.6) ** 2)
    _write_bintables(arf, [
        ("SPECRESP", [("ENERG_LO", "1E", lo.astype(f4)),
                      ("ENERG_HI", "1E", hi.astype(f4)),
                      ("SPECRESP", "1E", area.astype(f4))], [])])
    return str(rmf), str(arf)


def write_synthetic_dataset(out_dir, seed: int, *, n_annuli: int = 15,
                            n_sz: int = 19, max_radius_arcsec: float = 118.0,
                            extent_kpc: float = 5000.0,
                            redshift: float = 0.888,
                            bands=CL1226_BANDS_EV,
                            response: bool = False,
                            nT: int = DEFAULT_NT,
                            step_arcsec: float = JoXSZConfig.step_arcsec,
                            fwhm_arcsec: float = FWHM_ARCSEC,
                            nh_1022: float = XrayConfig.NH_1022pcm2,
                            pressure_model: str = "gnfw",
                            n_pressure_knots: int = 7,
                            temperature_model: str = "upp",
                            density_mode: str = "single",
                            line_systematic: bool = False,
                            keep_table: bool = False) -> JoXSZConfig:
    """Write the dataset under ``out_dir`` and return its config (the
    default sizes are the CL J1226 shapes).  Deterministic in ``seed``.

    Another cluster and instrument: ``step_arcsec`` (the map's pixel),
    ``fwhm_arcsec`` (the Gaussian beam), ``redshift``, ``extent_kpc``,
    ``n_annuli`` x ``bands`` and ``n_sz``; ``nT`` (the count-rate table's
    temperatures) and ``nh_1022`` (the column) other than the bundled
    table's need ``response``.  The model family (``pressure_model``,
    ``n_pressure_knots``, ``temperature_model``, ``density_mode``,
    ``line_systematic``) goes into the config, and the data are drawn
    from that family's model at ``truth_theta``.
    ``response``: write the synthetic RMF/ARF; the table the data are
    drawn through is generated on the CPU here and, unless
    ``keep_table``, not kept (``table_path`` unset: see the module's
    docstring); with ``keep_table`` it stays as ``X/synthetic_ctrate.npz``
    and ``table_path`` names it, so that every reader loads that file."""
    from .build import build_session
    from .models.xray import predicted_counts
    from .models.sz import sz_brightness

    if not response and (nT != DEFAULT_NT
                         or nh_1022 != XrayConfig.NH_1022pcm2):
        raise ValueError("nT and nh_1022 other than the bundled table's "
                         "need response=True (a generated table)")
    if keep_table and not response:
        raise ValueError("keep_table needs response=True")
    root = pathlib.Path(out_dir).resolve()
    rng = np.random.default_rng(seed)
    table = rmf = arf = None
    bands = tuple(tuple(int(e) for e in b) for b in bands)
    if response:
        from .tablegen import TableSpec, generate_table, save_table

        rmf, arf = write_synthetic_response(root)
        table = root / "X" / "synthetic_ctrate.npz"
        save_table(str(table), generate_table(TableSpec(
            rmf=rmf, arf=arf, bands_eV=bands, z=redshift,
            NH_1022pcm2=nh_1022, nT=nT), device="cpu"))
    cfg = JoXSZConfig(
        step_arcsec=step_arcsec,
        cluster_extent_kpc=extent_kpc,
        redshift=redshift,
        sz=SZConfig(tf_file=str(root / "SZ" / "tf.dat"),
                    flux_file=str(root / "SZ" / "flux.dat"),
                    conversion_file=str(root / "SZ" / "conv.dat"),
                    beam_approx=True, fwhm_beam_arcsec=fwhm_arcsec),
        xray=XrayConfig(fg_template=str(root / "X" / "fg_%04i_%04i.dat"),
                        bg_template=str(root / "X" / "bg_%04i_%04i.dat"),
                        bands_eV=bands, NH_1022pcm2=nh_1022,
                        line_systematic=line_systematic,
                        table_path=(str(table) if response
                                    else _table_at(root, redshift)),
                        **({"rmf": rmf, "arf": arf} if response else {})),
        mcmc=MCMCConfig(seed=seed),
        pressure_model=pressure_model, n_pressure_knots=n_pressure_knots,
        temperature_model=temperature_model, density_mode=density_mode,
    )
    # pass 1: placeholder data, to evaluate the model at truth_theta
    err = _write_files(root, n_annuli, n_sz, max_radius_arcsec, bands)
    sess = build_session(cfg, device="cpu")
    theta = torch.tensor(truth_theta(sess)[None], dtype=torch.float64)
    pars = sess.params.unpack(theta)
    m = sess.model
    with torch.no_grad():
        pred = predicted_counts(pars, m.xray_data, m.density,
                                m.temperature)[0].numpy()
        prof = sz_brightness(pars, m.sz_data, m.pressure, m.temperature)
        model_flux = (prof @ m.sz_data.G.T)[0].numpy()
    # pass 2: the data — Poisson counts, Gaussian SZ noise
    counts = rng.poisson(pred).astype(float)
    flux = model_flux + err * rng.standard_normal(n_sz)
    _write_files(root, n_annuli, n_sz, max_radius_arcsec, bands,
                 counts=counts, flux=flux)
    if response and not keep_table:
        table.unlink()
        cfg.xray.table_path = None
    return cfg


def write_observation(cfg: JoXSZConfig, obs, out_dir) -> JoXSZConfig:
    """A copy of ``cfg``'s dataset under ``out_dir`` whose data are the
    mock observation ``obs`` (``simulate.MockObservation``): its SZ flux
    and, where it has them, its X-ray counts; beam, transfer function,
    conversion table, backgrounds, exposures and the count-rate table stay
    ``cfg``'s.  Returns the copy's config, with ``cfg``'s model settings;
    a mock without X-ray counts gives an SZ-only config (no X-ray part),
    so a ``survey --spec`` can list it beside joint clusters."""
    import copy
    import shutil

    root = pathlib.Path(out_dir).resolve()
    (root / "SZ").mkdir(parents=True, exist_ok=True)
    new = copy.deepcopy(cfg)
    flux = np.loadtxt(cfg.sz.flux_file)
    flux[:, 1] = obs.sz_flux
    new.sz.flux_file = str(root / "SZ" / "flux.dat")
    np.savetxt(new.sz.flux_file, flux)
    for field in ("tf_file", "conversion_file", "beam_file"):
        src = getattr(cfg.sz, field, None)
        if src:
            dst = root / "SZ" / pathlib.Path(src).name
            shutil.copyfile(src, dst)
            setattr(new.sz, field, str(dst))
    if obs.xray_counts is None or cfg.xray is None:
        new.xray = None
        return new
    (root / "X").mkdir(parents=True, exist_ok=True)
    new.xray.fg_template = str(root / "X" / "fg_%04i_%04i.dat")
    new.xray.bg_template = str(root / "X" / "bg_%04i_%04i.dat")
    for bi, (lo, hi) in enumerate(cfg.xray.bands_eV):
        fg = np.loadtxt(cfg.xray.fg_template % (lo, hi))
        fg[:, 2] = obs.xray_counts[bi]
        np.savetxt(new.xray.fg_template % (lo, hi), fg)
        shutil.copyfile(cfg.xray.bg_template % (lo, hi),
                        new.xray.bg_template % (lo, hi))
    return new


def config_json(cfg: JoXSZConfig, path) -> str:
    """Write ``cfg`` as the JSON file ``--config`` reads; returns the path."""
    pathlib.Path(path).write_text(cfg.to_json())
    return str(path)


def bands_between(n: int, lo_ev: int = 700, hi_ev: int = 7000) -> tuple:
    """``n`` contiguous bands (eV) from ``lo_ev`` to ``hi_ev``, their edges
    spaced geometrically and rounded to 100 eV."""
    edges = np.round(np.geomspace(lo_ev, hi_ev, n + 1) / 100.0) * 100
    if np.any(np.diff(edges) <= 0):
        raise ValueError(f"{n} bands of at least 100 eV do not fit in "
                         f"{lo_ev}-{hi_ev} eV")
    return tuple((int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]))


# Clusters and instruments other than CL J1226: the six corners of the JAX
# package's geometry sweep (tests/test_geometry_sweep.py:101-143, one axis
# stressed each: table nT, annuli and bands, a large map, knots, double
# density, SZ-only), then line_scale and config #4 (knots + Vikhlinin T) at
# band and annulus counts other than CL J1226's; what a corner leaves
# unset is CORNER_DEFAULTS, the JAX sweep's builder's defaults
CORNER_DEFAULTS = dict(max_radius_arcsec=300.0, n_sz=40, fwhm_arcsec=15.0,
                       nh_1022=0.03, n_bands=5, nT=64)
CORNERS = {
    "nT32": dict(nT=32, n_annuli=8, n_bands=3, step_arcsec=6.0,
                 max_radius_arcsec=200.0, extent_kpc=1800.0, redshift=0.35),
    "nT96_many_annuli": dict(nT=96, n_annuli=24, n_bands=12,
                             step_arcsec=3.0, max_radius_arcsec=250.0,
                             extent_kpc=2200.0, redshift=0.8),
    "large_map": dict(step_arcsec=2.5, max_radius_arcsec=420.0,
                      fwhm_arcsec=22.0, extent_kpc=4200.0, n_annuli=15,
                      n_bands=6, nT=64, redshift=1.1),
    "knots": dict(nT=32, n_annuli=10, n_bands=4, step_arcsec=5.0,
                  extent_kpc=2000.0, redshift=0.25, pressure_model="knots",
                  n_pressure_knots=5),
    "double_density": dict(nT=64, n_annuli=9, n_bands=5, step_arcsec=4.5,
                           extent_kpc=2600.0, redshift=0.6,
                           density_mode="double"),
    "sz_only": dict(step_arcsec=3.5, max_radius_arcsec=350.0,
                    extent_kpc=3000.0, redshift=0.45, sz_only=True),
    "line_scale": dict(nT=48, n_annuli=13, n_bands=7, step_arcsec=4.0,
                       extent_kpc=2400.0, redshift=0.7, n_sz=23,
                       line_systematic=True),
    "config4": dict(nT=64, n_annuli=11, n_bands=8, step_arcsec=3.0,
                    extent_kpc=2500.0, redshift=0.5, n_sz=31,
                    pressure_model="knots", n_pressure_knots=6,
                    temperature_model="vikhlinin"),
}


def corner_kwargs(dims: dict) -> tuple[dict, bool]:
    """``write_synthetic_dataset``'s arguments for a corner's ``dims`` (the
    keys of ``CORNERS``' entries, ``n_bands`` and ``sz_only`` included):
    CORNER_DEFAULTS filled in, ``n_bands`` bands (``bands_between``), the
    synthetic response with its table kept, and the extent raised, as the
    JAX sweep's builder raises it, to six map pixels past the map's
    half-axis (SZ radius + 3 FWHM).  Returns (arguments, SZ-only)."""
    from .cosmology import Cosmology

    kw = dict(CORNER_DEFAULTS, response=True, keep_table=True, **dims)
    sz_only = kw.pop("sz_only", False)
    kw["bands"] = bands_between(kw.pop("n_bands"))
    step = kw.get("step_arcsec", JoXSZConfig.step_arcsec)
    sep = int((kw["max_radius_arcsec"] + 3.0 * kw["fwhm_arcsec"]) // step)
    kpc_as = Cosmology(z=kw["redshift"]).kpc_per_arcsec
    kw["extent_kpc"] = max(kw.get("extent_kpc", 0.0),
                           (sep + 6) * step * kpc_as)
    return kw, sz_only


def write_corner(out_dir, seed: int, dims: dict):
    """The dataset of a corner (``corner_kwargs``) under ``out_dir``;
    returns (config, SZ-only: build its session with ``sz_only``)."""
    kw, sz_only = corner_kwargs(dims)
    return write_synthetic_dataset(out_dir, seed, **kw), sz_only


def _parse_bands(text: str) -> tuple:
    try:
        return tuple(tuple(int(e) for e in b.split("-"))
                     for b in text.split(","))
    except ValueError:
        raise SystemExit(f"--bands takes LO-HI,LO-HI,... in eV, got "
                         f"{text!r}") from None


def main(argv=None):
    """``python -m joxsz_torch.synth OUT_DIR [--seed N] [geometry and
    model flags]``: write a synthetic dataset (by default the CL J1226
    shapes; the flags give another cluster and instrument, as
    ``write_synthetic_dataset``'s arguments do) and ``OUT_DIR/cfg.json``
    with the card's production schedule (``MCMCConfig.converged_gpu``),
    the config a flagless ``python -m joxsz_torch.run --config
    OUT_DIR/cfg.json`` fits."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--redshift", type=float, default=0.888)
    ap.add_argument("--extent-kpc", type=float, default=5000.0)
    ap.add_argument("--step", type=float, default=JoXSZConfig.step_arcsec,
                    help="map pixel (arcsec)")
    ap.add_argument("--fwhm", type=float, default=FWHM_ARCSEC,
                    help="beam FWHM (arcsec)")
    ap.add_argument("--n-sz", type=int, default=19,
                    help="SZ flux points")
    ap.add_argument("--max-radius", type=float, default=118.0,
                    help="outermost SZ flux point (arcsec)")
    ap.add_argument("--n-annuli", type=int, default=15)
    bands = ap.add_mutually_exclusive_group()
    bands.add_argument("--bands", type=_parse_bands,
                       help="X-ray bands LO-HI,LO-HI,... in eV (default: "
                            "CL J1226's ten)")
    bands.add_argument("--n-bands", type=int,
                       help="N bands over 0.7-7 keV (bands_between)")
    ap.add_argument("--response", action="store_true",
                    help="write a synthetic RMF/ARF and generate the "
                         "count-rate table from it (needed for --nT and "
                         "--nh)")
    ap.add_argument("--keep-table", action="store_true",
                    help="with --response: keep the generated table and "
                         "name it in the config")
    ap.add_argument("--nT", type=int, default=DEFAULT_NT,
                    help="temperatures of the count-rate table")
    ap.add_argument("--nh", type=float, default=XrayConfig.NH_1022pcm2,
                    help="absorbing column (1e22 cm^-2)")
    ap.add_argument("--pressure", choices=("gnfw", "knots"), default="gnfw")
    ap.add_argument("--n-knots", type=int, default=7,
                    help="pressure knots (--pressure knots)")
    ap.add_argument("--temperature", choices=("upp", "vikhlinin"),
                    default="upp")
    ap.add_argument("--density", choices=("single", "double"),
                    default="single")
    ap.add_argument("--line-systematic", action="store_true")
    args = ap.parse_args(argv)
    band_list = (args.bands if args.bands else
                 bands_between(args.n_bands) if args.n_bands else
                 CL1226_BANDS_EV)
    try:
        cfg = write_synthetic_dataset(
            args.out_dir, args.seed, n_annuli=args.n_annuli, n_sz=args.n_sz,
            max_radius_arcsec=args.max_radius, extent_kpc=args.extent_kpc,
            redshift=args.redshift, bands=band_list, response=args.response,
            nT=args.nT, step_arcsec=args.step, fwhm_arcsec=args.fwhm,
            nh_1022=args.nh, pressure_model=args.pressure,
            n_pressure_knots=args.n_knots,
            temperature_model=args.temperature, density_mode=args.density,
            line_systematic=args.line_systematic,
            keep_table=args.keep_table)
    except ValueError as e:
        raise SystemExit(f"synth: {e}") from None
    cfg.mcmc = MCMCConfig.converged_gpu()
    cfg.mcmc.seed = args.seed
    cfg.save_dir = str(pathlib.Path(args.out_dir).resolve())
    print(config_json(cfg, pathlib.Path(args.out_dir) / "cfg.json"))


if __name__ == "__main__":
    main()
