"""Assembly: config -> data products -> fused operators -> JointModel.

Torch counterpart of ``joxsz_tpu/build.py::build_session`` (reference
``main()`` setup phase, joxsz_main.py:93-188), built from the port's own
copies of the numpy host modules.  The session holds the plain-torch
``JointModel`` on the chosen device; the kernels pack their own float32
constants from it (``ops.joint_kernel.JointConsts``).

``session_from_arrays`` builds the same session from the numpy arrays a
``joxsz_tpu`` ``FitSession`` holds (the reference's "weights"), so the
parity tests evaluate one function in both packages.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from .config import JoXSZConfig
from .cosmology import Cosmology
from .device import resolve_device
from .geometry import (build_beam, build_map_geometry, build_filter_image,
                       Annuli, MapGeometry)
from .io.readers import (read_xy, read_transfer_function,
                         read_conversion_table, load_band)
from .models import (GNFWPressure, KnotPressure, VikhlininDensity,
                     UPPTemperature, VikhlininTemperature, SZData, XrayData,
                     CountRateTable, JointModel, Param, ParamSet,
                     build_reference_params)
from .ops.szkernel import build_sz_operator, SZOperator
from .tablegen.generate import (SPECTRAL_MODEL_VERSION, TableSpec,
                                generate_table, save_table)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the bundled table of CL J1226
BUNDLED_TABLE = REPO / "data" / "tables" / "cl1226_ctrate.npz"
# where find_table looks for and writes generated tables, ctrate_<key>.npz
TABLES_DIR = REPO / "data" / "tables"


@dataclasses.dataclass
class FitSession:
    """Everything a fit run needs, fully constructed."""

    model: JointModel
    sz_operator: SZOperator
    device: torch.device
    config: JoXSZConfig | None = None
    cosmology: Cosmology | None = None
    geometry: MapGeometry | None = None
    annuli: Annuli | None = None
    bands: list | None = None      # the X-ray bands' BandData (figures)

    @property
    def params(self) -> ParamSet:
        return self.model.params


def build_session(cfg: JoXSZConfig, device=None, dtype=torch.float64,
                  sz_only: bool = False) -> FitSession:
    """Build the session on ``device`` (default: the card), as
    ``joxsz_tpu/build.py::build_session``: the config's model family
    (pressure ``gnfw``/``knots``, temperature ``upp``/``vikhlinin``,
    density ``single``/``double``), the SZ-only (preprofit) fit when
    ``sz_only`` or the config has no X-ray part, and the ``line_scale``
    nuisance thawed by ``xray.line_systematic``."""
    dev = resolve_device(device)
    cosmo = Cosmology(z=cfg.redshift, H0=cfg.H0, WM=cfg.WM, WV=cfg.WV)

    flux = read_xy(cfg.sz.flux_file, ncol=3)
    max_r = flux[0][-1]
    beam_2d, fwhm = build_beam(
        cfg.step_arcsec, max_r, approx=cfg.sz.beam_approx,
        filename=cfg.sz.beam_file, fwhm_arcsec=cfg.sz.fwhm_beam_arcsec)
    geom = build_map_geometry(cfg.step_arcsec, max_r, fwhm,
                              cosmo.kpc_per_arcsec, cfg.cluster_extent_kpc)
    if geom.r_press_kpc.size < geom.sep:
        need = geom.sep * cfg.step_arcsec * cosmo.kpc_per_arcsec
        raise ValueError(
            f"cluster_extent_kpc={cfg.cluster_extent_kpc:g} yields a "
            f"{geom.r_press_kpc.size}-point pressure grid, shorter than the "
            f"map half-axis (sep={geom.sep}); increase cluster_extent_kpc "
            f"to >= {need:.0f} kpc")
    wn, tf = read_transfer_function(
        cfg.sz.tf_file, approx=cfg.sz.tf_approx, loc=cfg.sz.tf_loc,
        scale=cfg.sz.tf_scale, c=cfg.sz.tf_c)
    filt = build_filter_image(wn, tf, geom.side, cfg.step_arcsec)
    op = build_sz_operator(geom, beam_2d, filt, flux[0],
                           abel_scheme=cfg.abel_scheme)
    conv_table = read_conversion_table(cfg.sz.conversion_file)
    sz_data = SZData.build(
        op, conv_table, flux, geom.r_press_kpc, geom.sep, dtype=dtype,
        device=dev, calc_integ=cfg.sz.calc_integ, integ_mu=cfg.sz.integ_mu,
        integ_sig=cfg.sz.integ_sig)

    if cfg.pressure_model == "knots":
        pressure = KnotPressure(np.geomspace(
            geom.r_press_kpc[0], geom.r_press_kpc[-1], cfg.n_pressure_knots),
            name="p")
    elif cfg.pressure_model == "gnfw":
        pressure = GNFWPressure("p")
    else:
        raise ValueError(f"unknown pressure_model {cfg.pressure_model!r}")
    density = VikhlininDensity("ne", mode=cfg.density_mode)
    temperature = _temperature(cfg.temperature_model, pressure, density)

    annuli = xray_data = edges_logkpc = bands = None
    if cfg.xray is not None and not sz_only:
        bands = [load_band(cfg.xray.fg_template, cfg.xray.bg_template, b)
                 for b in cfg.xray.bands_eV]
        annuli = Annuli(edges_arcmin=bands[0].edges_arcmin, cosmology=cosmo)
        edges_logkpc = annuli.edges_logkpc
        table = CountRateTable.from_npz(
            find_table(cfg, dtype, device=dev), dtype=dtype, device=dev,
            expect=table_expect(cfg))
        xray_data = XrayData.build(bands, annuli, table, dtype=dtype,
                                   device=dev)

    params = build_reference_params(
        pressure, density, temperature,
        Z_solar=cfg.xray.Z_solar if cfg.xray is not None else 0.3,
        edges_logkpc=edges_logkpc)
    if xray_data is None:
        # SZ-only: freeze what only the X-ray likelihood constrains
        # (joxsz_tpu/build.py:231-237)
        for name in ("Z", "backscale", "log(T_X/T_{SZ})", "line_scale"):
            if name in params:
                params.freeze(name)
    elif cfg.xray.line_systematic:
        params.thaw("line_scale")
    model = JointModel(pressure=pressure, density=density,
                       temperature=temperature, params=params,
                       sz_data=sz_data, xray_data=xray_data,
                       exclude_unphysical_mass=cfg.exclude_unphysical_mass)
    return FitSession(model=model, sz_operator=op, device=dev, config=cfg,
                      cosmology=cosmo, geometry=geom, annuli=annuli,
                      bands=bands)


def _temperature(name: str, pressure, density):
    if name == "upp":
        return UPPTemperature(pressure, density, "T")
    if name == "vikhlinin":
        return VikhlininTemperature("T")
    raise ValueError(f"unknown temperature_model {name!r}")


def family(model: JointModel) -> tuple[str, str, str]:
    """The model's (pressure, temperature, density mode) as the config
    names them, e.g. ("knots", "vikhlinin", "single")."""
    p = "knots" if isinstance(model.pressure, KnotPressure) else "gnfw"
    t = ("vikhlinin" if isinstance(model.temperature, VikhlininTemperature)
         else "upp")
    return p, t, model.density.mode


def family_name(model: JointModel) -> str:
    """The model family as the CLI prints it, e.g. "knots pressure +
    vikhlinin T + single density"."""
    return "{} pressure + {} T + {} density".format(*family(model))


# -- the count-rate table -----------------------------------------------------

def table_expect(cfg: JoXSZConfig) -> dict:
    """The metadata a count-rate table must carry for ``cfg``."""
    return {"z": cfg.redshift, "NH_1022pcm2": cfg.xray.NH_1022pcm2,
            "bands_eV": tuple(cfg.xray.bands_eV),
            "model_version": SPECTRAL_MODEL_VERSION}


def find_table(cfg: JoXSZConfig, dtype=torch.float64, device=None) -> str:
    """The count-rate table of ``cfg``: ``xray.table_path`` where it
    exists, else the first of ``TABLES_DIR/ctrate_<key>.npz`` and the
    bundled ``cl1226_ctrate.npz`` whose metadata match the config's
    redshift, column, bands and spectral-model version (<key> is
    ``TableSpec.key``); where none matches, the table is generated from
    the config's RMF/ARF on ``device`` (default: the card) and saved as
    ``TABLES_DIR/ctrate_<key>.npz`` (``joxsz_tpu/build.py:194-221``)."""
    path = cfg.xray.table_path
    if path is not None and pathlib.Path(path).exists():
        return path
    spec = TableSpec(rmf=cfg.xray.rmf, arf=cfg.xray.arf,
                     bands_eV=tuple(cfg.xray.bands_eV), z=cfg.redshift,
                     NH_1022pcm2=cfg.xray.NH_1022pcm2)
    generated = pathlib.Path(TABLES_DIR) / f"ctrate_{spec.key()}.npz"
    for cand in (generated, BUNDLED_TABLE):
        if not cand.exists():
            continue
        try:
            CountRateTable.from_npz(str(cand), dtype=dtype,
                                    device=torch.device("cpu"),
                                    expect=table_expect(cfg))
        except ValueError:
            continue
        return str(cand)
    dev = resolve_device(device)
    print(f"no count-rate table matches z={cfg.redshift}, NH="
          f"{cfg.xray.NH_1022pcm2} and these bands: generating {generated} "
          f"from {cfg.xray.rmf} and {cfg.xray.arf} on {dev}")
    t0 = time.time()
    save_table(str(generated), generate_table(spec, device=dev))
    print(f"count-rate table generated in {time.time() - t0:.2f} s")
    return str(generated)


# -- the arrays that define a session ----------------------------------------

def session_arrays(sess: FitSession) -> dict:
    """The numpy arrays that define ``sess``'s likelihood (the inverse of
    :func:`session_from_arrays`; keys as documented there)."""
    m = sess.model
    sz, xr, p, op = m.sz_data, m.xray_data, m.params, sess.sz_operator

    def n(t):
        return t.detach().cpu().numpy().astype(np.float64)

    out = {
        "sz.L": op.L, "sz.G": op.G, "sz.w_T0": op.w_T0, "sz.w_y0": op.w_y0,
        "sz.integ_w": op.integ_w, "sz.y_prefactor": op.y_prefactor,
        "sz.r_press_kpc": n(sz.r_press_kpc), "sz.sep": sz.sep,
        "sz.flux_r": n(sz.flux_r), "sz.flux": n(sz.flux),
        "sz.flux_err": n(sz.flux_err), "sz.conv_T": n(sz.conv_T),
        "sz.conv_val": n(sz.conv_val), "sz.calc_integ": sz.calc_integ,
        "sz.integ_mu": sz.integ_mu, "sz.integ_sig": sz.integ_sig,
        "params.names": list(p.names),
        "params.values": np.array([p[k].val for k in p.names]),
        "params.frozen": np.array([p[k].frozen for k in p.names]),
        "params.lo": p.lo, "params.hi": p.hi, "params.is_gauss": p.is_gauss,
        "params.mu": p.mu, "params.sigma": p.sigma,
        "exclude_unphysical_mass": m.exclude_unphysical_mass,
        **dict(zip(("model.pressure", "model.temperature",
                    "model.density_mode"), family(m))),
    }
    if isinstance(m.pressure, KnotPressure):
        out["model.knots_logr"] = m.pressure.knots_logr
    if xr is not None:
        out.update({
            "xray.counts": np.where(n(xr.counts_mask) > 0,
                                    n(xr.counts_filled), np.nan),
            "xray.exposures": n(xr.exposures),
            "xray.areascales": n(xr.areascales), "xray.areas": n(xr.areas),
            "xray.backrates": n(xr.backrates),
            "xray.vols_norm": n(xr.vols_norm),
            "xray.midpt_kpc": n(xr.midpt_kpc),
            "xray.norm_per_cm3": xr.norm_per_cm3,
            "table.Tlog": n(xr.table.Tlog),
            "table.lograte_Z0": n(xr.table.lograte_Z0),
            "table.lograte_Z1": n(xr.table.lograte_Z1)})
        if xr.table.logflux_Z0 is not None:
            out.update({"table.logflux_Z0": n(xr.table.logflux_Z0),
                        "table.logflux_Z1": n(xr.table.logflux_Z1)})
    return out


def session_from_arrays(arrays: dict, device=None,
                        dtype=torch.float64) -> FitSession:
    """Build a session from the arrays that define the likelihood.

    Keys (all numpy arrays or python scalars): ``sz.{L, G, w_T0, w_y0,
    integ_w, y_prefactor, r_press_kpc, sep, flux_r, flux, flux_err,
    conv_T, conv_val, calc_integ, integ_mu, integ_sig}``,
    ``xray.{counts (NaN = masked), exposures, areascales, areas,
    backrates, vols_norm, midpt_kpc, norm_per_cm3}``, ``table.{Tlog,
    lograte_Z0, lograte_Z1}`` and optionally ``table.{logflux_Z0,
    logflux_Z1}`` (the cooling time's; the ``xray`` and ``table`` keys
    absent or None for an SZ-only session), ``params.{names, values, frozen}`` over
    every parameter and ``params.{lo, hi, is_gauss, mu, sigma}`` over the
    thawed ones, ``exclude_unphysical_mass``, and the model family
    ``model.{pressure ("gnfw" | "knots"), knots_logr (knots: the knots'
    log10 radii), temperature ("upp" | "vikhlinin"), density_mode
    ("single" | "double")}`` (the flagship's where absent)."""
    dev = resolve_device(device)
    a = arrays
    L = np.asarray(a["sz.L"], dtype=np.float64)
    op = SZOperator(L=L, G=np.asarray(a["sz.G"], np.float64),
                    w_T0=np.asarray(a["sz.w_T0"], np.float64),
                    w_y0=np.asarray(a["sz.w_y0"], np.float64),
                    integ_w=np.asarray(a["sz.integ_w"], np.float64),
                    y_prefactor=float(a["sz.y_prefactor"]),
                    n_pix=L.shape[0], n_press=L.shape[1])
    sz_data = SZData.build(
        op, (a["sz.conv_T"], a["sz.conv_val"]),
        (a["sz.flux_r"], a["sz.flux"], a["sz.flux_err"]),
        a["sz.r_press_kpc"], int(a["sz.sep"]), dtype=dtype, device=dev,
        calc_integ=bool(a["sz.calc_integ"]),
        integ_mu=float(a["sz.integ_mu"]), integ_sig=float(a["sz.integ_sig"]))
    xray_data = None
    if a.get("xray.counts") is not None:
        table = CountRateTable.from_arrays(
            a["table.Tlog"], a["table.lograte_Z0"], a["table.lograte_Z1"],
            dtype=dtype, device=dev, logflux_Z0=a.get("table.logflux_Z0"),
            logflux_Z1=a.get("table.logflux_Z1"))
        xray_data = XrayData.from_arrays(
            counts=a["xray.counts"], exposures=a["xray.exposures"],
            areascales=a["xray.areascales"], areas=a["xray.areas"],
            backrates=a["xray.backrates"], vols_norm=a["xray.vols_norm"],
            midpt_kpc=a["xray.midpt_kpc"],
            norm_per_cm3=float(a["xray.norm_per_cm3"]), table=table,
            dtype=dtype, device=dev)

    names = [str(s) for s in a["params.names"]]
    frozen = np.asarray(a["params.frozen"], dtype=bool)
    values = np.asarray(a["params.values"], dtype=np.float64)
    thawed = [nm for nm, f in zip(names, frozen) if not f]
    ti = {nm: i for i, nm in enumerate(thawed)}
    plist = []
    for nm, f, v in zip(names, frozen, values):
        if f:
            plist.append((nm, Param(float(v), frozen=True)))
            continue
        i = ti[nm]
        gauss = bool(a["params.is_gauss"][i])
        plist.append((nm, Param(
            float(v), minval=float(a["params.lo"][i]),
            maxval=float(a["params.hi"][i]),
            prior="gauss" if gauss else "box",
            prior_mu=float(a["params.mu"][i]) if gauss else None,
            prior_sigma=float(a["params.sigma"][i]) if gauss else None)))
    params = ParamSet(plist)

    if a.get("model.pressure", "gnfw") == "knots":
        pressure = KnotPressure(knots_logr=a["model.knots_logr"], name="p")
    else:
        pressure = GNFWPressure("p")
    density = VikhlininDensity("ne", mode=a.get("model.density_mode",
                                                 "single"))
    temperature = _temperature(a.get("model.temperature", "upp"), pressure,
                               density)
    model = JointModel(pressure=pressure, density=density,
                       temperature=temperature, params=params,
                       sz_data=sz_data, xray_data=xray_data,
                       exclude_unphysical_mass=bool(
                           a["exclude_unphysical_mass"]))
    return FitSession(model=model, sz_operator=op, device=dev)
