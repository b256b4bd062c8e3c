"""The reference model of a dataset: the plain float64 joint posterior
built from the dataset's own files (the configuration JSON that
``write_dataset`` writes, in the layout the program's ``JoXSZConfig``
reads), as the program's session builder assembles it, for the families
the benchmark's configurations use."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .cosmology import Cosmology
from .geometry import build_beam, build_map_geometry, build_filter_image
from .geometry import Annuli
from .io.readers import (read_xy, read_transfer_function,
                         read_conversion_table, load_band)
from .models import (GNFWPressure, KnotPressure, VikhlininDensity,
                     UPPTemperature, VikhlininTemperature, SZData, XrayData,
                     CountRateTable, JointModel, build_reference_params)
from .ops.szkernel import build_sz_operator


def build_model(cfg: dict | str | pathlib.Path, *, device="cpu",
                dtype=torch.float64) -> JointModel:
    """The joint model of the configuration ``cfg`` (a dict, or the path
    of its JSON file) on ``device`` in ``dtype``."""
    if not isinstance(cfg, dict):
        cfg = json.loads(pathlib.Path(cfg).read_text())
    sz, xr = cfg["sz"], cfg["xray"]
    cosmo = Cosmology(z=cfg["redshift"], H0=cfg["H0"], WM=cfg["WM"],
                      WV=cfg["WV"])
    flux = read_xy(sz["flux_file"], ncol=3)
    beam_2d, fwhm = build_beam(cfg["step_arcsec"], flux[0][-1], approx=True,
                               fwhm_arcsec=sz["fwhm_beam_arcsec"])
    geom = build_map_geometry(cfg["step_arcsec"], flux[0][-1], fwhm,
                              cosmo.kpc_per_arcsec,
                              cfg["cluster_extent_kpc"])
    wn, tf = read_transfer_function(sz["tf_file"])
    filt = build_filter_image(wn, tf, geom.side, cfg["step_arcsec"])
    op = build_sz_operator(geom, beam_2d, filt, flux[0])
    sz_data = SZData.build(op, read_conversion_table(sz["conversion_file"]),
                           flux, geom.r_press_kpc, geom.sep, dtype=dtype,
                           device=device)
    if cfg["pressure_model"] == "knots":
        pressure = KnotPressure(np.geomspace(
            geom.r_press_kpc[0], geom.r_press_kpc[-1],
            cfg["n_pressure_knots"]), name="p")
    else:
        pressure = GNFWPressure("p")
    density = VikhlininDensity("ne", mode=cfg["density_mode"])
    if cfg["temperature_model"] == "vikhlinin":
        temperature = VikhlininTemperature("T")
    else:
        temperature = UPPTemperature(pressure, density, "T")
    bands = [load_band(xr["fg_template"], xr["bg_template"], tuple(b))
             for b in xr["bands_eV"]]
    annuli = Annuli(edges_arcmin=bands[0].edges_arcmin, cosmology=cosmo)
    table = CountRateTable.from_npz(xr["table_path"], dtype=dtype,
                                    device=device)
    xray_data = XrayData.build(bands, annuli, table, dtype=dtype,
                               device=device)
    params = build_reference_params(pressure, density, temperature,
                                    Z_solar=xr["Z_solar"],
                                    edges_logkpc=annuli.edges_logkpc)
    return JointModel(pressure=pressure, density=density,
                      temperature=temperature, params=params,
                      sz_data=sz_data, xray_data=xray_data,
                      exclude_unphysical_mass=cfg["exclude_unphysical_mass"])
