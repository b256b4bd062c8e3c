"""The benchmark's datasets, made from ``--seed`` by the frozen float64
forward model (``reference.model``), never by the program.

A configuration file (``configs/<name>.json``) gives the cluster's
geometry and instrument (``cluster``), the model family (``model``), the
parameter values the data are drawn at (``truth``) and the seed of their
noise (``data_seed``): one cluster is one fixed dataset, and a run's
``--seed`` draws the sampler's start, its Philox streams and a survey's
mock clusters.  The synthetic
instrument follows the CL J1226.9+3332 fit's shapes: a Gaussian beam, a
smooth transfer function, a linear conversion table, SZ errors of 0.03 to
0.05 mJy/beam, the bands' annuli out to 4 arcmin widening outwards, 3e5 s
exposures and a flat background.  The data are the model's prediction at
the truth plus Gaussian SZ noise and Poisson counts.  Files are written in
the layout the program's ``JoXSZConfig`` reads, and the same files feed
the program and the reference."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .model.build import build_model

REPO = pathlib.Path(__file__).resolve().parents[2]


def _write_files(root: pathlib.Path, cl: dict, counts=None, flux=None):
    """The dataset's files under ``root``; placeholder data where
    ``counts`` / ``flux`` are None.  Returns the SZ errors."""
    (root / "SZ").mkdir(parents=True, exist_ok=True)
    (root / "X").mkdir(parents=True, exist_ok=True)
    n_sz, r_max, n_ann = cl["n_sz"], cl["max_radius_arcsec"], cl["n_annuli"]
    r_sz = np.linspace(r_max / n_sz, r_max, n_sz)
    err = 0.03 + 0.02 * r_sz / r_max
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
    edges = 4.0 * (np.arange(n_ann + 1) / n_ann) ** 1.4
    mid = 0.5 * (edges[1:] + edges[:-1])
    hw = 0.5 * (edges[1:] - edges[:-1])
    geom_area = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
    for bi, (lo, hi) in enumerate(cl["bands_eV"]):
        area = geom_area * (0.93 + 0.04 * np.cos(np.arange(n_ann) + bi))
        expo = np.full(n_ann, 3.0e5)
        back = np.full(n_ann, 8.0e-5 * (hi - lo) / 1000.0)
        c = np.ones(n_ann) if counts is None else counts[bi]
        np.savetxt(root / "X" / f"fg_{lo:04d}_{hi:04d}.dat",
                   np.column_stack([mid, hw, c, area, expo]))
        np.savetxt(root / "X" / f"bg_{lo:04d}_{hi:04d}.dat",
                   np.column_stack([mid, hw, np.zeros(n_ann), area, back]))
    return err


def config_dict(config: dict, root: pathlib.Path) -> dict:
    """The dataset's configuration in the program's ``JoXSZConfig`` JSON
    layout (the fields this benchmark sets; the rest keep their
    defaults)."""
    cl, m = config["cluster"], config["model"]
    return {
        "step_arcsec": cl["step_arcsec"],
        "cluster_extent_kpc": cl["cluster_extent_kpc"],
        "redshift": cl["redshift"], "H0": cl["H0"], "WM": cl["WM"],
        "WV": cl["WV"],
        "pressure_model": m["pressure_model"],
        "n_pressure_knots": m["n_pressure_knots"],
        "temperature_model": m["temperature_model"],
        "density_mode": m["density_mode"],
        "exclude_unphysical_mass": m["exclude_unphysical_mass"],
        "sz": {"tf_file": str(root / "SZ" / "tf.dat"),
               "flux_file": str(root / "SZ" / "flux.dat"),
               "conversion_file": str(root / "SZ" / "conv.dat"),
               "beam_approx": True,
               "fwhm_beam_arcsec": cl["fwhm_beam_arcsec"]},
        "xray": {"fg_template": str(root / "X" / "fg_%04i_%04i.dat"),
                 "bg_template": str(root / "X" / "bg_%04i_%04i.dat"),
                 "bands_eV": [list(b) for b in cl["bands_eV"]],
                 "NH_1022pcm2": cl["NH_1022pcm2"], "Z_solar": cl["Z_solar"],
                 "table_path": str(REPO / cl["table"])},
    }


def truth_vector(config: dict, names) -> np.ndarray:
    """The configuration's truth in the order of the thawed ``names``."""
    return np.array([config["truth"][n] for n in names], dtype=np.float64)


def predict(model, thetas) -> tuple[np.ndarray, np.ndarray]:
    """Noiseless SZ fluxes (B, n_sz) and X-ray counts (B, n_band, n_ann)
    of the model at the rows of ``thetas``, in float64."""
    th = torch.as_tensor(np.atleast_2d(thetas), dtype=torch.float64)
    with torch.no_grad():
        flux = (model.sz_profile(th) @ model.sz_data.G.T).numpy()
        counts = model.xray_profiles(th).numpy()
    return flux, counts


def draw(model, flux, counts, rng: np.random.Generator):
    """Gaussian SZ noise and Poisson counts around the predictions."""
    err = model.sz_data.flux_err.numpy()
    return (flux + err * rng.standard_normal(flux.shape),
            rng.poisson(counts).astype(float))


def write_dataset(config: dict, root):
    """Write the configuration's dataset, drawn at its truth with the
    noise of its ``data_seed``, under ``root``.  Returns ``(path of the configuration JSON,
    the float64 reference model of the placeholder files (the
    instrument, for mock surveys), the truth vector)``."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(config["data_seed"])
    cl = config["cluster"]
    _write_files(root, cl)
    cfg = config_dict(config, root)
    base = build_model(cfg)
    theta = truth_vector(config, base.params.thawed)
    flux, counts = draw(base, *predict(base, theta[None]), rng)
    _write_files(root, cl, counts=counts[0], flux=flux[0])
    path = root / "cfg.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path, base, theta


def survey_truths(names, truth: np.ndarray, C: int) -> np.ndarray:
    """(C, D) injected truths of a mock survey: ``truth`` with P_0 (for
    knot pressure every knot value in log) spread by x0.7..1.3 and beta
    by -0.03..0.03 over the clusters (the spreads of the program's mock
    survey)."""
    names = list(names)
    truths = np.tile(truth, (C, 1))
    scale = np.linspace(0.7, 1.3, C)
    if "P_0" in names:
        truths[:, names.index("P_0")] *= scale
    else:
        knots = [i for i, n in enumerate(names) if n.startswith("logP_")]
        truths[:, knots] += np.log10(scale)[:, None]
    if "\\beta" in names:
        truths[:, names.index("\\beta")] += np.linspace(-0.03, 0.03, C)
    return truths
