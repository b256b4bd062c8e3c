"""``joxsz_torch.synth``: the synthetic datasets every port test and
``chip_smoke.py`` phase draws on.

Its default arguments write byte for byte what they wrote before the
geometry and model-family arguments existed (digests of every file and
of the config, seed 3, at the CL J1226 shapes and on the synthetic
response), so no other test's data move.  The new arguments reach the
config and the files: another cluster's geometry and table (nT, NH) on
the synthetic response, a model family's fields, the generated table
kept and named; the CLI takes the same as flags.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from joxsz_torch import synth
from joxsz_torch.build import build_session
from joxsz_torch.config import JoXSZConfig
from joxsz_torch.synth import (bands_between, main, truth_theta,
                               write_synthetic_dataset)

# sha256 of the sorted "path sha256" lines of every file written and of
# the config's JSON (the dataset's root replaced by ROOT, the repository's
# by REPO), before the geometry arguments were added
DIGESTS = {
    "cl1226": "a6c56d62c93f11e2e842bda3d27c40deb3b6b019730278f049c6275831da8bd5",
    "response":
        "db1c8c1a0eac07abfb15f1683678f1dd83cfb685eefa9d56f1033b0bd934fed5",
}
RESPONSE = dict(response=True, redshift=0.5, n_annuli=6, n_sz=6,
                max_radius_arcsec=30.0, extent_kpc=800.0)


def digest(root: pathlib.Path, cfg) -> str:
    lines = [f"{p.relative_to(root).as_posix()} "
             f"{hashlib.sha256(p.read_bytes()).hexdigest()}"
             for p in sorted(root.rglob("*")) if p.is_file()]
    lines.append(cfg.to_json().replace(str(root.resolve()), "ROOT")
                 .replace(str(synth.REPO), "REPO"))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


@pytest.mark.parametrize("case", sorted(DIGESTS))
def test_defaults_write_the_same_files(tmp_path, case):
    cfg = write_synthetic_dataset(
        str(tmp_path), 3, **(RESPONSE if case == "response" else {}))
    assert digest(tmp_path, cfg) == DIGESTS[case]


def test_bands_between():
    bands = bands_between(12)
    assert len(bands) == 12 and bands[0][0] == 700 and bands[-1][1] == 7000
    assert all(a < b == c for (a, b), (c, _) in zip(bands, bands[1:]))
    with pytest.raises(ValueError, match="do not fit"):
        bands_between(60)


@pytest.mark.parametrize("kw", [dict(nT=32), dict(nh_1022=0.03),
                                dict(keep_table=True)])
def test_table_arguments_need_the_response(tmp_path, kw):
    with pytest.raises(ValueError, match="response"):
        write_synthetic_dataset(str(tmp_path), 3, **kw)


def test_geometry_and_family_reach_the_files(tmp_path):
    """A knot-pressure cluster at z = 0.25 on 6" pixels, 4 bands x 7
    annuli, an nT = 32 table at NH 0.03 kept beside the data: the config
    carries them, both the table and the data read back at those sizes,
    and the data are drawn at the family's truth."""
    bands = bands_between(4)
    cfg = write_synthetic_dataset(
        str(tmp_path), 5, n_annuli=7, n_sz=9, max_radius_arcsec=150.0,
        extent_kpc=1500.0, redshift=0.25, bands=bands, response=True,
        nT=32, step_arcsec=6.0, fwhm_arcsec=20.0, nh_1022=0.03,
        pressure_model="knots", n_pressure_knots=5, line_systematic=True,
        keep_table=True)
    assert (cfg.step_arcsec, cfg.sz.fwhm_beam_arcsec) == (6.0, 20.0)
    assert (cfg.pressure_model, cfg.n_pressure_knots) == ("knots", 5)
    assert cfg.xray.line_systematic and cfg.xray.NH_1022pcm2 == 0.03
    assert cfg.xray.table_path == str(tmp_path / "X" / "synthetic_ctrate.npz")
    assert json.loads(bytes(np.load(cfg.xray.table_path)["meta"]).decode())[
        "NH_1022pcm2"] == 0.03
    sess = build_session(cfg, device="cpu")
    xr = sess.model.xray_data
    assert xr.table.Tlog.shape == (32,) and xr.counts_mask.shape == (4, 7)
    assert "logP_4" in sess.params.thawed and "line_scale" in sess.params.thawed
    from joxsz_torch.models.xray import predicted_counts

    pars = sess.params.unpack(torch.tensor(truth_theta(sess)[None]))
    m = sess.model
    pred = float(predicted_counts(pars, m.xray_data, m.density,
                                  m.temperature).sum())
    assert abs(float(xr.counts_filled.sum()) - pred) < 5 * pred ** 0.5


def test_cli_writes_another_cluster(tmp_path, capsys):
    out = tmp_path / "syn"
    main([str(out), "--seed", "4", "--redshift", "0.4", "--n-annuli", "5",
          "--n-bands", "3", "--n-sz", "7", "--max-radius", "90",
          "--extent-kpc", "1500", "--step", "5", "--fwhm", "16",
          "--response", "--keep-table", "--nT", "32", "--nh", "0.02",
          "--temperature", "vikhlinin", "--density", "double"])
    path = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = JoXSZConfig.from_json(pathlib.Path(path).read_text())
    assert (cfg.redshift, cfg.step_arcsec, cfg.sz.fwhm_beam_arcsec) == (
        0.4, 5.0, 16.0)
    assert (cfg.temperature_model, cfg.density_mode) == ("vikhlinin",
                                                         "double")
    assert [list(b) for b in cfg.xray.bands_eV] == [
        list(b) for b in bands_between(3)]
    assert pathlib.Path(cfg.xray.table_path).exists()
    assert cfg.mcmc.nwalkers == 1024 and cfg.save_dir == str(out.resolve())
    with pytest.raises(SystemExit, match="response"):
        main([str(tmp_path / "bad"), "--nT", "32"])
