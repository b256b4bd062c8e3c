"""The six figures (``joxsz_torch.plotting``) against
``joxsz_tpu.plotting``, and the figure path of the CLI.

  * each figure function of both packages draws the same small inputs
    (``fit_on_data`` each package's session of the small synthetic
    dataset): the same PDF file names, each a valid PDF with the same
    page count;
  * ``run --postprocess CHAIN`` (with figures) on the small synthetic
    dataset writes all six PDFs under the JAX package's names, for the
    flagship and for SZ-only (no X-ray panels, no cooling time).
"""

import re

import numpy as np
import pytest
import torch

from joxsz_torch import plotting as tplot
from joxsz_torch import run
from joxsz_torch.build import build_session
from joxsz_torch.cosmology import Cosmology
from joxsz_torch.io.checkpoint import save_chain
from joxsz_torch.postproc.profiles import ProfileSet
from joxsz_torch.synth import TRUTH, config_json
from joxsz_tpu import plotting as jplot
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.config import JoXSZConfig as JaxConfig
from joxsz_tpu.cosmology import Cosmology as JaxCosmology

from test_torch_build import small_config

SIX = {"traceplot.pdf", "cornerplot.pdf", "fit_on_data.pdf",
       "radial_profiles.pdf", "mass_hse.pdf", "frac_gas.pdf"}


def pages(path) -> int:
    data = path.read_bytes()
    assert data.startswith(b"%PDF") and len(data) > 1000
    return len(re.findall(rb"/Type\s*/Page[^s]", data))


def _bands(mid, spread=0.1):
    return np.stack([mid * (1 - spread), mid, mid * (1 + spread)])


def _draw_all(pkg, cosmo, out):
    rng = np.random.default_rng(0)
    cube = rng.normal(size=(12, 40, 5))
    names = ["a", "b", "c", "d", "e"]
    pkg.traceplot(cube, names, seed=0, plotdir=str(out))
    pkg.cornerplot(cube.reshape(-1, 5), names, plotdir=str(out))
    r = np.geomspace(20, 3000, 80)
    profs = ProfileSet(
        r_kpc=r, density=_bands(2e-2 * (r / 100.0) ** -1.2),
        temp_sz=_bands(6 + 0 * r), temp_x=_bands(6.5 + 0 * r),
        pressure=_bands(0.1 * (r / 100.0) ** -2.0),
        entropy=_bands(100 * (r / 100.0) ** 1.1),
        cooling_time=_bands(1e9 * (r / 100.0) ** 1.5),
        gas_mass=_bands(1e12 * (r / 100.0) ** 1.8),
        gas_fraction=_bands(0.1 + 0 * r))
    pkg.radial_profiles(profs, tempx_differs=True, plotdir=str(out))
    pkg.mass_plot(r, _bands(1e13 * (r / 100.0) ** 1.2), cosmo,
                  r_delta=np.array([700.0, 750.0, 800.0]),
                  m_delta=np.array([3e14, 3.5e14, 4e14]), plotdir=str(out))
    pkg.gas_fraction_plot(r, profs.gas_fraction, plotdir=str(out))


def test_figures_match_the_jax_package(tmp_path):
    cfg = small_config(tmp_path / "data")
    jc = JaxConfig.from_json(cfg.to_json())
    sessions = {"torch": build_session(cfg, device="cpu"),
                "jax": jax_build_session(jc, use_cache=False)}
    for pkg, cosmo, sub in ((tplot, Cosmology(z=0.888), "torch"),
                            (jplot, JaxCosmology(z=0.888), "jax")):
        (tmp_path / sub).mkdir()
        _draw_all(pkg, cosmo, tmp_path / sub)
        sess = sessions[sub]
        n_band, n_ann = len(sess.bands), len(sess.annuli.edges_arcmin) - 1
        n_pix = sess.sz_operator.L.shape[0]
        pkg.fit_on_data(sess.bands, sess.annuli, sess.model.sz_data,
                        _bands(np.full((n_band, n_ann), 50.0)),
                        _bands(np.linspace(-1.0, 0.0, n_pix)),
                        plotdir=str(tmp_path / sub))
    names = {p.name for p in (tmp_path / "torch").iterdir()}
    assert names == {p.name for p in (tmp_path / "jax").iterdir()}
    assert names == SIX
    for n in names:
        assert pages(tmp_path / "torch" / n) == pages(tmp_path / "jax" / n)


@pytest.mark.parametrize("flags", [(), ("--sz-only",)],
                         ids=["flagship", "sz_only"])
def test_postprocess_draws_the_six_figures(tmp_path, flags):
    cfg = small_config(tmp_path / "data")
    cfg.save_dir = cfg.plot_dir = str(tmp_path / "out")
    path = config_json(cfg, tmp_path / "cfg.json")
    args = run.build_parser().parse_args(list(flags))
    sess = build_session(cfg, device="cpu", sz_only=args.sz_only)
    names = sess.params.thawed
    th = np.array([TRUTH[n] for n in names])
    rng = np.random.default_rng(1)
    chain = th * (1 + 0.01 * rng.standard_normal((12, 16, th.size)))
    lp = sess.model.log_like_batch(
        torch.tensor(chain.reshape(-1, th.size))).numpy()
    save_chain(str(tmp_path / "c.npz"), chain, lp.reshape(12, 16),
               np.full(16, 0.3), names, 100, 5)
    run.main(["--config", path, "--cpu", "--postprocess",
              str(tmp_path / "c.npz"), *flags])
    out = tmp_path / "out"
    assert {p.name for p in out.glob("*.pdf")} == SIX
    assert (out / "joxsz_summary.json").is_file()
    # four parameters a page
    assert pages(out / "traceplot.pdf") == -(-len(names) // 4)
