"""Port parity: the fit's files (``joxsz_torch.io.checkpoint``) against
``joxsz_tpu.io.checkpoint`` and ``joxsz_tpu.sampling.driver.run_fit``.

The JAX package's ``run_fit`` samples a small Gaussian posterior and
writes its chain (emcee's v3 HDF5 layout), ``fit.dat`` and resume state;
the port writes the same arrays:

  * the HDF5 datasets and attrs are identical (values, dtypes, names);
  * each package's reader opens the other's file, and the ``.npz`` twin
    the port writes where h5py is missing reads back to the same dict;
  * ``fit.dat`` is the same text, in both of its branches (the chain's
    best sample, or the MLE when that is better);
  * the state file round-trips through both packages' ``load_state``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from joxsz_torch.io import checkpoint as tck
from joxsz_torch.postproc.summary import chain_diagnostics_from_file
from joxsz_tpu.io import checkpoint as jck
from joxsz_tpu.postproc.summary import (chain_diagnostics_from_file as
                                        jax_chain_diagnostics)
from joxsz_tpu.sampling.driver import run_fit as jax_run_fit

NAMES = ["log(n_0)", r"\beta", "Z"]
MU = np.array([-1.8, 0.75, 0.3])
SD = np.array([0.05, 0.1, 0.08])


def _log_like(x):
    return -0.5 * jnp.sum(((x - MU) / SD) ** 2)


@pytest.fixture(scope="module", params=["chain_best", "mle_best"])
def jax_fit(request, tmp_path_factory):
    """A JAX ``run_fit`` writing all three files; started at the mode the
    MLE (no simplex: ``do_mle=False``) beats every sample."""
    out = tmp_path_factory.mktemp("jax_fit")
    theta0 = MU if request.param == "mle_best" else MU + 2 * SD
    res = jax_run_fit(
        _log_like, theta0, MU - 10 * SD, MU + 10 * SD, NAMES, nwalkers=8,
        nburn=10, nsteps=20, nthin=2, seed=3, prelim_iterations=10,
        max_prelim_rounds=1, do_mle=False, chain_path=str(out / "c.hdf5"),
        state_path=str(out / "s.npz"), best_path=str(out / "fit.dat"),
        verbose=False)
    return request.param, res, out


def test_fit_dat_text_identical(jax_fit, tmp_path):
    which, res, out = jax_fit
    tck.save_best_fit(str(tmp_path / "fit.dat"), res.chain, res.log_prob,
                      res.mle_theta, res.mle_loglike, NAMES)
    text = (tmp_path / "fit.dat").read_text()
    assert text == (out / "fit.dat").read_text()
    assert not (tmp_path / "fit.dat.tmp").exists()
    lines = text.splitlines()
    assert lines[0].startswith("likelihood = ")
    assert [ln.split(" = ")[0] for ln in lines[1:]] == sorted(NAMES)
    best_is_mle = res.mle_loglike >= float(res.log_prob.max())
    assert best_is_mle == (which == "mle_best")


def _h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        g = f["mcmc"]
        return ({k: np.asarray(g[k]) for k in g},
                {k: g.attrs[k] for k in g.attrs})


def test_hdf5_datasets_and_attrs_identical(jax_fit, tmp_path):
    _, res, out = jax_fit
    path = str(tmp_path / "c.hdf5")
    tck.save_chain_hdf5(path, res.chain, res.log_prob,
                        res.acceptance_fraction, NAMES, 10, 2)
    d_t, a_t = _h5(path)
    d_j, a_j = _h5(out / "c.hdf5")
    assert d_t.keys() == d_j.keys() == {"chain", "log_prob", "accepted"}
    for k in d_j:
        assert d_t[k].dtype == d_j[k].dtype
        np.testing.assert_array_equal(d_t[k], d_j[k])
    assert list(a_t) == list(a_j)
    for k in a_j:
        assert type(a_t[k]) is type(a_j[k]), k
        np.testing.assert_array_equal(a_t[k], a_j[k])


def test_each_reader_opens_the_others_file(jax_fit, tmp_path):
    _, res, out = jax_fit
    mine = str(tmp_path / "c.hdf5")
    tck.save_chain_hdf5(mine, res.chain, res.log_prob,
                        res.acceptance_fraction, NAMES, 10, 2,
                        frame_spacing=2.04)
    for path in (mine, str(out / "c.hdf5")):
        a, b = tck.load_chain_hdf5(path), jck.load_chain_hdf5(path)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert tck.load_chain(mine)["frame_spacing"] == 2.04
    assert tck.load_chain(str(out / "c.hdf5"))["burn"] == 10


def test_npz_twin_reads_back_as_the_hdf5(jax_fit, tmp_path):
    """Without h5py the chain goes to an .npz with the same datasets and
    attrs; ``load_chain`` reads either by its suffix."""
    _, res, _ = jax_fit
    args = (res.chain, res.log_prob, res.acceptance_fraction, NAMES, 10, 2)
    tck.save_chain(str(tmp_path / "c.hdf5"), *args)
    tck.save_chain(str(tmp_path / "c.npz"), *args)
    h, z = (tck.load_chain(str(tmp_path / f"c.{s}"))
            for s in ("hdf5", "npz"))
    assert h.keys() == z.keys()
    for k in h:
        np.testing.assert_array_equal(h[k], z[k])
    with np.load(tmp_path / "c.npz") as d:
        _, attrs = _h5(tmp_path / "c.hdf5")
        assert set(d.files) == {"chain", "log_prob", "accepted"} | set(attrs)


def test_chain_diagnostics_from_either_file(jax_fit, tmp_path):
    _, res, out = jax_fit
    tck.save_chain(str(tmp_path / "c.npz"), res.chain, res.log_prob,
                   res.acceptance_fraction, NAMES, 10, 2)
    a = chain_diagnostics_from_file(str(tmp_path / "c.npz"))
    b = jax_chain_diagnostics(str(out / "c.hdf5"))
    assert a.keys() == b.keys()
    np.testing.assert_allclose(a["tau_steps"], b["tau_steps"], rtol=1e-12)
    assert a["rhat"] == b["rhat"] and a["chain_steps"] == b["chain_steps"]
    assert a["param_names"] == b["param_names"] == NAMES


def test_state_file_both_ways(jax_fit, tmp_path):
    _, res, out = jax_fit
    j = jck.load_state(str(out / "s.npz"))
    t = tck.load_state(str(out / "s.npz"))
    assert j["meta"] == t["meta"] and j["meta"]["param_names"] == NAMES
    np.testing.assert_array_equal(j["positions"], t["positions"])
    ts = np.arange(24.0).reshape(2, 4, 3)
    tck.save_state(str(tmp_path / "s.npz"), ts[0], ts[0, :, 0],
                   np.array([7]), {"nburn": 3}, temper_state=ts)
    back = jck.load_state(str(tmp_path / "s.npz"))
    np.testing.assert_array_equal(back["temper_state"], ts)
    assert back["meta"] == {"nburn": 3} and int(back["key"][0]) == 7


def test_has_h5py_here():
    assert tck.has_h5py()
