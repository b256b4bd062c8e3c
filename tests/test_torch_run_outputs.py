"""The fit CLI's outputs and restart end to end on the CPU:
``python -m joxsz_torch.run --cpu --quick --walkers 32`` on the small
synthetic dataset (two tempering rungs, the kernels' plain versions).

  * the first run fits the MLE (a cache miss) and writes the chain
    (emcee's HDF5 layout), ``fit.dat``, the summary, the state and the
    timings; the MLE cache entry lands in the cache directory;
  * the same command again hits the cache and, from the same theta bit
    for bit, samples the same chain; ``--fresh-mle`` neither reads nor
    writes an entry;
  * ``--resume`` continues the saved two-rung ladder with no burn-in;
  * ``--postprocess CHAIN --ppc`` reproduces the summary and writes
    p-values in [0, 1]; a chain of other parameters is refused;
    ``--laplace`` runs the Laplace quick-look instead of sampling;
  * ``--move de`` / ``snooker`` sample on the plain sampler; without h5py
    the chain goes to ``<name>_chain.npz`` and ``--postprocess`` reads
    it; without matplotlib a run stops before sampling and asks for
    ``--no-plots``.

The cache directory is the test's own (``run.MLE_CACHE_DIR``).
"""

import importlib.util
import json

import numpy as np
import pytest

from joxsz_torch import run
from joxsz_torch.io import checkpoint
from joxsz_torch.io.checkpoint import load_chain, load_state
from joxsz_torch.sampling import driver, laplace
from joxsz_torch.synth import config_json

from test_torch_build import small_config

W = 32


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """(argv of a config whose outputs go to ``out/<name>``, the first
    run's result and output directory)."""
    root = tmp_path_factory.mktemp("torch_run_outputs")
    cfg = small_config(root / "data")
    mp = pytest.MonkeyPatch()
    mp.setattr(run, "MLE_CACHE_DIR", root / "cache")

    def argv(name, *extra):
        cfg.save_dir = cfg.plot_dir = str(root / "out" / name)
        path = config_json(cfg, root / f"{name}.json")
        return ["--config", path, "--cpu", "--quick", "--walkers", str(W),
                "--seed", "3", "--temper", "2", "--no-plots", *extra]

    first = run.main(argv("first"))
    yield argv, first, root
    mp.undo()


def test_first_run_writes_every_output(cli):
    argv, first, root = cli
    out = root / "out" / "first"
    for f in ("joxsz_chain.hdf5", "fit.dat", "joxsz_summary.json",
              "joxsz_state.npz", "joxsz_timings.json"):
        assert (out / f).is_file(), f
    assert not list(out.glob("*.pdf"))
    chain = load_chain(str(out / "joxsz_chain.hdf5"))
    assert chain["param_names"] == first.param_names
    np.testing.assert_array_equal(chain["chain"], first.chain)
    assert chain["burn"] == 200 and chain["thin"] == 5
    state = load_state(str(out / "joxsz_state.npz"))
    assert state["temper_state"].shape == (2, W, 13)
    timings = json.loads((out / "joxsz_timings.json").read_text())
    assert timings["mle_cached"] is False and timings["postprocess_s"] > 0
    assert len(list((root / "cache").glob("mle_torch_*.json"))) == 1
    summary = json.loads((out / "joxsz_summary.json").read_text())
    assert list(summary["parameters"]) == first.param_names
    assert (out / "fit.dat").read_text().startswith("likelihood = ")


def test_second_run_hits_the_cache(cli):
    argv, first, root = cli
    second = run.main(argv("second"))
    assert second.timings["mle_cached"] is True
    assert np.array_equal(second.mle_theta, first.mle_theta)
    np.testing.assert_array_equal(second.chain, first.chain)


def test_fresh_mle_neither_reads_nor_writes(cli, monkeypatch):
    argv, first, root = cli
    calls = []

    def fit(model, theta0, lo, hi, **kw):
        calls.append(1)
        return first.mle_theta, first.mle_loglike

    monkeypatch.setattr(driver, "find_mle", fit)
    before = sorted((root / "cache").iterdir())
    res = run.main(argv("fresh", "--fresh-mle"))
    assert calls == [1] and "mle_cached" not in res.timings
    assert sorted((root / "cache").iterdir()) == before


def test_resume_continues_the_ladder(cli, capsys):
    argv, first, root = cli
    capsys.readouterr()
    state = root / "out" / "first" / "joxsz_state.npz"
    res = run.main(argv("resumed", "--resume", str(state)))
    assert "resuming the full 2-rung replica ladder" in capsys.readouterr().out
    t = res.timings
    assert t["prelim_rounds"] == 0 and t["burn_s"] < 1.0
    assert t["likelihood_evals"] == 400 * 2 * W
    assert res.chain.shape == (400 // 5, W, 13)


def test_postprocess_reproduces_the_summary(cli):
    argv, first, root = cli
    chain = root / "out" / "first" / "joxsz_chain.hdf5"
    res = run.main(argv("post", "--postprocess", str(chain), "--ppc"))
    np.testing.assert_array_equal(res.chain, first.chain)
    out = root / "out"
    assert (json.loads((out / "post" / "joxsz_summary.json").read_text())
            == json.loads((out / "first" / "joxsz_summary.json")
                          .read_text()))
    ppc = json.loads((out / "post" / "joxsz_ppc.json").read_text())
    assert ppc["n_draws"] == 400
    assert 0.0 <= ppc["p_sz"] <= 1.0 and 0.0 <= ppc["p_xray"] <= 1.0


def test_postprocess_refuses_another_family(cli):
    argv, _, root = cli
    chain = root / "out" / "first" / "joxsz_chain.hdf5"
    with pytest.raises(SystemExit, match="model-family flags"):
        run.main(argv("wrong", "--postprocess", str(chain), "--pressure",
                      "knots"))


def test_laplace_is_refused(cli, monkeypatch):
    """``--laplace`` was refused until the Laplace quick-look was ported;
    now it runs the quick-look and writes ``<name>_laplace.json`` instead
    of a chain.  The MAP search is stubbed to return its start (the
    config's values): the CLI's path is what is checked here, the search
    in ``tests/test_torch_laplace.py``."""
    argv, _, root = cli
    monkeypatch.setattr(laplace, "find_mle", lambda model, theta0, lo, hi,
                        **kw: (np.asarray(theta0), float("nan")))
    res = run.main(argv("laplace", "--laplace"))
    out = root / "out" / "laplace"
    assert (out / "joxsz_laplace.json").is_file()
    assert not list(out.glob("joxsz_chain.*"))
    assert np.isfinite(res.log_post_map) and len(res.theta_map) == 13


@pytest.mark.parametrize("move", ["de", "snooker"])
def test_moves_on_the_plain_sampler(cli, capsys, move):
    argv, _, _ = cli
    capsys.readouterr()
    res = run.main(argv(move, "--move", move, "--temper", "1"))
    assert f"--move {move} runs on the plain sampler" in \
        capsys.readouterr().out
    assert res.chain.shape == (400 // 5, W, 13)
    assert np.all(np.isfinite(res.log_prob))
    # the DE moves accept little on this 13-parameter posterior at --quick
    # depth with 32 walkers (~0.02); a broken move accepts nothing
    assert 0.002 < float(np.mean(res.acceptance_fraction)) < 0.9
    assert np.ptp(res.chain[:, 0, 0]) > 0


def test_without_h5py_the_chain_is_an_npz(cli, monkeypatch, capsys):
    argv, first, root = cli
    monkeypatch.setattr(checkpoint, "has_h5py", lambda: False)
    res = run.main(argv("npz"))
    out = root / "out" / "npz"
    assert f"the chain goes to {out / 'joxsz_chain.npz'}" in \
        capsys.readouterr().out
    assert not (out / "joxsz_chain.hdf5").exists()
    saved = load_chain(str(out / "joxsz_chain.npz"))
    np.testing.assert_array_equal(saved["chain"], res.chain)
    post = run.main(argv("npz_post", "--postprocess",
                         str(out / "joxsz_chain.npz")))
    np.testing.assert_array_equal(post.chain, res.chain)


def test_without_matplotlib_a_run_asks_for_no_plots(cli, monkeypatch):
    argv, _, _ = cli
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))

    def no_fit(*a, **k):
        raise AssertionError("sampled without matplotlib")

    monkeypatch.setattr(driver, "run_fit", no_fit)
    args = [a for a in argv("noplots") if a != "--no-plots"]
    with pytest.raises(SystemExit, match="pass --no-plots"):
        run.main(args)
