"""Port parity: the fused batched likelihood and the plain samplers.

* ``JointModel.log_like_batch_fused`` against the port's own
  ``log_like_batch`` and against the JAX package's ``log_like_batch_fused``
  (its jnp SZ core): float64, rtol 1e-9, identical veto masks, with and
  without the integrated-Y term;
* ``run_ensemble`` and ``run_tempered_ensemble`` sample a known Gaussian
  to mean and variance;
* ``run_fit`` takes ``log_like_batch=`` and ``step_sampler=None`` with the
  precedence of the JAX package's ``run_fit``;
* ``python -m joxsz_torch.run --fused --no-step-kernel --cpu --quick`` end
  to end on a small synthetic dataset.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch import run
from joxsz_torch.build import build_session
from joxsz_torch.io.readers import read_conversion_table, read_xy
from joxsz_torch.ops.sz_core import sz_core
from joxsz_torch.sampling.driver import run_fit
from joxsz_torch.sampling.stretch import run_ensemble, validate_schedule
from joxsz_torch.sampling.tempered import run_tempered_ensemble
from joxsz_torch.synth import config_json
from joxsz_tpu.io.readers import (read_conversion_table as j_read_conv,
                                  read_xy as j_read_xy)

from test_torch_build import jax_session, small_config
from test_torch_models import veto_rows


def _fused_pair(cfg):
    sess = build_session(cfg, device="cpu")
    js = jax_session(cfg)
    conv = read_conversion_table(cfg.sz.conversion_file)
    flux = read_xy(cfg.sz.flux_file, ncol=3)
    fused = sess.model.log_like_batch_fused(conv, flux, sess.sz_operator)
    jfused = jax.jit(js.model.log_like_batch_fused(
        j_read_conv(cfg.sz.conversion_file), j_read_xy(cfg.sz.flux_file, 3),
        js.sz_operator, use_pallas=False, dtype=jnp.float64))
    return sess, fused, jfused


@pytest.mark.parametrize("calc_integ", [False, True])
def test_fused_matches_unfused_and_jax(tmp_path, calc_integ):
    cfg = small_config(tmp_path)
    cfg.sz.calc_integ = calc_integ
    sess, fused, jfused = _fused_pair(cfg)
    rows = veto_rows(sess.params, n=20, seed=13)
    a = fused(torch.tensor(rows)).numpy()
    own = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    b = np.asarray(jfused(jnp.asarray(rows)))
    fin = np.isfinite(b)
    assert fin.sum() == rows.shape[0] - 4
    assert np.array_equal(np.isfinite(a), fin)
    assert np.array_equal(np.isfinite(own), fin)
    np.testing.assert_allclose(a[fin], own[fin], rtol=1e-9, atol=0)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)


def test_fused_nan_becomes_minus_inf(tmp_path):
    """A walker whose temperature is NaN (negative density normalisation
    under the root) gets -inf from the fused likelihood, not NaN."""
    cfg = small_config(tmp_path)
    sess = build_session(cfg, device="cpu")
    fused = sess.model.log_like_batch_fused(
        read_conversion_table(cfg.sz.conversion_file),
        read_xy(cfg.sz.flux_file, ncol=3), sess.sz_operator)
    rows = veto_rows(sess.params, n=4, seed=2)
    rows[0, sess.params.thawed.index("r_p")] = float("nan")
    out = fused(torch.tensor(rows))
    assert out[0] == -float("inf") and not bool(torch.isnan(out).any())
    before = sz_core.launches
    fused(torch.tensor(rows))
    assert sz_core.launches == before          # CPU tensors: no launch


# -- the plain samplers on a known Gaussian -----------------------------------

MU = np.array([1.0, -2.0, 0.5])
SD = np.array([0.5, 2.0, 1.0])


def _gauss(x):
    mu = torch.as_tensor(MU, dtype=x.dtype)
    sd = torch.as_tensor(SD, dtype=x.dtype)
    return -0.5 * (((x - mu) / sd) ** 2).sum(dim=-1)


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def test_run_ensemble_samples_a_gaussian():
    W = 64
    p0 = torch.tensor(MU + 0.1 * np.random.default_rng(0).standard_normal(
        (W, 3)))
    burn = run_ensemble(_gauss, p0, 200, _gen(1), store_chain=False)
    assert burn.chain.shape == (0, W, 3)
    res = run_ensemble(_gauss, burn.final_state[0], 1000, _gen(2), thin=5)
    assert res.chain.shape == (200, W, 3) and res.log_prob.shape == (200, W)
    flat = res.chain.reshape(-1, 3)
    # ~12800 draws thinned past the autocorrelation: mean to 0.1 sd,
    # sd to 10%
    np.testing.assert_allclose(flat.mean(axis=0), MU, atol=0.1 * SD.max())
    np.testing.assert_allclose(flat.std(axis=0), SD, rtol=0.1)
    assert 0.3 < res.acceptance_fraction.mean() < 0.8
    x, lp = res.final_state
    assert torch.equal(_gauss(x), lp)
    np.testing.assert_array_equal(res.chain[-1], x.numpy())
    # deterministic in the generator's seed
    again = run_ensemble(_gauss, burn.final_state[0], 10, _gen(2), thin=5)
    np.testing.assert_array_equal(again.chain[0], res.chain[0])


def test_run_tempered_ensemble_samples_a_gaussian():
    W, betas = 64, [1.0, 0.5, 0.25]
    p0 = torch.tensor(MU + 0.1 * np.random.default_rng(3).standard_normal(
        (W, 3)))
    warm = run_tempered_ensemble(_gauss, p0, betas, 200, _gen(4))
    res = run_tempered_ensemble(_gauss, warm.final_state[0], betas, 1000,
                                _gen(5), thin=5)
    assert res.chain.shape == (200, W, 3)
    assert res.acceptance_fraction.shape == (3, W)
    flat = res.chain.reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(axis=0), MU, atol=0.1 * SD.max())
    np.testing.assert_allclose(flat.std(axis=0), SD, rtol=0.1)
    # a rung at beta samples the Gaussian widened by 1/sqrt(beta)
    x, lp = res.final_state
    assert x.shape == (3, W, 3) and torch.equal(_gauss(x), lp)
    assert res.swap_acceptance.shape == (2,)
    assert np.all((res.swap_acceptance > 0.2) & (res.swap_acceptance < 1.0))
    hot = run_tempered_ensemble(_gauss, x, betas, 400, _gen(6)).final_state[0]
    assert hot[2].std(dim=0)[1] > 1.3 * hot[0].std(dim=0)[1]


def test_validate_schedule():
    validate_schedule(10, 5, 4)
    for bad in [(10, 3, 4), (0, 1, 4), (10, 0, 4), (10, 5, 3)]:
        with pytest.raises(ValueError):
            validate_schedule(*bad)


# -- run_fit and the CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fused")
    cfg = small_config(root / "data")
    cfg.save_dir = str(root / "out")
    return cfg, config_json(cfg, root / "cfg.json"), root / "out"


def test_run_fit_precedence(small, monkeypatch):
    """An explicit batched likelihood judges the initialisation; with no
    step sampler every sampling phase evaluates it too; with none given
    and no sampler, the model's own is used."""
    import joxsz_torch.sampling.driver as fit_module

    cfg, _, _ = small
    sess = build_session(cfg, device="cpu")
    p = sess.params
    monkeypatch.setattr(fit_module, "find_mle", lambda *a, **k: (
        p.thawed_values(), float(sess.model.log_like(torch.tensor(
            p.thawed_values())))))
    calls = {"n": 0}

    def counted(theta):
        calls["n"] += 1
        return sess.model.log_like_batch(theta)

    kw = dict(nwalkers=8, nburn=4, nsteps=10, nthin=5, seed=1,
              prelim_iterations=3, max_prelim_rounds=1, verbose=False)
    res = run_fit(sess.model, None, p.thawed_values(), p.lo, p.hi, p.thawed,
                  log_like_batch=counted, **kw)
    # 1 init + (3 + 4 + 10) steps x 2 half-steps + one lp0 per phase
    assert calls["n"] >= 1 + 2 * 17 + 3
    assert res.chain.shape == (2, 8, 13) and res.chain.dtype == np.float64
    assert np.all(np.isfinite(res.log_prob))
    calls["n"] = 0
    res = run_fit(sess.model, None, p.thawed_values(), p.lo, p.hi, p.thawed,
                  n_temper_rungs=2, **kw)
    assert calls["n"] == 0 and res.chain.shape == (2, 8, 13)
    assert len(res.timings["swap_acceptance"]) == 1


def test_run_fused_no_step_kernel_end_to_end(small):
    _, path, out = small
    res = run.main(["--config", path, "--cpu", "--quick", "--fused",
                    "--no-step-kernel", "--walkers", "32", "--seed", "6",
                    "--no-plots", "--fresh-mle"])
    assert res.chain.shape == (400 // 5, 32, 13)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    assert 0.05 < float(np.mean(res.acceptance_fraction)) < 0.9
    timings = json.loads((out / "joxsz_timings.json").read_text())
    assert timings["likelihood_evals"] > 0
    state = np.load(out / "joxsz_state.npz")
    assert state["positions"].shape == (32, 13)
    assert np.isfinite(res.mle_loglike)
    assert res.mle_loglike > float(res.log_prob.max()) - 5.0
