"""Port parity: hierarchical population inference (``sampling/population.py``).

* ``make_population_log_like`` and ``weight_n_eff`` against
  ``joxsz_tpu.sampling.population`` on the same stage-1 samples, in
  float64 at 1e-10 relative: gaussian and lognormal families, flat and
  Gaussian interim priors, a truncated support, explicit interim log p0;
* the checks of ``tests/test_population.py``: the sampled hyper-posterior
  against direct 2-D grid integration of the same hyper-likelihood (flat
  interim, truncated support, Gaussian interim), the lognormal family as
  its gaussian-in-ln-theta equivalent, the thin-overlap warning and the
  model's validation; plus ``population_from_survey`` on a survey result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.sampling.population import (PopulationModel,
                                             fit_population,
                                             make_population_log_like,
                                             population_from_survey,
                                             weight_n_eff)
from joxsz_tpu.sampling import population as jpop

from test_population import MU_TRUE, TAU_TRUE, _stage1_samples

MU_RNG, LSIG_RNG = (1.5, 2.5), (np.log(0.05), np.log(1.0))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU tests run torch on one thread: the population fit's plain
    loop of small batched ops slowed ~200x under the suite's six
    parallel workers with torch's default thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phis():
    return np.array([[2.0, np.log(0.3)], [1.6, np.log(0.06)],
                     [2.4, np.log(0.9)], [5.0, np.log(0.01)],
                     [-3.0, np.log(2.0)]])


def _cases():
    x = _stage1_samples(C=6, S=128, seed=4)
    pos = np.exp(x / 2.0)
    sup = (1.8, 2.3)
    xt = _stage1_samples(C=6, S=128, support=sup, seed=2)
    return {
        "gaussian_flat": (x, dict(param="t", family="gaussian",
                                  support=(-10.0, 10.0)), None),
        "gaussian_truncated": (xt, dict(param="t", family="gaussian",
                                        support=sup), None),
        "gaussian_interim": (x, dict(param="t", family="gaussian",
                                     support=(-10.0, 10.0),
                                     interim=(2.0, 0.5)), None),
        "lognormal": (pos, dict(param="t", family="lognormal",
                                support=(0.0, np.inf)), None),
        "lognormal_bounded": (pos, dict(param="t", family="lognormal",
                                        support=(float(pos.min()) * 0.5,
                                                 float(pos.max()) * 2.0)),
                              None),
        "explicit_interim": (x, dict(param="t", family="gaussian",
                                     support=(-10.0, 10.0)), np.log1p(x ** 2)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_hyper_likelihood_matches_jax(case):
    x, kw, lp0 = _cases()[case]
    phi = _phis()
    if kw["family"] == "lognormal":
        phi[:, 0] = np.log(np.median(x)) + np.array([0.0, -0.3, 0.3, 2.0,
                                                     -2.0])
    a = make_population_log_like(x, PopulationModel(**kw),
                                 interim_logp=lp0, device="cpu")(
        torch.tensor(phi)).numpy()
    b = np.asarray(jpop.make_population_log_like(
        x, jpop.PopulationModel(**kw), interim_logp=lp0)(jnp.asarray(phi)))
    assert a.dtype == np.float64 and b.dtype == np.float64
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)


@pytest.mark.parametrize("case", list(_cases()))
def test_weight_n_eff_matches_jax(case):
    x, kw, lp0 = _cases()[case]
    phi = (float(np.log(np.median(x))) if kw["family"] == "lognormal"
           else 2.0, np.log(0.3))
    a = weight_n_eff(x, PopulationModel(**kw), phi, interim_logp=lp0)
    b = jpop.weight_n_eff(x, jpop.PopulationModel(**kw), phi,
                          interim_logp=lp0)
    assert a.shape == (x.shape[0],)
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)


def _grid_moments(samples, model, mu_rng, lsig_rng, interim_logp=None,
                  n=120):
    """Direct quadrature of the hyper-posterior (flat hyperpriors on mu
    and log sigma over the given ranges): posterior medians and sds of mu
    and of sigma (``tests/test_population.py``)."""
    ll = make_population_log_like(samples, model, interim_logp=interim_logp,
                                  device="cpu")
    mg = np.linspace(*mu_rng, n)
    lg = np.linspace(*lsig_rng, n)
    phi = np.stack(np.meshgrid(mg, lg, indexing="ij"), -1).reshape(-1, 2)
    lp = np.concatenate([ll(torch.tensor(phi[i:i + n])).numpy()
                         for i in range(0, phi.shape[0], n)]).reshape(n, n)
    w = np.exp(lp - lp.max())
    w /= w.sum()

    def _med(grid, marg):
        return float(np.interp(0.5, np.cumsum(marg), grid))

    mu_marg, sig_marg = w.sum(axis=1), w.sum(axis=0)
    mu_sd = np.sqrt((mu_marg * (mg - (mu_marg * mg).sum()) ** 2).sum())
    sig = np.exp(lg)
    sig_sd = np.sqrt((sig_marg * (sig - (sig_marg * sig).sum()) ** 2).sum())
    return _med(mg, mu_marg), mu_sd, _med(sig, sig_marg), sig_sd


def _fit(samples, model, mu_rng, lsig_rng, **kw):
    return fit_population(samples, model, mu_bounds=mu_rng,
                          log_sigma_bounds=lsig_rng, n_walkers=64,
                          n_burn=200, n_steps=800, thin=5, seed=3,
                          device="cpu", **kw)


def test_population_matches_grid_flat_interim():
    x = _stage1_samples(seed=5)
    model = PopulationModel("theta", "gaussian", support=(-10.0, 10.0))
    mu_m, mu_sd, sig_m, sig_sd = _grid_moments(x, model, MU_RNG, LSIG_RNG)
    res = _fit(x, model, MU_RNG, LSIG_RNG)
    assert abs(res.mu - mu_m) < 0.25 * mu_sd
    assert abs(res.sigma - sig_m) < 0.3 * sig_sd
    assert abs(res.mu - MU_TRUE) < 4 * res.mu_sd
    assert 0.4 * TAU_TRUE < res.sigma < 2.0 * TAU_TRUE
    assert res.n_eff_weights.min() > 30
    assert res.chain.shape == (160, 64, 2)


def test_population_matches_grid_truncated():
    support = (1.8, 2.3)
    x = _stage1_samples(support=support, seed=2)
    model = PopulationModel("theta", "gaussian", support=support)
    mu_m, mu_sd, sig_m, sig_sd = _grid_moments(
        x, model, MU_RNG, (np.log(0.05), np.log(2.0)))
    res = _fit(x, model, MU_RNG, (np.log(0.05), np.log(2.0)))
    assert abs(res.mu - mu_m) < 0.3 * mu_sd
    assert abs(res.sigma - sig_m) < 0.35 * sig_sd


def test_population_matches_grid_gaussian_interim():
    x = _stage1_samples(seed=3)
    model = PopulationModel("theta", "gaussian", support=(-10.0, 10.0),
                            interim=(2.0, 0.5))
    mu_m, mu_sd, sig_m, sig_sd = _grid_moments(x, model, MU_RNG, LSIG_RNG)
    res = _fit(x, model, MU_RNG, LSIG_RNG)
    assert abs(res.mu - mu_m) < 0.3 * mu_sd
    assert abs(res.sigma - sig_m) < 0.35 * sig_sd
    flat = PopulationModel("theta", "gaussian", support=(-10.0, 10.0))
    mu_f, _, sig_f, _ = _grid_moments(x, flat, MU_RNG, LSIG_RNG)
    assert abs(mu_f - mu_m) > 1e-4 or abs(sig_f - sig_m) > 1e-4


def test_lognormal_equals_gaussian_in_log():
    x = np.exp(_stage1_samples(C=6, S=128) / 2.0)
    sup = (float(x.min()) * 0.5, float(x.max()) * 2.0)
    ll_ln = make_population_log_like(
        x, PopulationModel("theta", "lognormal", support=sup), device="cpu")
    ll_g = make_population_log_like(
        np.log(x), PopulationModel("theta", "gaussian",
                                   support=(np.log(sup[0]),
                                            np.log(sup[1]))),
        interim_logp=np.log(x), device="cpu")
    phi = torch.tensor([[0.5, np.log(0.3)], [0.8, np.log(0.1)],
                        [0.2, np.log(1.0)]])
    np.testing.assert_allclose(ll_ln(phi).numpy(), ll_g(phi).numpy(),
                               rtol=1e-12)


def test_weight_n_eff_and_thin_overlap_warning():
    x = _stage1_samples(C=4, S=256)
    model = PopulationModel("theta", "gaussian", support=(-10.0, 10.0))
    n_eff = weight_n_eff(x, model, (MU_TRUE, np.log(1.0)))
    assert n_eff.shape == (4,) and np.all(n_eff > 1)
    with pytest.warns(UserWarning, match="n_eff"):
        fit_population(x, model, mu_bounds=(4.9, 5.1),
                       log_sigma_bounds=(np.log(0.005), np.log(0.01)),
                       n_walkers=16, n_burn=20, n_steps=40, thin=2,
                       seed=0, device="cpu")


def test_population_model_validation():
    with pytest.raises(ValueError, match="family"):
        PopulationModel("x", "weibull")
    with pytest.raises(ValueError, match="positive"):
        PopulationModel("x", "lognormal", support=(-1.0, 2.0))
    x = _stage1_samples(C=3, S=64)
    model = PopulationModel("theta", "gaussian")
    with pytest.raises(ValueError, match="interim_logp"):
        make_population_log_like(x, model, interim_logp=np.zeros((3, 8)),
                                 device="cpu")
    xz = np.abs(x) + 0.1
    xz[1, 3] = 0.0
    ln = PopulationModel("theta", "lognormal", support=(0.0, 100.0))
    with pytest.raises(ValueError, match="strictly"):
        make_population_log_like(xz, ln, device="cpu")
    with pytest.raises(ValueError, match="strictly"):
        weight_n_eff(xz, ln, (0.0, 0.0))
    with pytest.raises(ValueError, match="2 clusters"):
        fit_population(x[:1], model, n_walkers=8, n_burn=0, n_steps=10,
                       device="cpu")


def test_population_from_survey_uses_the_param_box_and_interim():
    """Stage 2 from a survey-shaped result: the modelled column, its box
    and Gaussian interim from the ParamSet, equal draws per cluster."""
    from types import SimpleNamespace

    rng = np.random.default_rng(7)
    C, n_saved, W = 4, 20, 16
    chain = np.empty((n_saved, C, W, 2))
    chain[..., 0] = rng.normal(0.0, 1.0, (n_saved, C, W))
    chain[..., 1] = np.exp(rng.normal(np.log(0.05), 0.1, (n_saved, C, W))
                           + np.linspace(-0.2, 0.2, C)[None, :, None])
    result = SimpleNamespace(
        param_names=["a", "P_0"], cluster_names=[f"c{i}" for i in range(C)],
        flat_chain=lambda c: chain[:, c].reshape(-1, 2))
    params = SimpleNamespace(thawed=["a", "P_0"],
                             lo=np.array([-5.0, 1e-4]),
                             hi=np.array([5.0, 1.0]),
                             is_gauss=np.array([True, False]),
                             mu=np.array([0.0, 0.0]),
                             sigma=np.array([1.0, 1.0]))
    res = population_from_survey(result, params, "P_0", max_samples=200,
                                 n_walkers=16, n_burn=50, n_steps=100,
                                 thin=5, device="cpu")
    assert res.model.support == (1e-4, 1.0) and res.model.interim is None
    assert res.n_samples == 200
    assert abs(res.mu - np.log(0.05)) < 0.3
    ga = population_from_survey(result, params, "a", family="gaussian",
                                max_samples=200, n_walkers=16, n_burn=20,
                                n_steps=40, thin=5, device="cpu")
    assert ga.model.interim == (0.0, 1.0)
    with pytest.raises(ValueError, match="not in fitted"):
        population_from_survey(result, params, "b", device="cpu")
