"""Port parity: the evidence ladder (``joxsz_torch/sampling/
evidence.py``).

``power_betas`` and ``_logmeanexp`` equal the JAX package's; the
estimator function fed the JAX ladder's saved log-likelihoods reproduces
its ``log_z``, ``log_z_err`` and ``log_z_ti`` to 1e-10; the port's ladder
on the analytic Gaussian toy lands within 3 of its errors of the
analytic evidence and within 3 combined errors of the JAX ladder's, is
robust to zero-likelihood regions, and refuses a bad ladder; and
``model_evidence`` runs on the small synthetic joint model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from joxsz_torch.build import build_session
from joxsz_torch.sampling.evidence import (_logmeanexp, ladder_estimates,
                                           model_evidence, power_betas,
                                           run_evidence_ladder)
from joxsz_tpu.sampling import evidence as jax_evidence

from test_torch_build import single_thread, small_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def _gaussian_problem(ndim, prior_sigma, like_sigma, mu, xp):
    """Prior N(0, s^2 I) (normalized), likelihood N(mu, t^2 I); analytic
    Z = N(mu | 0, (s^2 + t^2) I).  ``xp``: torch or jax.numpy."""
    s2, t2 = prior_sigma ** 2, like_sigma ** 2
    mu = np.full(ndim, mu)

    def log_prior(x):
        return -0.5 * (x * x).sum(-1) / s2 - 0.5 * ndim * np.log(
            2 * np.pi * s2)

    def log_like(x):
        d = x - xp.asarray(mu)
        return -0.5 * (d * d).sum(-1) / t2 - 0.5 * ndim * np.log(
            2 * np.pi * t2)

    log_z = float(-0.5 * np.sum(mu ** 2) / (s2 + t2)
                  - 0.5 * ndim * np.log(2 * np.pi * (s2 + t2)))
    return log_prior, log_like, log_z


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def jax_toy():
    """The JAX ladder on the 3-dim toy (12 rungs x 64 walkers, 500 burn
    + 1500 steps, thin 5) and the analytic evidence."""
    lpri, llik, truth = _gaussian_problem(3, 3.0, 0.5, 1.0, jnp)
    p0 = 3.0 * jax.random.normal(jax.random.PRNGKey(1), (64, 3))
    res = jax_evidence.run_evidence_ladder(
        lpri, llik, p0, jax_evidence.power_betas(12), 1500,
        jax.random.PRNGKey(0), n_burn=500, thin=5)
    return res, truth


def test_betas_and_logmeanexp_match_jax():
    for k, p in ((2, 5.0), (12, 5.0), (7, 3.0)):
        assert np.array_equal(power_betas(k, p),
                              jax_evidence.power_betas(k, p))
    rng = np.random.default_rng(0)
    for v in (rng.normal(size=50) * 100, np.array([0.0, -np.inf]),
              np.array([-np.inf, -np.inf]), np.array([3e4, 3e4 - 1.0])):
        assert _logmeanexp(v) == jax_evidence._logmeanexp(v)
    with pytest.raises(ValueError, match="rungs"):
        power_betas(1)


def test_estimators_reproduce_jax_on_its_samples(jax_toy):
    jres, _ = jax_toy
    est = ladder_estimates(jres.log_like_samples, jres.betas)
    for key in ("log_z", "log_z_err", "log_z_ti"):
        assert est[key] == pytest.approx(getattr(jres, key), rel=1e-10,
                                         abs=1e-10)
    np.testing.assert_allclose(est["ss_terms"], jres.ss_terms, rtol=1e-10)
    np.testing.assert_allclose(est["mean_log_like"], jres.mean_log_like,
                               rtol=1e-10)


def test_gaussian_evidence_matches_analytic_and_jax(jax_toy):
    jres, truth = jax_toy
    lpri, llik, _ = _gaussian_problem(3, 3.0, 0.5, 1.0, torch)
    g = _gen(0)
    p0 = 3.0 * torch.randn((64, 3), generator=g, dtype=torch.float64)
    res = run_evidence_ladder(lpri, llik, p0, power_betas(12), 1000, g,
                              n_burn=300, thin=5)
    assert res.log_like_samples.shape == (200, 12, 64)
    assert 0 < res.log_z_err < 0.2
    assert abs(res.log_z - truth) < 3 * res.log_z_err, (res.log_z, truth)
    both = np.hypot(res.log_z_err, jres.log_z_err)
    assert abs(res.log_z - jres.log_z) < 3 * both, (res.log_z, jres.log_z)
    assert abs(res.log_z_ti - truth) < 0.3
    assert (res.swap_acceptance > 0.05).all()
    assert res.mean_log_like[0] < res.mean_log_like[-1]
    assert res.acceptance_fraction.shape == (12, 64)


def test_stepping_stone_robust_to_zero_likelihood_regions():
    """L = 0 on half the prior support (x0 < 0): stepping-stone stays
    finite and right, TI reports -inf."""
    s2 = 4.0

    def lpri(x):
        return -0.5 * (x * x).sum(-1) / s2

    def llik(x):
        d = x - 1.0
        ll = -0.5 * (d * d).sum(-1) / 0.25 - 0.5 * np.log(2 * np.pi * 0.25)
        return torch.where(x[..., 0] >= 0, ll, torch.full_like(ll,
                                                               -float("inf")))

    v = 1.0 / (1 / s2 + 1 / 0.25)
    m = v * (1.0 / 0.25)
    truth = float(norm.logpdf(1.0, 0, np.sqrt(s2 + 0.25))
                  + norm.logsf(0.0, m, np.sqrt(v)))
    g = _gen(7)
    p0 = torch.abs(2.0 * torch.randn((64, 1), generator=g,
                                     dtype=torch.float64))
    res = run_evidence_ladder(lpri, llik, p0, power_betas(12), 1000, g,
                              n_burn=300, thin=5)
    assert np.isfinite(res.log_z)
    assert abs(res.log_z - truth) < 0.2, (res.log_z, truth)
    assert res.log_z_ti == float("-inf")


def test_ladder_validation():
    lpri, llik, _ = _gaussian_problem(1, 1.0, 1.0, 0.0, torch)
    p0 = torch.zeros((8, 1), dtype=torch.float64)
    for betas in ([0.0, 0.5, 0.9], [0.1, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0]):
        with pytest.raises(ValueError, match="ascend"):
            run_evidence_ladder(lpri, llik, p0, betas, 10, _gen(0))
    with pytest.raises(ValueError, match="multiple"):
        run_evidence_ladder(lpri, llik, p0, [0.0, 1.0], 10, _gen(0), thin=3)
    with pytest.raises(ValueError, match="n_burn"):
        run_evidence_ladder(lpri, llik, p0, [0.0, 1.0], 10, _gen(0),
                            n_burn=-1)
    with pytest.raises(ValueError, match="leading dim"):
        run_evidence_ladder(lpri, llik, p0[None].expand(3, 8, 1),
                            [0.0, 1.0], 10, _gen(0))


def test_model_evidence_on_the_joint_model(tmp_path):
    """The ladder on the small synthetic joint model's prior and data
    factors (4 rungs x 32 walkers, a short run): finite log Z, every
    state in the prior's support."""
    sess = build_session(small_config(tmp_path), device="cpu")
    res = model_evidence(sess.model, n_rungs=4, n_walkers=32, n_steps=20,
                         n_burn=20, thin=5, seed=1)
    assert np.isfinite(res.log_z) and np.isfinite(res.log_z_err)
    assert res.log_like_samples.shape == (4, 4, 32)
    assert (res.swap_acceptance >= 0).all()
    x, pri, lik = res.final_state
    assert torch.isfinite(pri).all() and torch.isfinite(lik).all()
    np.testing.assert_allclose(
        sess.model.log_prior_only(x.reshape(-1, x.shape[-1])).numpy(),
        pri.reshape(-1).numpy(), rtol=1e-12)
