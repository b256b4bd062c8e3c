"""Port parity: the gradient samplers (``joxsz_torch/sampling/{adapt,
hmc,nuts}.py``).

``dual_averaging_update`` equals the JAX package's to 1e-12 on a
scripted sequence; ``make_safe_lp_grad`` on the small synthetic joint
model equals ``jax.grad`` (x64) of the same -1e12-surrogate expression at
1e-8 where finite and gives the same class of value (zero) at the rows
the box, r_c > r_s and the mass veto reject.  Then the JAX package's
statistical cases on batched torch targets: correlated-Gaussian moments
(HMC and NUTS), the step-size adaptation, the mass adaptation on a badly
scaled target, NUTS's deeper trees there, NUTS surviving a chain
started at -inf, and the gradient carried from one transition to the
next.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.sampling.adapt import (dual_averaging_update,
                                        make_safe_lp_grad)
from joxsz_torch.sampling.hmc import run_hmc
from joxsz_torch.sampling.nuts import run_nuts
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.sampling import adapt as jax_adapt

from test_torch_build import single_thread, small_config  # noqa: F401
from test_torch_families import family_configs, family_rows

pytestmark = pytest.mark.usefixtures("single_thread")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    mu = float(np.log(10 * 0.01))
    state = (0.0, float(np.log(0.01)))        # h_bar, log_eps_bar
    jstate = state
    for t in range(1, 60):
        a = float(rng.uniform())
        le, leb, hb = dual_averaging_update(float(t), a, state[0], state[1],
                                            mu, 0.8)
        jle, jleb, jhb = jax_adapt.dual_averaging_update(
            float(t), a, jstate[0], jstate[1], mu, 0.8)
        for x, y in ((le, jle), (leb, jleb), (hb, jhb)):
            assert float(x) == pytest.approx(float(y), rel=1e-12, abs=1e-12)
        state, jstate = (hb, leb), (float(jhb), float(jleb))
    # the torch warmup feeds 0-d tensors: the same numbers
    le_t, _, _ = dual_averaging_update(
        7.0, torch.tensor(0.3, dtype=torch.float64),
        torch.tensor(0.1, dtype=torch.float64), torch.tensor(-2.0,
                                                             dtype=torch.float64),
        torch.tensor(mu, dtype=torch.float64), 0.8)
    le_f, _, _ = dual_averaging_update(7.0, 0.3, 0.1, -2.0, mu, 0.8)
    assert float(le_t) == pytest.approx(le_f, rel=1e-15)


def test_safe_grad_matches_jax_on_the_joint_model(tmp_path):
    cfg, jc, _ = family_configs(small_config(tmp_path), ())
    jc.dtype = "float64"
    sess = build_session(cfg, device="cpu")
    js = jax_build_session(copy.deepcopy(jc), use_cache=False)
    rows = family_rows(sess, n=8)
    lp_b, grad_b = make_safe_lp_grad(sess.model.log_like_batch)
    jlp_b, jgrad_b = jax_adapt.make_safe_lp_grad(js.model.log_like)
    th = torch.as_tensor(rows)
    lp, g = lp_b(th).numpy(), grad_b(th).numpy()
    jlp = np.asarray(jlp_b(jnp.asarray(rows)))
    jg = np.asarray(jax.jit(jgrad_b)(jnp.asarray(rows)))
    fin = np.isfinite(jlp)
    assert np.array_equal(np.isfinite(lp), fin)
    assert fin.sum() >= 6 and (~fin).sum() >= 3
    np.testing.assert_allclose(lp[fin], jlp[fin], rtol=1e-12)
    np.testing.assert_allclose(g[fin], jg[fin], rtol=1e-8, atol=0)
    # a vetoed row: the same class of value in both (zero here)
    for i in np.where(~fin)[0]:
        assert np.isnan(g[i]).any() == np.isnan(jg[i]).any()
        assert np.all(g[i] == 0) == np.all(jg[i] == 0)
        assert np.all(jg[i] == 0)


def _correlated_gaussian():
    rng = np.random.default_rng(0)
    D = 5
    A = rng.normal(size=(D, D))
    cov = A @ A.T + D * np.eye(D)
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu = torch.as_tensor(rng.normal(size=D) * 2)

    def lp(x):
        d = x - mu
        return -0.5 * ((d @ prec) * d).sum(-1)

    p0 = mu + torch.randn((32, D), generator=_gen(1),
                          dtype=torch.float64) * 2.0
    return lp, p0, mu.numpy(), cov


def test_hmc_correlated_gaussian_moments():
    lp, p0, mu, cov = _correlated_gaussian()
    res = run_hmc(lp, p0, n_steps=1000, gen=_gen(2), n_warmup=300,
                  n_leapfrog=12, thin=2)
    assert res.chain.shape == (500, 32, 5)
    assert res.acceptance_fraction.mean() > 0.5
    flat = res.chain[50:].reshape(-1, 5)
    scale = np.sqrt(np.diag(cov))
    assert np.all(np.abs(flat.mean(axis=0) - mu) < 0.12 * scale)
    assert np.allclose(np.cov(flat.T), cov, rtol=0.2,
                       atol=0.12 * scale.max() ** 2)


def test_nuts_correlated_gaussian_moments():
    lp, p0, mu, cov = _correlated_gaussian()
    res = run_nuts(lp, p0, n_steps=400, gen=_gen(2), n_warmup=200,
                   max_depth=8, thin=2)
    assert 0.6 < res.mean_accept_prob < 0.95
    flat = res.chain[50:].reshape(-1, 5)
    scale = np.sqrt(np.diag(cov))
    assert np.all(np.abs(flat.mean(axis=0) - mu) < 0.1 * scale)
    assert np.max(np.abs(np.cov(flat.T) - cov) / np.outer(scale, scale)) < 0.1


def _unit(x):
    return -0.5 * (x * x).sum(-1)


def test_step_size_adaptation_targets_accept():
    p0 = torch.randn((16, 4), generator=_gen(3), dtype=torch.float64)
    res = run_hmc(_unit, p0, n_steps=600, gen=_gen(4), n_warmup=400,
                  n_leapfrog=8, target_accept=0.8)
    assert 0.55 < res.acceptance_fraction.mean() < 0.99
    assert res.step_size > 0
    res = run_nuts(_unit, p0, n_steps=400, gen=_gen(6), n_warmup=400,
                   max_depth=6, target_accept=0.8)
    assert 0.6 < res.mean_accept_prob < 0.95
    assert res.step_size > 0


def test_mass_adaptation_helps_badly_scaled_target():
    scales = torch.tensor([0.05, 0.5, 5.0, 50.0], dtype=torch.float64)

    def lp(x):
        return -0.5 * ((x / scales) ** 2).sum(-1)

    p0 = torch.randn((32, 4), generator=_gen(5), dtype=torch.float64)
    outs = {}
    for adapt in (False, True):
        res = run_hmc(lp, p0, n_steps=800, gen=_gen(6), n_warmup=400,
                      n_leapfrog=10, thin=2, adapt_mass=adapt)
        flat = res.chain[100:].reshape(-1, 4)
        outs[adapt] = np.abs(np.log(flat.std(axis=0) / scales.numpy()))
    assert outs[True].max() < outs[False].max() * 0.8, outs


def test_nuts_deep_trees_on_badly_scaled_target():
    """Identity mass on a 1:20 scale ratio: the step size adapts to the
    small scale, so NUTS must build deeper trees and still recover both
    scales."""
    scales = torch.tensor([0.5, 10.0, 1.0, 2.0], dtype=torch.float64)

    def lp(x):
        return -0.5 * ((x / scales) ** 2).sum(-1)

    p0 = torch.randn((32, 4), generator=_gen(3), dtype=torch.float64) * scales
    res = run_nuts(lp, p0, n_steps=200, gen=_gen(4), n_warmup=150,
                   max_depth=7, thin=2, mass_diag=np.ones(4),
                   adapt_mass=False)
    assert res.mean_tree_depth > 3.0, res.mean_tree_depth
    flat = res.chain[25:].reshape(-1, 4)
    ratio = flat.std(axis=0) / scales.numpy()
    assert np.all(np.abs(np.log(ratio)) < np.log(1.2)), ratio


def test_nuts_survives_inf_start_chain():
    """A chain started at lp = -inf must not NaN the shared step size:
    the healthy chains keep sampling."""
    def lp(x):
        ok = (x.abs() < 3.0).all(dim=-1)
        return torch.where(ok, -0.5 * (x * x).sum(-1),
                           torch.full_like(x[:, 0], -float("inf")))

    rng = np.random.default_rng(0)
    p0 = 0.3 * rng.standard_normal((8, 2))
    p0[0] = [10.0, 10.0]
    res = run_nuts(lp, torch.as_tensor(p0), n_steps=50, gen=_gen(1),
                   n_warmup=60, max_depth=5)
    assert np.isfinite(res.step_size)
    assert np.isfinite(res.chain[:, 1:]).all()
    assert np.isfinite(res.log_prob[:, 1:]).all()


def test_gradient_is_carried_between_transitions():
    """One gradient pass per leapfrog and per NUTS leaf after the first
    at p0: no transition recomputes the gradient at its start point."""
    calls = []

    def lp(x):
        calls.append(x.shape[0])
        return _unit(x)

    p0 = torch.randn((8, 3), generator=_gen(7), dtype=torch.float64)
    run_hmc(lp, p0, n_steps=20, gen=_gen(8), n_warmup=10, n_leapfrog=4)
    assert calls == [8] * (1 + (10 + 20) * 4)
    calls.clear()
    # depth 1: one leaf per transition
    run_nuts(lp, p0, n_steps=20, gen=_gen(8), n_warmup=10, max_depth=1)
    assert calls == [8] * (1 + 10 + 20)


def test_schedule_guards():
    p0 = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple"):
        run_hmc(_unit, p0, 10, _gen(0), n_warmup=0, thin=3)
    with pytest.raises(ValueError, match="positive"):
        run_nuts(_unit, p0, 0, _gen(0), n_warmup=0)
