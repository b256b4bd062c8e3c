"""Port parity: the log reparametrization (``joxsz_torch/sampling/
reparam.py``): forward and inverse maps, the log-Jacobian and the
wrapped density against the JAX package's to 1e-12, the same refusals,
chains mapped back in numpy, and the same posterior sampled in u-space
(Gamma x Normal target) as in theta-space on the port's plain sampler."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.sampling.reparam import DEFAULT_LOG_PARAMS, LogReparam
from joxsz_torch.sampling.stretch import run_ensemble
from joxsz_tpu.sampling.reparam import DEFAULT_LOG_PARAMS as JAX_DEFAULT
from joxsz_tpu.sampling.reparam import LogReparam as JaxLogReparam

from test_torch_build import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


class _FakeParams:
    def __init__(self, names, lo):
        self.thawed = list(names)
        self.lo = np.asarray(lo, dtype=float)
        self.hi = np.full(len(names), np.inf)


def _pair(names=("s", "t")):
    fp = _FakeParams(["s", "x", "t"], [0.0, -5.0, 0.1])
    return LogReparam(fp, names=names), JaxLogReparam(fp, names=names)


def test_maps_and_jacobian_match_jax():
    rp, jrp = _pair()
    assert rp.names == jrp.names and DEFAULT_LOG_PARAMS == JAX_DEFAULT
    rng = np.random.default_rng(0)
    theta = np.abs(rng.normal(size=(6, 3))) + 0.05
    theta[:, 1] = rng.normal(size=6)
    u = rp.fwd(torch.as_tensor(theta))
    ju = np.asarray(jrp.fwd(jnp.asarray(theta)))
    np.testing.assert_allclose(u.numpy(), ju, rtol=1e-12)
    np.testing.assert_allclose(rp.inv(u).numpy(), theta, rtol=1e-12)
    np.testing.assert_allclose(rp.inv(u).numpy(),
                               np.asarray(jrp.inv(jnp.asarray(ju))),
                               rtol=1e-12)
    np.testing.assert_allclose(rp.log_jacobian(u).numpy(),
                               np.asarray(jrp.log_jacobian(jnp.asarray(ju))),
                               rtol=1e-12)
    assert rp.log_jacobian(u[0]).shape == ()

    def lp(x):
        return -0.5 * (x * x).sum(-1)

    got = rp.wrap_log_prob_batch(lp)(u).numpy()
    want = np.asarray(jrp.wrap_log_prob_batch(
        lambda x: -0.5 * jnp.sum(x * x, axis=-1))(jnp.asarray(ju)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_chain_to_theta_matches_inv_and_stays_numpy():
    rp, jrp = _pair()
    chain = np.random.default_rng(0).normal(size=(7, 5, 3))
    chain[..., 1] = 300.0          # unmasked: a naive exp would overflow
    out = rp.chain_to_theta(chain)
    assert isinstance(out, np.ndarray) and np.isfinite(out).all()
    np.testing.assert_allclose(out, rp.inv(torch.as_tensor(chain)).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(out, jrp.chain_to_theta(chain), rtol=1e-12)


def test_refusals_match_jax():
    for cls in (LogReparam, JaxLogReparam):
        with pytest.raises(ValueError, match="lower bound"):
            cls(_FakeParams(["a"], [-1.0]), names=("a",))
        with pytest.raises(ValueError, match="thawed"):
            cls(_FakeParams(["a"], [0.0]), names=("zzz",))


def test_reparam_targets_same_posterior():
    """theta_0 ~ Gamma(3, 1), theta_1 ~ N(0, 1): sampled in u = log
    theta_0 with the Jacobian, mapped back, the same marginals as the
    direct run."""
    def lp(x):
        ok = x[:, 0] > 0
        g = torch.where(ok, 2.0 * torch.log(torch.where(
            ok, x[:, 0], torch.ones_like(x[:, 0]))) - x[:, 0],
            torch.full_like(x[:, 0], -float("inf")))
        return g - 0.5 * x[:, 1] ** 2

    rp = LogReparam(_FakeParams(["g", "n"], [0.0, -10.0]), names=("g",))
    W, n_steps, thin = 256, 3000, 4
    rng = np.random.default_rng(0)
    p0 = torch.as_tensor(np.column_stack([rng.gamma(3.0, 1.0, W),
                                          rng.standard_normal(W)]))
    g = torch.Generator()
    g.manual_seed(1)
    direct = run_ensemble(lp, p0, n_steps, g, thin=thin)
    rep = run_ensemble(rp.wrap_log_prob_batch(lp), rp.fwd(p0), n_steps, g,
                       thin=thin)
    th_d = direct.chain[100:].reshape(-1, 2)
    th_r = rp.chain_to_theta(rep.chain[100:]).reshape(-1, 2)
    assert abs(th_r[:, 0].mean() - 3.0) < 0.15
    assert abs(th_r[:, 0].std() - np.sqrt(3.0)) < 0.15
    assert abs(th_r[:, 0].mean() - th_d[:, 0].mean()) < 0.2
    assert abs(th_r[:, 1].mean()) < 0.1
    assert abs(th_r[:, 1].std() - 1.0) < 0.1
    for q in (0.1, 0.5, 0.9):
        assert abs(np.quantile(th_r[:, 0], q)
                   - np.quantile(th_d[:, 0], q)) < 0.25
