"""Port parity: the Laplace approximation (``joxsz_torch/sampling/
laplace.py``) and ``run --laplace``.

Exact on a Gaussian, a boundary mode flagged and not inverted, the
conditional sd on a mixed boundary mode, the conjugate normalized
evidence (the JAX package's cases, on batched torch functions); on the
small synthetic joint model at a fixed theta, the port's float64 autograd
Hessian against ``jax.hessian`` (x64), plain (-H indefinite there) and
with a ridge that makes it proper; ``run.main(["--laplace", "--cpu"])``
writes ``<name>_laplace.json`` with the keys and values the JAX
package's quick-look writes for the same result.
"""

import copy
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import joxsz_tpu.sampling
from joxsz_torch import run
from joxsz_torch.build import build_session
from joxsz_torch.models.params import ParamSet, gaussian_param
from joxsz_torch.sampling import laplace as laplace_mod
from joxsz_torch.sampling.laplace import (laplace_approximation, laplace_fit,
                                          model_laplace)
from joxsz_torch.synth import truth_theta
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.config import JoXSZConfig as JaxConfig
from joxsz_tpu.run import _laplace_quicklook as jax_quicklook
from joxsz_tpu.sampling.laplace import laplace_approximation as jax_laplace

from test_torch_build import single_thread, small_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

RTOL = 1e-6


def _mvn_problem():
    A = np.array([[2.0, 0.5, 0.0],
                  [0.5, 1.5, -0.3],
                  [0.0, -0.3, 1.0]])
    m = np.array([0.3, -0.7, 1.2])
    At, mt = torch.as_tensor(A), torch.as_tensor(m)

    def log_post_batch(x):
        d = x - mt
        return -0.5 * ((d @ At) * d).sum(-1)

    log_z = 1.5 * np.log(2 * np.pi) - 0.5 * np.log(np.linalg.det(A))
    return log_post_batch, m, np.linalg.inv(A), log_z


def test_laplace_exact_on_gaussian():
    lpb, m, cov_true, log_z_true = _mvn_problem()
    res = laplace_approximation(lambda t: lpb(t[None])[0],
                                torch.as_tensor(m))
    assert res.ok
    np.testing.assert_allclose(res.cov, cov_true, rtol=1e-8, atol=1e-10)
    assert abs(res.log_z - log_z_true) < 1e-8
    assert abs(res.log_post_map) < 1e-12
    np.testing.assert_allclose(np.diag(res.correlation), 1.0, rtol=1e-10)
    # the MAP search from a poor start finds the mode
    res = laplace_fit(lpb, np.zeros(3), np.full(3, -10.0), np.full(3, 10.0))
    assert res.ok and not res.at_boundary.any()
    np.testing.assert_allclose(res.theta_map, m, atol=2e-5)
    assert abs(res.log_z - log_z_true) < 1e-6
    with pytest.warns(UserWarning, match="float64"):
        laplace_approximation(lambda t: lpb(t[None].double())[0],
                              torch.as_tensor(m, dtype=torch.float32))


def _boxed(fn):
    def lpb(x):
        inside = ((x >= 0) & (x <= 1)).all(dim=1)
        return torch.where(inside, fn(x), torch.full_like(x[:, 0],
                                                          -float("inf")))
    return lpb


def test_laplace_boundary_mode_is_flagged_not_inverted():
    lpb = _boxed(lambda x: -x.sum(1))              # mode at the lower bound
    res = laplace_fit(lpb, np.full(2, 0.5), np.zeros(2), np.ones(2))
    assert not res.ok
    assert np.isnan(res.log_z) and np.isnan(res.cov).all()
    assert res.at_boundary.all()
    assert np.isnan(res.sd_conditional).all()


def test_laplace_conditional_sd_on_mixed_boundary_mode():
    lpb = _boxed(lambda x: -0.5 * ((x[:, 0] - 0.5) / 0.1) ** 2 - 3.0 * x[:, 1])
    res = laplace_fit(lpb, np.array([0.3, 0.5]), np.zeros(2), np.ones(2))
    assert not res.ok
    assert res.at_boundary.tolist() == [False, True]
    assert abs(res.sd_conditional[0] - 0.1) < 1e-6
    assert np.isnan(res.sd_conditional[1])


class _StubModel:
    """A JointModel-shaped object: params and analytic factors."""

    def __init__(self, params, mu_like, sigma_like):
        self.params = params
        self._mu = torch.as_tensor(mu_like)
        self._t2 = float(sigma_like) ** 2
        self.sz_data = types.SimpleNamespace(L=torch.zeros(1,
                                                           dtype=torch.float64))

    def to(self, device, dtype):
        return self

    def log_prior_only(self, theta):
        return self.params.log_prior(theta)

    def log_data_like(self, theta):
        d = theta - self._mu
        D = theta.shape[-1]
        return (-0.5 * (d * d).sum(-1) / self._t2
                - 0.5 * D * np.log(2 * np.pi * self._t2))

    def log_like_batch(self, theta):
        return self.log_prior_only(theta) + self.log_data_like(theta)

    def log_like(self, theta):
        return self.log_like_batch(theta[None])[0]


def test_model_laplace_conjugate_normalized_evidence():
    s, t = 1.5, 0.4
    params = ParamSet([("x0", gaussian_param(0.1, 0.0, s)),
                       ("x1", gaussian_param(-0.2, 0.0, s))])
    mu = np.array([0.8, -0.5])
    res = model_laplace(_StubModel(params, mu, t), n_prior_samples=50_000,
                        seed=3, device="cpu")
    truth = float(np.sum(-0.5 * mu ** 2 / (s ** 2 + t ** 2)
                         - 0.5 * np.log(2 * np.pi * (s ** 2 + t ** 2))))
    assert res.ok
    assert abs(res.prior_log_norm - 2 * np.log(np.sqrt(2 * np.pi) * s)) \
        < 1e-12
    assert abs(res.log_z_normalized - truth) < 1e-6
    np.testing.assert_allclose(res.sd, 1.0 / np.sqrt(1 / s ** 2 + 1 / t ** 2),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_laplace"))
    jc = JaxConfig.from_json(cfg.to_json())
    jc.dtype = "float64"
    return cfg, build_session(cfg, device="cpu"), jax_build_session(
        jc, use_cache=False)


def test_joint_hessian_matches_jax(joint):
    """At the synthetic truth: H, the eigenvalues of -H, ok, at_boundary,
    sd, sd_conditional and log_z against the JAX package's, plain (-H
    indefinite: ok False, sd and log_z NaN in both) and with a ridge
    lam |theta - theta0|^2 / 2 large enough to make -H proper."""
    _, sess, js = joint
    p = sess.params
    th = truth_theta(sess)
    th_t = torch.as_tensor(th)
    f = jax.jit(lambda t, lam: js.model.log_like(t)
                - 0.5 * lam * jnp.sum((t - jnp.asarray(th)) ** 2))
    oks = []
    for lam in (0.0, 100.0):
        r = laplace_approximation(
            lambda t: sess.model.log_like(t)
            - 0.5 * lam * torch.sum((t - th_t) ** 2), th_t, p.lo, p.hi)
        jr = jax_laplace(lambda t: f(t, lam), jnp.asarray(th), lo=p.lo,
                         hi=p.hi)
        np.testing.assert_allclose(r.hessian, jr.hessian, rtol=RTOL,
                                   atol=RTOL * np.abs(jr.hessian).max())
        np.testing.assert_allclose(r.eigenvalues, jr.eigenvalues, rtol=RTOL,
                                   atol=RTOL * np.abs(jr.eigenvalues).max())
        assert r.ok == jr.ok
        assert np.array_equal(r.at_boundary, jr.at_boundary)
        for a, b in ((r.sd, jr.sd), (r.sd_conditional, jr.sd_conditional),
                     (np.array([r.log_z]), np.array([jr.log_z]))):
            assert np.array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                       rtol=RTOL)
        assert r.log_post_map == pytest.approx(jr.log_post_map, rel=1e-12)
        oks.append(r.ok)
    assert oks == [False, True]


def test_run_laplace_writes_the_jax_keys(joint, tmp_path, monkeypatch):
    """``run --laplace --cpu`` on the synthetic config: the quick-look
    runs (the MAP search, held on the Gaussian above, stubbed to return
    its start), and its JSON equals what the JAX package's quick-look
    writes for the same result."""
    cfg, sess, _ = joint
    cfg = copy.deepcopy(cfg)
    cfg.save_dir = str(tmp_path / "port")
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    monkeypatch.setattr(laplace_mod, "find_mle", lambda model, theta0, lo,
                        hi, **kw: (np.asarray(theta0), float("nan")))
    res = run.main(["--config", str(path), "--cpu", "--laplace"])
    out = json.loads((tmp_path / "port" / f"{cfg.name}_laplace.json")
                     .read_text())
    assert np.isfinite(res.log_post_map) and np.isfinite(res.prior_log_norm)
    # the JAX package's quick-look on the same result
    monkeypatch.setattr(joxsz_tpu.sampling, "model_laplace",
                        lambda model, verbose=False: res)
    jsave = tmp_path / "jax"
    jsave.mkdir()
    jax_quicklook(types.SimpleNamespace(model=None, params=sess.params),
                  types.SimpleNamespace(save_dir=str(jsave), name=cfg.name))
    ref = json.loads((jsave / f"{cfg.name}_laplace.json").read_text())
    assert out.keys() == ref.keys()
    assert out == ref
