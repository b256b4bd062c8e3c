"""Port parity: the prior/likelihood split of the joint model and the
prior-measure utilities (``joxsz_torch/models/joint.py::log_prior_only``
/ ``log_data_like``, ``joxsz_torch/sampling/priors.py``).

For every model family on the small synthetic dataset of
``test_torch_build.small_config`` (the rows of ``test_torch_families.
family_rows``: draws around the truth, rows vetoed by the box, by r_c >
r_s and by the HSE mass), both factors against ``joxsz_tpu``'s at 1e-9
relative with the same -inf pattern, and the split exact against
``log_like_batch``; then the prior draws bit for bit the JAX package's
for one seed, the log-normalization equal, and the JAX package's guards.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.models.params import Param, ParamSet
from joxsz_torch.sampling import priors
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.models.params import Param as JaxParam
from joxsz_tpu.models.params import ParamSet as JaxParamSet
from joxsz_tpu.sampling import priors as jax_priors

from test_torch_build import single_thread, small_config  # noqa: F401
from test_torch_families import FAMILIES, family_configs, family_rows

pytestmark = pytest.mark.usefixtures("single_thread")

RTOL = 1e-9
TAGS = ["gnfw"] + list(FAMILIES)


@pytest.fixture(scope="module")
def base_config(tmp_path_factory):
    return small_config(tmp_path_factory.mktemp("torch_priors"))


@pytest.fixture(scope="module")
def sessions(base_config):
    """tag -> (port float64 session, JAX float64 session)."""
    out = {}
    for tag in TAGS:
        flags = () if tag == "gnfw" else FAMILIES[tag][0]
        cfg, jc, sz_only = family_configs(base_config, flags)
        jc.dtype = "float64"
        out[tag] = (build_session(cfg, device="cpu", sz_only=sz_only),
                    jax_build_session(copy.deepcopy(jc), sz_only=sz_only,
                                      use_cache=False))
    return out


def _same(port: np.ndarray, ref: np.ndarray):
    assert np.array_equal(np.isfinite(port), np.isfinite(ref))
    assert np.array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=0)


@pytest.mark.parametrize("tag", TAGS)
def test_split_matches_jax_and_is_exact(sessions, tag):
    sess, js = sessions[tag]
    rows = family_rows(sess)
    assert len(rows) >= 27
    th = torch.as_tensor(rows)
    m = sess.model
    pri = m.log_prior_only(th).numpy()
    dat = m.log_data_like(th).numpy()
    full = m.log_like_batch(th).numpy()
    jpri, jdat = jax.jit(jax.vmap(lambda t: (js.model.log_prior_only(t),
                                             js.model.log_data_like(t))))(
        jnp.asarray(rows))
    _same(pri, np.asarray(jpri))
    _same(dat, np.asarray(jdat))
    # the box, r_c > r_s and mass-veto rows: prior -inf, full -inf
    n = len(rows) - (3 if sess.model.xray_data is None else 5)
    assert np.isneginf(pri[n:n + 3]).all()
    fin = np.isfinite(pri)
    assert fin.sum() >= 10
    assert np.isneginf(full[~fin]).all()
    np.testing.assert_allclose(pri[fin] + dat[fin], full[fin], rtol=1e-12,
                               atol=0)


def _params(cls, param):
    return cls([("x0", param(0.4, 0.0, 1.0)), ("x1", param(0.6, -2.0, 3.0)),
                ("g", param(1.0, 0.0, 2.0, prior="gauss", prior_mu=1.0,
                            prior_sigma=0.1))])


def _veto(x):
    x = np.asarray(x)
    return np.where(x[:, 0] < x[:, 1], 0.0, -np.inf)


def test_draws_bit_for_bit_and_log_norm():
    """Same seed, same numpy calls: the product draws, the rejection
    draws and the log-normalization equal the JAX package's exactly."""
    p, jp = _params(ParamSet, Param), _params(JaxParamSet, JaxParam)
    a = priors.product_prior_draws(p, 500, np.random.default_rng(3))
    b = jax_priors.product_prior_draws(jp, 500, np.random.default_rng(3))
    assert np.array_equal(a, b)
    a = priors.sample_prior(_veto, p, 700, np.random.default_rng(4))
    b = jax_priors.sample_prior(_veto, jp, 700, np.random.default_rng(4))
    assert np.array_equal(a, b) and a.shape == (700, 3)
    assert (a[:, 0] < a[:, 1]).all()
    a = priors.prior_log_norm(_veto, p, 20_000, np.random.default_rng(5))
    b = jax_priors.prior_log_norm(_veto, jp, 20_000,
                                  np.random.default_rng(5))
    assert a == b


def test_model_prior_draws_match_jax(sessions):
    """On the joint model (r_c <= r_s and the mass veto): the port's
    float64 chunked prior gives the JAX package's draws bit for bit, and
    the same log-normalization."""
    sess, js = sessions["gnfw"]
    lp = priors.model_log_prior(sess.model, "cpu")
    jlp = jax.jit(jax.vmap(js.model.log_prior_only))
    a = priors.sample_prior(lp, sess.params, 300, np.random.default_rng(8))
    b = jax_priors.sample_prior(jlp, js.params, 300,
                                np.random.default_rng(8))
    assert np.array_equal(a, b)
    a = priors.prior_log_norm(lp, sess.params, 4000, np.random.default_rng(9))
    b = jax_priors.prior_log_norm(jlp, js.params, 4000,
                                  np.random.default_rng(9))
    assert a == b and np.isfinite(a[0])


def test_prior_guards():
    box = ParamSet([("x0", Param(0.0, -1e99, 1e99))])     # unbounded box
    with pytest.raises(ValueError, match="finite bounds"):
        priors.product_prior_draws(box, 10, np.random.default_rng(0))
    with pytest.raises(ValueError, match="finite bounds"):
        priors.prior_log_norm(_veto, box, 10, np.random.default_rng(0))
    p = _params(ParamSet, Param)
    with pytest.raises(ValueError, match="positive"):
        priors.sample_prior(_veto, p, 0, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="rejection"):
        priors.sample_prior(lambda x: np.full(len(x), -np.inf), p, 5,
                            np.random.default_rng(0), max_tries=2)
