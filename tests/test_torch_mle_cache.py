"""The MLE warm start around ``find_mle``: the self-validating disk cache
(``find_mle_cached``) and the batched multi-start climb
(``find_mle_multistart``), against ``joxsz_tpu.sampling.mle``.

  * the cache: a miss fits and writes the entry atomically (no ``.tmp``
    left) with theta, ll, theta0, lo, hi; a hit returns it without a fit
    after one fresh float64 evaluation on the host CPU; a changed start,
    a changed box or a log-likelihood that moved by 0.5 or more refits;
  * multistart: on the JAX package's own test problem the final ll is
    within 0.1 of ``joxsz_tpu``'s multistart; on the small synthetic
    session, of starts on the r_c = r_s veto wall the finite ones climb
    and the vetoed ones keep their start: no row turns to NaN.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.sampling import mle as tmle
from joxsz_torch.synth import truth_theta
from joxsz_tpu.sampling.mle import find_mle_multistart as jax_multistart

from test_torch_build import small_config

MU = np.array([1.0, -2.0, 0.5])
LO, HI = np.full(3, -10.0), np.full(3, 10.0)


def gauss_batch(x):
    return -0.5 * ((x - torch.tensor(MU, dtype=x.dtype)) ** 2).sum(-1) * 20.0


def gauss_jax(x):
    return -0.5 * jnp.sum((x - jnp.asarray(MU)) ** 2) * 20.0


def test_cache_miss_writes_then_hits(tmp_path, monkeypatch):
    path = tmp_path / "c" / "mle.json"
    theta, ll, hit = tmle.find_mle_cached(gauss_batch, np.zeros(3), LO, HI,
                                          path, device="cpu")
    assert not hit and np.allclose(theta, MU, atol=1e-3) and ll > -1e-4
    d = json.loads(path.read_text())
    assert set(d) == {"theta", "ll", "theta0", "lo", "hi"}
    assert not path.with_suffix(".tmp").exists()

    def no_fit(*a, **k):
        raise AssertionError("a cache hit must not fit")

    monkeypatch.setattr(tmle, "find_mle", no_fit)
    theta2, ll2, hit2 = tmle.find_mle_cached(gauss_batch, np.zeros(3), LO,
                                             HI, path, device="cpu")
    assert hit2 and np.array_equal(theta2, theta) and ll2 == ll


@pytest.mark.parametrize("change", ["theta0", "box", "stale_ll",
                                    "corrupt"])
def test_cache_guards_refit(tmp_path, monkeypatch, change):
    path = tmp_path / "mle.json"
    tmle.find_mle_cached(gauss_batch, np.zeros(3), LO, HI, path,
                         device="cpu")
    theta0, lo = np.zeros(3), LO
    if change == "theta0":
        theta0 = np.full(3, 0.5)
    elif change == "box":
        lo = np.full(3, -9.0)
    elif change == "stale_ll":
        d = json.loads(path.read_text())
        d["ll"] += 0.6
        path.write_text(json.dumps(d))
    else:
        path.write_text("{not json")
    calls = []

    def fake_fit(model, t0, lo_, hi_, **kw):
        calls.append(np.asarray(t0))
        return np.asarray(MU), 0.0

    monkeypatch.setattr(tmle, "find_mle", fake_fit)
    _, _, hit = tmle.find_mle_cached(gauss_batch, theta0, lo, HI, path,
                                     device="cpu")
    assert not hit and len(calls) == 1
    assert json.loads(path.read_text())["theta0"] == list(theta0)


def test_cache_hit_evaluates_in_float64_on_the_cpu(tmp_path):
    """A float32 session's entry is validated by the model's float64 CPU
    copy: the returned ll is that evaluation, bit for bit."""
    cfg = small_config(tmp_path / "data")
    sess = build_session(cfg, device="cpu", dtype=torch.float32)
    th = truth_theta(sess)
    f64 = sess.model.to(torch.device("cpu"), torch.float64)
    ll64 = float(f64.log_like_batch(torch.tensor(th[None]))[0])
    p = sess.params
    path = tmp_path / "mle.json"
    path.write_text(json.dumps({
        "theta": th.tolist(), "ll": ll64 + 0.3,
        "theta0": p.thawed_values().tolist(), "lo": p.lo.tolist(),
        "hi": p.hi.tolist()}))
    theta, ll, hit = tmle.find_mle_cached(sess.model, p.thawed_values(),
                                          p.lo, p.hi, path, device="cpu")
    assert hit and ll == ll64 and np.array_equal(theta, th)


def test_multistart_matches_jax_on_its_test_problem():
    kw = dict(n_starts=16, n_steps=400, lr=0.05)
    theta, ll = tmle.find_mle_multistart(gauss_batch, np.zeros(3), LO, HI,
                                         device="cpu", **kw)
    jtheta, jll = jax_multistart(gauss_jax, np.zeros(3), LO, HI, **kw)
    assert abs(ll - jll) < 0.1
    assert np.allclose(theta, MU, atol=0.05) and ll > -0.1


def test_multistart_on_a_veto_wall_stays_finite(tmp_path):
    """Starts on the r_c = r_s wall, some of them vetoed (-inf): the
    finite ones climb, the vetoed ones keep their start with a zero
    gradient, and no row turns to NaN."""
    cfg = small_config(tmp_path / "data")
    sess = build_session(cfg, device="cpu")
    p = sess.params
    th = truth_theta(sess)
    ix = p.thawed.index
    th[ix("log(r_c)")] = th[ix("log(r_s)")]
    batch = sess.model.log_like_batch
    kw = dict(device="cpu", seed=1, n_starts=8, lr=2e-2, spread=0.02)
    starts, f0 = tmle.adam_starts(batch, th, p.lo, p.hi, n_steps=0, **kw)
    thetas, fs = tmle.adam_starts(batch, th, p.lo, p.hi, n_steps=30, **kw)
    vetoed = f0 == 1e12
    assert bool(vetoed.any()) and bool((~vetoed).any())
    assert torch.isfinite(thetas).all()
    assert torch.equal(thetas[vetoed], starts[vetoed])
    assert bool((fs[~vetoed] < f0[~vetoed] - 1.0).all())
