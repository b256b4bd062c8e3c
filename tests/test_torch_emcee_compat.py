"""The port's emcee-API shim (``joxsz_torch/emcee_compat.py``): the JAX
package's cases (``tests/test_emcee_compat.py``) on torch callables with
``device="cpu"``: the accessors and their shapes, a vectorized
log-probability with kwargs, the move specs and the generator API, the
autocorrelation guards, the constructor guards, reset without replaying
the random stream, and the default dtype; ``utils/timing.py`` beside it.
"""

import json

import numpy as np
import pytest
import torch

from joxsz_torch.emcee_compat import EnsembleSampler, State, _resolve_move
from joxsz_torch.utils import timing
from joxsz_torch.utils.timing import profile_to, trace_annotation
from joxsz_tpu.emcee_compat import _resolve_move as jax_resolve_move

from test_torch_build import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

CPU = dict(device="cpu", dtype=torch.float64)


def _log_prob(x):
    return -0.5 * torch.sum(x * x)


def _log_prob_vec(x, scale=1.0):
    return -0.5 * torch.sum((x / scale) ** 2, dim=-1)


def test_run_mcmc_and_accessors():
    W, D = 16, 3
    s = EnsembleSampler(W, D, _log_prob, seed=1, **CPU)
    p0 = 0.1 * np.random.default_rng(0).normal(size=(W, D))
    last = s.run_mcmc(p0, 200, thin_by=2)
    assert isinstance(last, State)
    assert last.coords.shape == (W, D) and last.log_prob.shape == (W,)
    assert s.get_chain().shape == (200, W, D)
    assert s.get_chain(flat=True).shape == (200 * W, D)
    assert s.get_chain(discard=50, thin=3).shape == (50, W, D)
    assert s.get_log_prob().shape == (200, W)
    assert s.get_log_prob(flat=True).shape == (200 * W,)
    assert np.all((s.acceptance_fraction > 0) & (s.acceptance_fraction < 1))
    assert s.chain.shape == (W, 200, D)
    assert s.flatchain.shape == (200 * W, D)
    assert s.lnprobability.shape == (W, 200)
    assert s.get_last_sample() is last
    s.run_mcmc(None, 50, thin_by=2)
    assert s.get_chain().shape == (250, W, D)
    flat = s.get_chain(flat=True, discard=100)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.15)
    assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.2)
    # an explicit seed reproduces the chain whatever ran before
    a = EnsembleSampler(W, D, _log_prob, **CPU)
    a.run_mcmc(p0, 5, seed=9)
    b = EnsembleSampler(W, D, _log_prob, **CPU)
    b.run_mcmc(p0, 3)
    b.reset()
    b.run_mcmc(p0, 5, seed=9)
    assert np.array_equal(a.get_chain(), b.get_chain())


def test_vectorized_log_prob_and_args():
    W, D = 12, 2
    s = EnsembleSampler(W, D, _log_prob_vec, vectorize=True,
                        kwargs={"scale": 2.0}, seed=3, **CPU)
    p0 = 0.1 * np.random.default_rng(1).normal(size=(W, D))
    s.run_mcmc(p0, 300)
    flat = s.get_chain(flat=True, discard=150)
    assert np.all(np.abs(flat.std(axis=0) - 2.0) < 0.5)
    # the same target through vmap of a scalar function with args
    v = EnsembleSampler(W, D, _log_prob_vec, args=(2.0,), seed=3, **CPU)
    v.run_mcmc(p0, 300)
    np.testing.assert_allclose(v.get_chain(), s.get_chain(), rtol=1e-12)


def test_moves_spec_and_generator():
    W, D = 16, 2
    for moves in ["de", "snooker", ("stretch", 3.0), [("de", 1.0)]]:
        s = EnsembleSampler(W, D, _log_prob, moves=moves, seed=5, **CPU)
        p0 = 0.3 * np.random.default_rng(2).normal(size=(W, D))
        states = list(s.sample(p0, iterations=5, thin_by=2))
        assert len(states) == 5
        assert s.get_chain().shape == (5, W, D)
    with pytest.raises(ValueError, match="mixtures"):
        EnsembleSampler(W, D, _log_prob, moves=[("de", 0.8),
                                                ("snooker", 0.2)], **CPU)


def test_resolve_move_matches_jax():
    for spec in (None, "stretch", "de", "snooker", ("stretch", 3.0),
                 ("de", 0.5), ("snooker", 1.2), [("stretch", 1.0)],
                 [("de", 1.0)], ["snooker"]):
        assert _resolve_move(spec) == jax_resolve_move(spec)
    for bad in (("stretch", 1.0), "walk", [("de", 0.5), ("stretch", 0.5)]):
        for fn in (_resolve_move, jax_resolve_move):
            with pytest.raises(ValueError):
                fn(bad)


def test_singleton_weight_is_not_a_scale():
    W, D = 16, 2
    s = EnsembleSampler(W, D, _log_prob, moves=[("stretch", 1.0)], seed=11,
                        **CPU)
    p0 = 0.3 * np.random.default_rng(5).normal(size=(W, D))
    s.run_mcmc(p0, 50)
    assert not np.allclose(s.get_chain()[-1], p0)
    assert np.any(s.acceptance_fraction < 1.0)


def test_autocorr_time_guard():
    W, D = 16, 2
    s = EnsembleSampler(W, D, _log_prob, seed=7, **CPU)
    p0 = 0.1 * np.random.default_rng(3).normal(size=(W, D))
    s.run_mcmc(p0, 10)
    with pytest.raises(RuntimeError, match="too short"):
        s.get_autocorr_time()
    tau_q = s.get_autocorr_time(quiet=True)
    assert tau_q.shape == (D,) and np.all(tau_q >= 1.0)
    s.run_mcmc(None, 1000)
    tau = s.get_autocorr_time(discard=100)
    assert tau.shape == (D,) and np.all(np.isfinite(tau))
    t = EnsembleSampler(8, 2, _log_prob, seed=17, **CPU)
    t.run_mcmc(p0[:8], 1)
    with pytest.raises(RuntimeError, match="too short"):
        t.get_autocorr_time(quiet=True)


def test_constructor_guards():
    with pytest.raises(ValueError, match="even"):
        EnsembleSampler(15, 3, _log_prob, **CPU)
    with pytest.raises(ValueError, match="2\\*ndim"):
        EnsembleSampler(6, 3, _log_prob, **CPU)
    s = EnsembleSampler(8, 2, _log_prob, device="cpu")
    assert s._dtype == torch.get_default_dtype()
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EnsembleSampler(8, 2, _log_prob)
    with pytest.raises(AttributeError, match="run_mcmc"):
        s.get_chain()
    with pytest.raises(ValueError, match="initial_state"):
        s.run_mcmc(None, 5)


def test_reset_does_not_replay_the_stream():
    W, D = 16, 2
    s = EnsembleSampler(W, D, _log_prob, seed=13, **CPU)
    p0 = 0.3 * np.random.default_rng(7).normal(size=(W, D))
    burn_last = s.run_mcmc(p0, 20)
    s.reset()
    s.run_mcmc(None, 20)
    s2 = EnsembleSampler(W, D, _log_prob, seed=13, **CPU)
    s2.run_mcmc(State(burn_last.coords), 20)
    assert not np.array_equal(s.get_chain(), s2.get_chain())


def test_timing_utilities(tmp_path):
    """The gated span: untraced, an untimed span is one shared null
    context and a timed one the host clock's seconds, the counters count
    nothing; under ``profile_to`` a span lands in the Chrome trace (the
    timed seconds inside its interval) and the counters count."""
    timing.reset_counters()
    assert trace_annotation("a") is trace_annotation("b")
    with trace_annotation("joxsz_span", timed=True) as s:
        torch.ones(64).sum()
    assert s.seconds > 0
    timing.count("n", 3)
    assert timing.counters() == {} and not timing.recording()
    with profile_to(str(tmp_path / "prof")):
        assert timing.recording()
        with trace_annotation("joxsz_span", timed=True) as s:
            torch.ones(64).sum()
        with trace_annotation("joxsz_untimed") as u:
            pass
        timing.count("n", 3)
        timing.count("n")
    assert u.seconds == 0.0
    assert timing.counters() == {"n": 4}
    timing.reset_counters()
    assert timing.counters() == {}
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    span, = [e for e in trace["traceEvents"]
             if e.get("name") == "joxsz_span"]
    assert 0 < s.seconds <= span["dur"] * 1e-6 + 2e-6
    assert any(e.get("name") == "joxsz_untimed"
               for e in trace["traceEvents"])
