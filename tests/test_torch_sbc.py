"""Port parity: simulation-based calibration (``joxsz_torch/sampling/
sbc.py``).

``sbc_uniformity`` equals the JAX function on the same ranks; ``run_sbc``
on the small synthetic SZ-only session draws the JAX package's
``thetas_true`` bit for bit for one seed (the prior draws on the numpy
seed), and runs on the joint session (the plain batched ensembles on the
CPU; kernel 4 on the card, ``chip_smoke.py`` phase 22); the conjugate
Gaussian pipeline on the port's batched ensembles gives uniform ranks,
and a deliberately overconfident one is detected.  The float32 check
that guards SBC on the card passes the production prior box (kernel 1's
plain version vetoes none of the draws float64 keeps, where the JAX
kernels' float32 form vetoed a third) and the JAX SBC test's narrow box;
its check of the replications' mock data passes the narrow box and
fails the production box, whose corners' mock fluxes pass float32's
precision.
"""

import copy

import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.sampling.priors import model_log_prior, sample_prior
from joxsz_torch.sampling.sbc import (F32_CHECK_DRAWS, F32_VETO_TOLERANCE,
                                      float32_misfits, float32_vetoed,
                                      run_batched_ensembles, run_sbc,
                                      sbc_mocks, sbc_uniformity)
from joxsz_torch.synth import write_synthetic_dataset
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.sampling.sbc import run_sbc as jax_run_sbc
from joxsz_tpu.sampling.sbc import sbc_uniformity as jax_sbc_uniformity

from test_torch_build import single_thread, small_config  # noqa: F401
from test_torch_families import family_configs

pytestmark = pytest.mark.usefixtures("single_thread")


def test_uniformity_matches_jax():
    rng = np.random.default_rng(0)
    ranks = rng.integers(0, 101, size=(400, 3))
    for n_bins in (None, 7, 8, 101):
        p, c = sbc_uniformity(ranks, 100, n_bins=n_bins)
        jp, jc = jax_sbc_uniformity(ranks, 100, n_bins=n_bins)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(p, jp, rtol=1e-12)
    assert (sbc_uniformity(ranks, 100)[0] > 1e-3).all()
    with pytest.raises(ValueError, match="n_bins"):
        sbc_uniformity(ranks, 100, n_bins=1)


@pytest.fixture(scope="module")
def base_config(tmp_path_factory):
    return small_config(tmp_path_factory.mktemp("torch_sbc"))


def test_run_sbc_sz_only_draws_the_jax_truths(base_config):
    cfg, jc, _ = family_configs(base_config, ("--sz-only",))
    sess = build_session(cfg, device="cpu", sz_only=True)
    jc.dtype = "float64"
    js = jax_build_session(copy.deepcopy(jc), sz_only=True, use_cache=False)
    res = run_sbc(sess, 6, n_walkers=24, n_burn=10, n_steps=20, thin=10,
                  seed=3)
    jres = jax_run_sbc(js.model, 6, n_walkers=24, n_burn=0, n_steps=10,
                       thin=10, seed=3)
    assert np.array_equal(res.thetas_true, jres.thetas_true)
    assert res.ranks.shape == (6, sess.params.ndim) and res.n_draws == 48
    assert res.ranks.min() >= 0 and res.ranks.max() <= res.n_draws
    assert res.names == list(jres.names)


def test_run_sbc_joint_runs(base_config):
    """The joint session: truths in the prior's support with a positive
    predicted X-ray profile, ranks in [0, L], finite p-values."""
    sess = build_session(base_config, device="cpu")
    res = run_sbc(sess, 5, n_walkers=32, n_burn=10, n_steps=20, thin=10,
                  seed=2, n_bins=3)
    assert res.ranks.shape == (5, 13) and res.n_draws == 64
    assert res.ranks.min() >= 0 and res.ranks.max() <= 64
    assert np.isfinite(res.p_values).all() and res.counts.shape == (13, 3)
    th = torch.as_tensor(res.thetas_true)
    assert torch.isfinite(sess.model.log_prior_only(th)).all()
    assert (sess.model.xray_profiles(th) >= 0).all()
    assert res.acceptance.shape == (5, 32) and 0 < res.acceptance.mean() < 1
    name, worst = res.worst()
    assert name in res.names and 0.0 <= worst <= 1.0


# the prior box of the JAX package's SBC test on the joint model
# (tests/test_sbc.py::test_run_sbc_joint_model_smoke)
TIGHT_BOX = {"log(n_0)": (-1.55, -1.25), r"\beta": (0.58, 0.72),
             "log(r_c)": (1.85, 2.2), "log(r_s)": (2.2, 3.4),
             r"\epsilon": (0.0, 2.0), "log(T_X/T_{SZ})": (-0.2, 0.3),
             "Z": (0.0, 0.6), "P_0": (0.1, 0.4), "a": (0.8, 5.0),
             "b": (2.0, 4.0), "r_p": (110.0, 350.0)}


@pytest.mark.parametrize("box", ["production", "tight"])
def test_float32_check_covers_only_the_narrow_box(tmp_path, box):
    """Out to 5000 kpc, as the production grid: at the production box's
    low-density corners n_e^2 underflows float32, and kernel 1's mass
    veto still keeps what float64 keeps (n_e from ln n_e^2, the mass
    scaled and as a signed logarithm); inside the narrow box too."""
    cfg = write_synthetic_dataset(str(tmp_path), 3, n_annuli=6, n_sz=6,
                                  max_radius_arcsec=30.0)
    sess = build_session(cfg, device="cpu")
    if box == "tight":
        for name, (lo, hi) in TIGHT_BOX.items():
            sess.params[name].minval, sess.params[name].maxval = lo, hi
        sess.params._refresh()
    m = sess.model
    th = sample_prior(model_log_prior(m), m.params, F32_CHECK_DRAWS,
                      np.random.default_rng(2))
    lost, live = float32_vetoed(sess, th)
    if box == "tight":
        assert live == F32_CHECK_DRAWS
    assert live > 0 and lost <= F32_VETO_TOLERANCE * live, (lost, live)


@pytest.mark.parametrize("box", ["production", "tight"])
def test_float32_mock_check(tmp_path, box):
    """The second float32 check of ``run_sbc`` on the card: at the
    production box's corners the mock data's SZ fluxes pass float32's
    precision against their errors, and kernel 1's log-posterior at most
    replications' truths misses the float64 model's; inside the narrow
    box it matches at every truth."""
    cfg = write_synthetic_dataset(str(tmp_path), 3, n_annuli=6, n_sz=6,
                                  max_radius_arcsec=30.0)
    sess = build_session(cfg, device="cpu")
    if box == "tight":
        for name, (lo, hi) in TIGHT_BOX.items():
            sess.params[name].minval, sess.params[name].maxval = lo, hi
        sess.params._refresh()
    thetas, survey = sbc_mocks(sess.model, 32, 3)
    bad, n = float32_misfits(sess, thetas, survey)
    if box == "tight":
        assert (bad, n) == (0, 32)
    else:
        assert bad > n // 2, (bad, n)


def _conjugate_ranks(fit_sigma_scale=1.0, n_reps=256, seed=0):
    """theta* ~ N(0, s^2 I_2), y ~ N(theta*, t^2 I_2); the ensembles fit
    with likelihood width ``fit_sigma_scale * t``."""
    s, t = 1.3, 0.6
    D, W = 2, 32
    rng = np.random.default_rng(seed)
    thetas = rng.normal(0.0, s, size=(n_reps, D))
    ys = torch.as_tensor(thetas + rng.normal(0.0, t, size=thetas.shape))
    tf = fit_sigma_scale * t

    def llcb(x):                       # (C, W, D) -> (C, W)
        d = x - ys[:, None, :]
        return -0.5 * (x * x).sum(-1) / s ** 2 - 0.5 * (d * d).sum(-1) / tf ** 2

    p0 = torch.as_tensor(thetas[:, None, :]
                         + 0.1 * rng.standard_normal((n_reps, W, D)))
    g = torch.Generator()
    g.manual_seed(seed + 1)
    chain, _, acc, _ = run_batched_ensembles(llcb, p0, 400, 400, g, thin=20)
    draws = chain.transpose(1, 0, 2, 3).reshape(n_reps, -1, D)
    return (draws < thetas[:, None, :]).sum(axis=1), draws.shape[1], acc


def test_calibrated_conjugate_pipeline_is_uniform():
    ranks, L, acc = _conjugate_ranks(1.0)
    assert ranks.min() >= 0 and ranks.max() <= L
    p, counts = sbc_uniformity(ranks, L, n_bins=8)
    assert (p > 0.01).all(), p
    assert counts.sum(axis=1).tolist() == [256, 256]
    assert 0.2 < acc.mean() < 0.95


def test_miscalibrated_posterior_is_detected():
    ranks, L, _ = _conjugate_ranks(0.4, seed=3)
    p, _ = sbc_uniformity(ranks, L, n_bins=8)
    assert (p < 1e-4).all(), p
