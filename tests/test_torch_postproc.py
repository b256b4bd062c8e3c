"""Port parity: post-processing (``joxsz_torch.postproc``) against
``joxsz_tpu.postproc``.

On the small synthetic dataset of ``test_torch_build.small_config``,
built through both packages' ``build_session`` from the same config, for
the flagship, config #4 (knots + Vikhlinin T) and SZ-only, the same
posterior-like draws (within 2% of ``synth.truth_theta``, from a numpy
seed) go through both packages in float64:

  * the per-draw profiles of ``make_profile_fns`` and the bands of
    ``compute_profiles``, ``compute_mass_profiles`` (r_500 by 60-step
    bisection, one radius per draw), ``compute_gas_fraction`` and
    ``posterior_predictive``: 1e-9 relative;
  * ``posterior_predictive_pvalues`` with the same ``Generator`` seed:
    identical p-values, discrepancy arrays to 1e-9 relative.

One radius is held apart: for knot pressure the first pressure radius
lies exactly on the first knot, where dP/dr is one-sided.  The JAX
package's ``jnp.log10`` of that radius rounds one ULP below the knot, so
its interpolant clamps there and its HSE mass (and f_gas) is 0 (-0 / inf);
the port's ``torch.log10`` rounds onto the knot and takes the first
segment's slope.  The mass-derived values at such a radius are
therefore checked as finite in the port, and held against the JAX
package everywhere else.

The numpy summaries (``summary_dict``, ``effective_samples``,
``chain_tau_steps``, ``autocorr_function``) and ``check_pin`` agree to
1e-12 on the same arrays.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch import run
from joxsz_torch.build import build_session
from joxsz_torch.postproc import pin as tpin
from joxsz_torch.postproc import ppc as tppc
from joxsz_torch.postproc import profiles as tprof
from joxsz_torch.postproc import summary as tsum
from joxsz_torch.synth import truth_theta
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.config import JoXSZConfig as JaxConfig
from joxsz_tpu.postproc import pin as jpin
from joxsz_tpu.postproc import ppc as jppc
from joxsz_tpu.postproc import profiles as jprof
from joxsz_tpu.postproc import summary as jsum

from test_torch_build import small_config

RTOL = 1e-9          # float64 models, profiles and bands
SUMMARY_TOL = 1e-12  # the numpy summaries on the same arrays

FAMILIES = {"flagship": (), "config4": ("--pressure", "knots",
                                        "--temperature", "vikhlinin"),
            "sz_only": ("--sz-only",)}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """tag -> (port f64 session, JAX f64 session, (S, D) draws)."""
    base = small_config(tmp_path_factory.mktemp("torch_postproc"))
    out = {}
    for i, (tag, flags) in enumerate(FAMILIES.items()):
        args = run.build_parser().parse_args(list(flags))
        cfg = run.apply_model_flags(copy.deepcopy(base), args)
        sess = build_session(cfg, device="cpu", sz_only=args.sz_only)
        jc = JaxConfig.from_json(cfg.to_json())
        jc.dtype = "float64"
        js = jax_build_session(jc, sz_only=args.sz_only, use_cache=False)
        th0 = truth_theta(sess)
        rng = np.random.default_rng(20 + i)
        draws = th0 * (1 + 0.02 * rng.standard_normal((40, th0.size)))
        ok = np.isfinite(sess.model.log_like_batch(
            torch.tensor(draws)).numpy())
        out[tag] = (sess, js, draws[ok])
    return out


def close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=0, equal_nan=True)


def off_knot(sess) -> np.ndarray:
    """Mask of the pressure radii where the JAX package's knot interpolant
    does not clamp: all but a radius on an end knot whose ``jnp.log10``
    rounds outside the knots."""
    r = sess.geometry.r_press_kpc
    knots = getattr(sess.model.pressure, "knots_logr", None)
    if knots is None:
        return np.ones(r.size, bool)
    lr = np.asarray(jnp.log10(jnp.asarray(r)))
    return (lr >= knots[0]) & (lr <= knots[-1])


def close_mass(sess, a, b):
    """Mass-derived profiles (..., n_r): held against the JAX package where
    its interpolant does not clamp; finite in the port there too."""
    a, b, keep = np.asarray(a), np.asarray(b), off_knot(sess)
    close(a[..., keep], b[..., keep])
    assert np.all(np.isfinite(a[..., ~keep]))


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_profile_functions_match_jax(sessions, tag):
    """The eight per-draw thermodynamic profiles and the HSE mass."""
    sess, js, draws = sessions[tag]
    assert len(draws) >= 30
    r = sess.geometry.r_press_kpc
    thermo, mass = tprof.make_profile_fns(sess.model, sess.cosmology, r)
    jthermo, jmass = jprof.make_profile_fns(js.model, js.cosmology, r)
    with torch.no_grad():
        got = thermo(torch.tensor(draws))
        got_m = mass(torch.tensor(draws))
    want = jthermo(draws)
    for a, b in zip(got[:7], want[:7]):
        close(a.numpy(), b)
    close_mass(sess, got[7].numpy(), want[7])
    close_mass(sess, got_m.numpy(), jmass(draws))
    assert (tag == "config4") == (not off_knot(sess).all())
    tcool = got[5].numpy()
    assert np.all(np.isnan(tcool)) == (tag == "sz_only")


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_profile_bands_match_jax(sessions, tag):
    """compute_profiles in batches (here 16 rows) against the JAX bands."""
    sess, js, draws = sessions[tag]
    r = sess.geometry.r_press_kpc
    a = tprof.compute_profiles(sess.model, sess.cosmology, r, draws,
                               batch=16)
    b = jprof.compute_profiles(js.model, js.cosmology, r, draws, batch=16)
    for f in ("density", "temp_sz", "temp_x", "pressure", "entropy",
              "cooling_time", "gas_mass"):
        assert getattr(a, f).shape == (3, r.size)
        close(getattr(a, f), getattr(b, f))
    close_mass(sess, a.gas_fraction, b.gas_fraction)


@pytest.mark.parametrize("delta", [500.0, 5000.0])
@pytest.mark.parametrize("tag", list(FAMILIES))
def test_mass_bands_and_r_delta_match_jax(sessions, tag, delta):
    """HSE mass bands, r_Delta and M_Delta (bisection, per-draw radii) and
    the f_gas bands.  The small grid ends near r_500 (where the bracket
    saturates); r_5000 lies inside it."""
    sess, js, draws = sessions[tag]
    r = sess.geometry.r_press_kpc
    got = tprof.compute_mass_profiles(sess.model, sess.cosmology, r, draws,
                                      delta=delta)
    want = jprof.compute_mass_profiles(js.model, js.cosmology, r, draws,
                                       delta=delta)
    close_mass(sess, got[0], want[0])
    close(got[1], want[1])          # r_Delta
    close(got[2], want[2])          # M_Delta
    rd = got[1][:, 0]
    assert r[0] < rd.min() and rd.max() <= r[-1]
    if delta > 500:
        assert rd.max() < 0.9 * r[-1]
    close_mass(sess, tprof.compute_gas_fraction(sess.model, sess.cosmology,
                                                r, draws),
               jprof.compute_gas_fraction(js.model, js.cosmology, r, draws))


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_predictive_bands_match_jax(sessions, tag):
    sess, js, draws = sessions[tag]
    px, psz = tprof.posterior_predictive(sess.model, draws, batch=16)
    jx, jsz = jprof.posterior_predictive(js.model, draws, batch=16)
    close(psz, jsz)
    if tag == "sz_only":
        assert px is None and jx is None
    else:
        close(px, jx)


def test_band_subsample_stride():
    """Above the cap the bands take the same stride subsample."""
    flat = np.arange(1000.0)[:, None]
    np.testing.assert_array_equal(tprof._band_subsample(flat, 300),
                                  jprof._band_subsample(flat, 300))
    assert tprof._MAX_BAND_SAMPLES == jprof._MAX_BAND_SAMPLES == 131072


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_ppc_matches_jax_with_the_same_seed(sessions, tag):
    sess, js, draws = sessions[tag]
    a = tppc.posterior_predictive_pvalues(sess.model, draws,
                                          np.random.default_rng(777))
    b = jppc.posterior_predictive_pvalues(js.model, draws,
                                          np.random.default_rng(777))
    assert a.p_sz == b.p_sz and a.p_xray == b.p_xray
    assert 0.0 <= a.p_sz <= 1.0
    close(a.sz_obs, b.sz_obs)
    close(a.sz_rep, b.sz_rep)
    if tag == "sz_only":
        assert a.p_xray is None and a.xray_obs is None
    else:
        close(a.xray_obs, b.xray_obs)
        close(a.xray_rep, b.xray_rep)


def test_ppc_rejects_out_of_support_draws(sessions):
    sess, _, draws = sessions["flagship"]
    bad = draws[:2].copy()
    bad[:, sess.params.thawed.index("backscale")] = -50.0
    with pytest.raises(ValueError, match="non-positive"):
        tppc.posterior_predictive_pvalues(sess.model, bad,
                                          np.random.default_rng(0))


def _ar1(rho, n, w, d, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, w, d))
    x[0] = rng.standard_normal((w, d))
    e = rng.standard_normal((n, w, d))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * e[t]
    return x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_summary_functions_match_jax(dtype):
    chain = _ar1(0.8, 600, 12, 3, 4).astype(dtype)
    names, units = ["a", "b", "c"], ["kpc", ".", "keV"]
    a = tsum.summary_dict(chain.reshape(-1, 3), names, units=units, ci=68,
                          chain_3d=chain)
    b = jsum.summary_dict(chain.reshape(-1, 3), names, units=units, ci=68,
                          chain_3d=chain)
    assert a.keys() == b.keys() and a["ci"] == b["ci"]
    for n in names:
        assert a["parameters"][n].keys() == b["parameters"][n].keys()
        for k, v in a["parameters"][n].items():
            if k == "unit":
                assert v == b["parameters"][n][k]
            else:
                close(v, b["parameters"][n][k], SUMMARY_TOL)
    close(tsum.effective_samples(chain), jsum.effective_samples(chain),
          SUMMARY_TOL)
    close(tsum.chain_tau_steps(chain, 2.5), jsum.chain_tau_steps(chain, 2.5),
          SUMMARY_TOL)
    close(tsum.autocorr_function(chain[:, 0, 0]),
          jsum.autocorr_function(chain[:, 0, 0]), SUMMARY_TOL)


def test_save_summary_round_trip(tmp_path):
    chain = _ar1(0.5, 200, 8, 2, 5)
    s = tsum.summary_dict(chain.reshape(-1, 2), ["x", "y"], chain_3d=chain)
    tsum.save_summary(str(tmp_path / "sub" / "s.json"), s)
    import json
    assert json.loads((tmp_path / "sub" / "s.json").read_text()) == s


def test_collect_kernel_subchain_slices_and_joins():
    blocks = [torch.arange(i * 60, (i + 1) * 60, dtype=torch.float32)
              .reshape(2, 6, 5) for i in range(3)]
    out = tsum.collect_kernel_subchain(lambda i: blocks[i], 3, n_sub=4,
                                       ndim=2)
    want = np.concatenate([b[:, :4, :2].numpy() for b in blocks])
    np.testing.assert_array_equal(out, want)


def _perturbed_summary(pin, shift_sd):
    s = copy.deepcopy(pin)
    for name, p in s["parameters"].items():
        p["median"] = float(p["median"]) + shift_sd * float(p["std"])
    return s


@pytest.mark.parametrize("mode", ["exact", "fresh"])
@pytest.mark.parametrize("shift_sd", [0.0, 0.1, 0.5])
def test_check_pin_matches_jax(mode, shift_sd):
    """The same pin file; the same verdict and report lines."""
    pin = tpin.load_pin()
    assert pin == jpin.load_pin()
    summary = _perturbed_summary(pin, shift_sd)
    a = tpin.check_pin(summary, pin, mode=mode)
    b = jpin.check_pin(summary, pin, mode=mode)
    assert a == b
    assert a[0] == (shift_sd == 0.0 or (mode == "fresh" and shift_sd < 0.2))


def test_check_pin_missing_parameter_and_bad_mode():
    pin = tpin.load_pin()
    summary = copy.deepcopy(pin)
    summary["parameters"].pop(next(iter(summary["parameters"])))
    ok, report = tpin.check_pin(summary, pin)
    assert not ok and "differs from pin" in report[0]
    with pytest.raises(ValueError):
        tpin.check_pin(summary, pin, mode="loose")
