"""Port parity: the plain-torch models against ``joxsz_tpu.models``.

The same float64 parameter rows, made from a seed with numpy, go through
the port's batched functions and through ``jax.vmap`` of the JAX
package's per-walker functions, on sessions built by both packages from
one small synthetic dataset.  Values agree to 1e-9 relative and the veto
masks are identical, on rows that cover every veto: the prior box,
r_c > r_s, the HSE-mass monotonicity and the X-ray positivity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.models.sz import sz_log_like as t_sz_log_like
from joxsz_torch.models.xray import (predicted_counts as t_predicted,
                                     xray_log_like as t_xray_log_like)
from joxsz_tpu.models.sz import sz_log_like as j_sz_log_like
from joxsz_tpu.models.xray import (predicted_counts as j_predicted,
                                   xray_log_like as j_xray_log_like)

from test_torch_build import jax_session, small_config, truth_rows

RTOL = 1e-9


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_models"))
    return build_session(cfg, device="cpu"), jax_session(cfg)


def veto_rows(params, n: int = 24, seed: int = 11):
    """Draws around TRUTH, then one row per veto kind at the end:
    out of the box, r_c > r_s, falling HSE mass, negative prediction."""
    rows = truth_rows(params, n, seed)
    ix = params.thawed.index
    box = rows[0].copy()
    box[ix("P_0")] = -0.5
    rcrs = rows[1].copy()
    rcrs[ix("log(r_c)")], rcrs[ix("log(r_s)")] = 2.5, 2.3
    mass = rows[2].copy()
    mass[ix("b")], mass[ix("a")], mass[ix("r_p")] = 14.0, 5.0, 150.0
    mass[ix(r"\beta")] = 0.2
    pos = rows[3].copy()
    pos[ix("backscale")] = -1e3
    return np.concatenate([rows, np.stack([box, rcrs, mass, pos])])


def test_veto_rows_hit_each_veto(sessions):
    """Each of the last four rows is vetoed by its own rule alone."""
    sess, _ = sessions
    m, p = sess.model, sess.params
    rows = torch.tensor(veto_rows(p))
    pars = p.unpack(rows)
    prior = p.log_prior(rows)
    dens = m.density.log_prior(pars)
    mass = m._mass_veto_ok(pars, m.sz_data.r_press_kpc)
    xll = t_xray_log_like(pars, m.xray_data, m.density, m.temperature)
    ll = m.log_like_batch(rows)
    assert bool(torch.isfinite(ll[:-4]).all())
    assert not bool(torch.isfinite(ll[-4:]).any())
    assert not torch.isfinite(prior[-4])
    assert torch.isfinite(prior[-3]) and not torch.isfinite(dens[-3])
    assert torch.isfinite(prior[-2] + dens[-2]) and not mass[-2]
    assert torch.isfinite(prior[-1] + dens[-1]) and bool(mass[-1])
    assert not torch.isfinite(xll[-1])


def test_log_like_batch_matches_jax(sessions):
    sess, js = sessions
    rows = veto_rows(sess.params)
    a = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    b = np.asarray(jax.jit(jax.vmap(js.log_like))(jnp.asarray(rows)))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert fin.sum() == rows.shape[0] - 4
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=0)


def test_log_like_scalar_matches_batch(sessions):
    sess, _ = sessions
    rows = torch.tensor(truth_rows(sess.params, 3, seed=2))
    batch = sess.model.log_like_batch(rows)
    for i in range(3):
        assert float(sess.model.log_like(rows[i])) == float(batch[i])


def _components(sess, js):
    """name -> (port fn of (B, D) tensor, JAX fn of one (D,) row)."""
    m, jm = sess.model, js.model
    r = m.sz_data.r_press_kpc
    jr = jm.sz_data.r_press_kpc
    rm = m.xray_data.midpt_kpc
    jrm = jm.xray_data.midpt_kpc
    up, jup = sess.params.unpack, js.params.unpack
    return {
        "pressure": (lambda t: m.pressure(up(t), r),
                     lambda t: jm.pressure(jup(t), jr)),
        "pressure_derivative": (lambda t: m.pressure.derivative(up(t), r),
                                lambda t: jm.pressure.derivative(jup(t), jr)),
        "density": (lambda t: m.density(up(t), rm),
                    lambda t: jm.density(jup(t), jrm)),
        "density_prior": (lambda t: m.density.log_prior(up(t)),
                          lambda t: jm.density.log_prior(jup(t))),
        "t_sz": (lambda t: m.temperature.t_sz(up(t), r),
                 lambda t: jm.temperature.t_sz(jup(t), jr)),
        "t_x": (lambda t: m.temperature.t_x(up(t), rm),
                lambda t: jm.temperature.t_x(jup(t), jrm)),
        "hse_mass": (lambda t: m.mass(up(t), r),
                     lambda t: jm.mass(jup(t), jr)),
        "mass_veto": (lambda t: m._mass_veto_ok(up(t), r),
                      lambda t: jm._mass_veto_ok(jup(t), jr)),
        "param_prior": (sess.params.log_prior, js.params.log_prior),
        "sz_log_like": (
            lambda t: t_sz_log_like(up(t), m.sz_data, m.pressure,
                                    m.temperature),
            lambda t: j_sz_log_like(jup(t), jm.sz_data, jm.pressure,
                                    jm.temperature)),
        "predicted_counts": (
            lambda t: t_predicted(up(t), m.xray_data, m.density,
                                  m.temperature),
            lambda t: j_predicted(jup(t), jm.xray_data, jm.density,
                                  jm.temperature)),
        "xray_log_like": (
            lambda t: t_xray_log_like(up(t), m.xray_data, m.density,
                                      m.temperature),
            lambda t: j_xray_log_like(jup(t), jm.xray_data, jm.density,
                                      jm.temperature)),
    }


COMPONENTS = ["pressure", "pressure_derivative", "density", "density_prior",
              "t_sz", "t_x", "hse_mass", "mass_veto", "param_prior",
              "sz_log_like", "predicted_counts", "xray_log_like"]


@pytest.mark.parametrize("name", COMPONENTS)
def test_component_matches_jax(sessions, name):
    sess, js = sessions
    port_fn, jax_fn = _components(sess, js)[name]
    rows = veto_rows(sess.params)
    a = port_fn(torch.tensor(rows)).numpy().astype(float)
    b = np.asarray(jax.vmap(jax_fn)(jnp.asarray(rows))).astype(float)
    a = a.reshape(b.shape)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), name
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=1e-300,
                               err_msg=name)


def test_autograd_gradient_matches_jax(sessions):
    """The MLE's gradient: torch autograd of the float64 log-posterior
    against ``jax.grad`` of the JAX package's."""
    sess, js = sessions
    rows = truth_rows(sess.params, 3, seed=8)
    for th in rows:
        t = torch.tensor(th, requires_grad=True)
        (g,) = torch.autograd.grad(sess.model.log_like(t), t)
        jg = np.asarray(jax.grad(js.log_like)(jnp.asarray(th)))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-7,
                                   atol=1e-9 * np.abs(jg).max())
