"""Port parity: the fused SZ core against ``pallas_kernels.make_sz_core``.

``joxsz_torch.ops.sz_core.sz_core_plain`` is the arithmetic of the CUDA
kernel ``csrc/sz_core.cu`` in plain torch.  The same inputs, made from a
seed with numpy (pressure profiles, temperatures inside and outside the
conversion table, calibrations), go through it and through the JAX
function: its Pallas kernel in interpret mode (float32), its jnp path
(float32 and float64).  Tolerances: 1e-5 relative to |ll| in float32 (the
two packages order the 50- and 42-term sums differently and the port
multiplies by a precomputed slope where JAX divides), 1e-9 in float64.
Flux points with a NaN flux, a NaN error or a zero error add nothing in
both; a NaN temperature or pressure gives a NaN in both.

The CUDA kernel itself runs only on a card: the ``gpu`` test skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.io.readers import read_conversion_table, read_xy
from joxsz_torch.ops.sz_core import (make_sz_core, pack_sz_consts, sz_core,
                                     sz_core_bytes, sz_core_flops,
                                     sz_core_plain, sz_padded_data)
from joxsz_tpu.ops.pallas_kernels import (make_sz_core as jax_make_sz_core,
                                          sz_padded_data as jax_padded)

from test_torch_build import jax_session, small_config

B = 13          # not a multiple of the Pallas block: its padding is crossed


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_sz_core"))
    sess = build_session(cfg, device="cpu")
    js = jax_session(cfg)
    conv = read_conversion_table(cfg.sz.conversion_file)
    _, flux, err = (np.array(a) for a in read_xy(cfg.sz.flux_file, ncol=3))
    # one NaN flux, one NaN error, one zero error: three dead points
    flux[1], err[2], err[4] = np.nan, np.nan, 0.0
    return sess, js, conv, flux, err


def _inputs(sess, seed: int):
    """pp (B, n_press), t_all (B, n_pix), cal (B,) float64: rows 0-1 above
    the table's last knot, rows 2-3 below its first, the rest inside."""
    rng = np.random.default_rng(seed)
    r = sess.model.sz_data.r_press_kpc.numpy()
    n_pix = sess.model.sz_data.sep + 1
    x = r / 300.0
    pp0 = 0.18 / (x ** 0.014 * (1 + x ** 5.0) ** (2.2 / 5.0))
    pp = pp0[None] * (1 + 0.05 * rng.standard_normal((B, r.size)))
    t_all = 8.0 * (1 + 0.1 * rng.standard_normal((B, n_pix)))
    t_all[:2] += 45.0
    t_all[2:4] -= 12.0
    cal = 1.0 + 0.05 * rng.standard_normal(B)
    return pp, t_all, cal


def _jax_core(js, conv, flux, err, dtype, **kw):
    core = jax_make_sz_core(js.sz_operator, conv, flux, err, dtype=dtype,
                            block_b=8, **kw)
    return lambda pp, t, cal: np.asarray(core(
        jnp.asarray(pp, dtype), jnp.asarray(t, dtype),
        jnp.asarray(cal, dtype)), dtype=np.float64)


def _port(sess, conv, flux, err, pp, t, cal, dtype):
    c = pack_sz_consts(sess.sz_operator, conv, flux, err, "cpu")
    return sz_core_plain(torch.tensor(pp, dtype=dtype),
                         torch.tensor(t, dtype=dtype),
                         torch.tensor(cal, dtype=dtype), c).double().numpy()


@pytest.mark.parametrize("route", ["pallas_interpret", "jnp"])
def test_plain_matches_jax_float32(setup, route):
    sess, js, conv, flux, err = setup
    pp, t, cal = _inputs(sess, 1)
    assert (t[:2] > conv[0][-1]).all() and (t[2:4] < conv[0][0]).all()
    kw = (dict(use_pallas=True, interpret=True) if route == "pallas_interpret"
          else dict(use_pallas=False))
    b = _jax_core(js, conv, flux, err, jnp.float32, **kw)(pp, t, cal)
    a = _port(sess, conv, flux, err, pp, t, cal, torch.float32)
    assert a.shape == (B,) and np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


def test_plain_matches_jax_float64(setup):
    sess, js, conv, flux, err = setup
    pp, t, cal = _inputs(sess, 2)
    b = _jax_core(js, conv, flux, err, jnp.float64, use_pallas=False)(
        pp, t, cal)
    a = _port(sess, conv, flux, err, pp, t, cal, torch.float64)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_dead_points_add_nothing(setup):
    """The three dead flux points weigh 0: changing the model there (by
    dropping them from the data and the operator) changes nothing."""
    sess, _, conv, flux, err = setup
    pp, t, cal = _inputs(sess, 3)
    a = _port(sess, conv, flux, err, pp, t, cal, torch.float64)
    live = np.isfinite(flux) & np.isfinite(err) & (err != 0)
    assert live.sum() == flux.size - 3
    c = pack_sz_consts(sess.sz_operator, conv, flux, err, "cpu")
    A = c.arrays64
    raw = torch.tensor(pp) @ A["LT"]
    conv_v = np.interp(t, *conv)          # inside the table only
    prof = raw.numpy() * conv_v * cal[:, None]
    model = prof @ A["GT"].numpy()
    want = -0.5 * np.sum(((flux - model)[:, live] / err[live]) ** 2, axis=1)
    np.testing.assert_allclose(a[4:], want[4:], rtol=1e-9)


def test_nan_inputs_propagate(setup):
    sess, js, conv, flux, err = setup
    pp, t, cal = _inputs(sess, 4)
    t[5, 3] = np.nan
    pp[6, 7] = np.nan
    a = _port(sess, conv, flux, err, pp, t, cal, torch.float32)
    b = _jax_core(js, conv, flux, err, jnp.float32, use_pallas=False)(
        pp, t, cal)
    assert np.isnan(a[[5, 6]]).all() and np.isnan(b[[5, 6]]).all()
    keep = np.ones(B, bool)
    keep[[5, 6]] = False
    assert np.all(np.isfinite(a[keep]))


def test_sz_padded_data_is_the_jax_rule(setup):
    _, _, _, flux, err = setup
    f, w = sz_padded_data(flux, err)
    jf, jw = jax_padded(flux, err, 128)
    np.testing.assert_array_equal(f, jf[:flux.size])
    np.testing.assert_array_equal(w, jw[:flux.size])
    assert (w == 0).sum() == 3 and (f[w == 0] == 0).all()


def test_wrapper_runs_plain_version_on_cpu(setup):
    sess, _, conv, flux, err = setup
    pp, t, cal = (torch.tensor(a) for a in _inputs(sess, 5))
    core = make_sz_core(sess.sz_operator, conv, flux, err, "cpu")
    before = sz_core.launches
    out = core(pp, t, cal)
    assert sz_core.launches == before
    assert out.dtype == torch.float64
    assert torch.equal(out, sz_core_plain(pp, t, cal, core.consts))
    out32 = core(pp.float(), t.float(), cal.float())
    assert out32.dtype == torch.float32
    with pytest.raises(ValueError, match="want pp"):
        core(pp[:, :-1], t, cal)
    with pytest.raises(ValueError, match="want pp"):
        core(pp, t, cal[:, None])


def test_consts_and_counts(setup):
    sess, _, conv, flux, err = setup
    c = pack_sz_consts(sess.sz_operator, conv, flux, err, "cpu")
    I = c.ints
    n_pix, n_press = sess.sz_operator.L.shape
    assert (I["n_pix"], I["n_press"], I["n_data"]) == (n_pix, n_press, 6)
    assert I["n_conv"] == conv[0].size and I["sep"] == n_pix - 1
    np.testing.assert_allclose(c.arrays["LT"].numpy(),
                               sess.sz_operator.L.T.astype(np.float32))
    assert c.buf.dtype == torch.float32 and c.buf.dim() == 1
    assert sz_core_flops(c) >= 2 * n_press * n_pix + 2 * n_pix * 6
    assert sz_core_bytes(c, 10) == 4 * (10 * (n_press + n_pix + 2)
                                        + c.buf.numel())


@pytest.mark.parametrize("t_keV, ok", [
    ([0.0, 5.0, 10.0, 20.0], True),
    ([0.0, 5.0, 5.0, 20.0], True),          # a repeated knot
    ([0.0, 10.0, 5.0, 20.0], False),
    ([5.0], False),
])
def test_conversion_table_must_not_decrease(setup, t_keV, ok):
    """The kernels find the lerp's segment by bisection: the packer takes
    a table whose temperatures never decrease and refuses any other."""
    sess, _, conv, flux, err = setup
    t = np.asarray(t_keV)
    table = (t, -11.0 * (1 - 0.017 * t))
    if ok:
        c = pack_sz_consts(sess.sz_operator, table, flux, err, "cpu")
        assert c.ints["n_conv"] == t.size
    else:
        with pytest.raises(ValueError, match="non-decreasing"):
            pack_sz_consts(sess.sz_operator, table, flux, err, "cpu")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sess, _, conv, flux, err = setup
    core = make_sz_core(sess.sz_operator, conv, flux, err, "cuda")
    pp, t, cal = (torch.tensor(a, dtype=torch.float32, device="cuda")
                  for a in _inputs(sess, 6))
    a = core(pp, t, cal).cpu().numpy()
    b = sz_core_plain(pp, t, cal, core.consts).cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-3)
