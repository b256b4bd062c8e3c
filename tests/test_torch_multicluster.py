"""Port parity: the multi-cluster likelihood, constants and half-step.

C clusters that share one instrument and differ in their data (flux
scaled per cluster, counts shifted per cluster, one with the
integrated-Y centre moved) are stacked in both packages from the same
numpy arrays: ``port_stacks_from_jax`` carries the JAX package's stacked
``SZData``/``XrayData`` across as numpy, so both sides of every
comparison compute on identical data.

* ``make_multicluster_log_like`` against ``joxsz_tpu.models.multicluster``
  with ``flatten=True`` and ``False``: float64, rtol 1e-9;
* ``pack_consts_stack`` against ``make_multicluster_consts(device=False)``
  array by array (the TPU's lane padding cut off), and ``StackMismatch``
  on every mismatch ``_cluster_arrays`` names;
* ``half_step_multicluster_plain`` against ``make_multicluster_step_
  kernel(interpret=True, thin=1)`` step for step, and the plain path of
  one launch of the cluster-grid step kernel (``steps_multicluster_
  plain``) over a chunk of n_inner = 4 steps at thin 1 and 2, both fed
  the interpret-mode hash bits (with the cluster id folded in): frames
  shaped as the JAX chain, positions to 1e-5, accept counts equal, lp at
  rtol 2e-4 / atol 0.5 (float32 roundoff of ~1e4-magnitude sums in two
  arithmetic orders);
* ``simulate_survey``: shapes, the original mask kept, the support guard.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.models import CountRateTable, SZData, XrayData
from joxsz_torch.models.multicluster import (make_multicluster_log_like,
                                             stack_sz_data, stack_xray_data,
                                             unstack)
from joxsz_torch.ops.joint_kernel import (StackMismatch, joint_ll_plain,
                                          pack_consts, pack_consts_stack)
from joxsz_torch.ops.multicluster_kernel import (
    half_step_multicluster_plain, multicluster_bits, multicluster_ll,
    multicluster_ll_plain, steps_multicluster_plain,
    stretch_steps_multicluster)
from joxsz_torch.ops.step_kernel import philox_stream
from joxsz_torch.sampling.kernel import run_multicluster_steps
from joxsz_torch.simulate import simulate_observation, simulate_survey
from joxsz_tpu.models import multicluster as jmc
from joxsz_tpu.ops.pallas_joint import (_build_spec, make_joint_core,
                                        make_multicluster_consts,
                                        make_multicluster_step_kernel)

from test_torch_build import jax_session, small_config, truth_rows
from test_torch_models import veto_rows

C, W, STEPS, SEED = 3, 16, 3, 9
RTOL, ATOL = 2e-4, 0.5


def jax_stacks(js, n: int):
    """n clusters on the JAX side: flux x (1 + 0.05 c), counts + c, and
    the integrated-Y centre x (1 + 0.1 c) (live only with calc_integ)."""
    sz0, xr0 = js.model.sz_data, js.model.xray_data
    szs = [dataclasses.replace(sz0, flux=sz0.flux * (1 + 0.05 * c),
                               integ_mu=float(sz0.integ_mu) * (1 + 0.1 * c))
           for c in range(n)]
    xrs = [dataclasses.replace(xr0, counts=xr0.counts + c,
                               counts_filled=xr0.counts_filled + c)
           for c in range(n)]
    return jmc.stack_sz_data(szs), jmc.stack_xray_data(xrs)


def port_stacks_from_jax(jsz, jxr, dtype=torch.float64):
    """The port's stacked containers holding the numbers of the JAX
    package's stacked ones (``jxr`` None: an SZ-only stack, X-ray None)."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype)

    n = np.asarray(jsz.L).shape[0]
    sz = SZData(
        L=t(jsz.L), G=t(jsz.G), w_T0=t(jsz.w_T0), integ_w=t(jsz.integ_w),
        conv_T=t(jsz.conv_T), conv_val=t(jsz.conv_val), flux_r=t(jsz.flux_r),
        flux=t(jsz.flux), flux_err=t(jsz.flux_err),
        r_press_kpc=t(jsz.r_press_kpc), sep=int(jsz.sep),
        calc_integ=bool(jsz.calc_integ),
        integ_mu=t(np.broadcast_to(np.asarray(jsz.integ_mu), (n,))),
        integ_sig=t(np.broadcast_to(np.asarray(jsz.integ_sig), (n,))))
    if jxr is None:
        return sz, None
    tab = jxr.table
    xr = XrayData(
        counts_mask=t(jxr.counts_mask), counts_filled=t(jxr.counts_filled),
        exposures=t(jxr.exposures), areascales=t(jxr.areascales),
        areas=t(jxr.areas), backrates=t(jxr.backrates),
        vols_norm=t(jxr.vols_norm), midpt_kpc=t(jxr.midpt_kpc),
        norm_per_cm3=t(np.broadcast_to(np.asarray(jxr.norm_per_cm3), (n,))),
        table=CountRateTable(Tlog=t(tab.Tlog), lograte_Z0=t(tab.lograte_Z0),
                             lograte_Z1=t(tab.lograte_Z1)))
    return sz, xr


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_mc"))
    sess = build_session(cfg, device="cpu")
    js = jax_session(cfg)
    js32 = jax_session(cfg, "float32")
    jsz, jxr = jax_stacks(js, C)
    jsz32, jxr32 = jax_stacks(js32, C)
    return dict(cfg=cfg, sess=sess, js=js, js32=js32, jax=(jsz, jxr),
                jax32=(jsz32, jxr32), port=port_stacks_from_jax(jsz, jxr),
                port32=port_stacks_from_jax(jsz32, jxr32))


# -- stacking ---------------------------------------------------------------

def test_stack_unstack_roundtrip(setup):
    sess = setup["sess"]
    sz0, xr0 = sess.model.sz_data, sess.model.xray_data
    szs = [dataclasses.replace(sz0, flux=sz0.flux * (1 + 0.05 * c),
                               integ_mu=0.001 * (c + 1)) for c in range(C)]
    stack = stack_sz_data(szs)
    assert stack.L.shape == (C,) + tuple(sz0.L.shape)
    assert stack.sep == sz0.sep and stack.integ_mu.shape == (C,)
    xstack = stack_xray_data([xr0] * C)
    assert xstack.table.lograte_Z0.shape == (C,) + tuple(
        xr0.table.lograte_Z0.shape)
    for c in range(C):
        back = unstack(stack, c)
        assert torch.equal(back.flux, szs[c].flux)
        assert isinstance(back.integ_mu, float)
        assert back.integ_mu == pytest.approx(0.001 * (c + 1))
        xb = unstack(xstack, c)
        assert torch.equal(xb.table.Tlog, xr0.table.Tlog)
        assert xb.norm_per_cm3 == xr0.norm_per_cm3


def test_stack_static_fields_must_agree(setup):
    sz0 = setup["sess"].model.sz_data
    with pytest.raises(ValueError, match="sep differs"):
        stack_sz_data([sz0, dataclasses.replace(sz0, sep=sz0.sep - 1)])
    with pytest.raises(ValueError, match="calc_integ"):
        stack_sz_data([sz0, dataclasses.replace(sz0, calc_integ=True)])


def test_port_stacks_carry_the_jax_numbers(setup):
    """The carrier: the port's own stacking of its own session data gives
    the tensors the JAX stacks carried across."""
    sess = setup["sess"]
    sz0, xr0 = sess.model.sz_data, sess.model.xray_data
    own = stack_sz_data([dataclasses.replace(
        sz0, flux=sz0.flux * (1 + 0.05 * c),
        integ_mu=sz0.integ_mu * (1 + 0.1 * c)) for c in range(C)])
    ownx = stack_xray_data([dataclasses.replace(
        xr0, counts_filled=xr0.counts_filled + c) for c in range(C)])
    sz, xr = setup["port"]
    for f in ("L", "G", "w_T0", "flux", "flux_err", "r_press_kpc",
              "integ_mu"):
        np.testing.assert_allclose(getattr(own, f).numpy(),
                                   getattr(sz, f).numpy(), rtol=1e-12)
    for f in ("counts_filled", "counts_mask", "vols_norm", "exposures"):
        np.testing.assert_allclose(getattr(ownx, f).numpy(),
                                   getattr(xr, f).numpy(), rtol=1e-12)


# -- (a) the stacked likelihood ---------------------------------------------

@pytest.mark.parametrize("flatten", [True, False])
def test_multicluster_log_like_matches_jax(setup, flatten):
    sess, js = setup["sess"], setup["js"]
    rows = veto_rows(sess.params, n=12, seed=6)
    thetas = np.stack([rows * (1 + 0.002 * c) for c in range(C)])
    thetas[:, -4:] = rows[-4:]                  # keep the vetoed rows vetoed
    ll = make_multicluster_log_like(sess.model, *setup["port"])
    a = ll(torch.tensor(thetas)).numpy()
    b = np.asarray(jmc.make_multicluster_log_like(
        js.model, *setup["jax"], flatten=flatten)(jnp.asarray(thetas)))
    fin = np.isfinite(b)
    assert a.shape == b.shape == (C, rows.shape[0])
    assert np.array_equal(np.isfinite(a), fin)
    assert fin.sum() == C * (rows.shape[0] - 4)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)
    # the clusters really see different data
    same = ll(torch.tensor(np.stack([rows] * C))).numpy()
    assert np.abs(same[1, :4] - same[0, :4]).min() > 1.0


def test_multicluster_log_like_with_integrated_y(setup, tmp_path):
    """calc_integ on: per-cluster centres of the integrated-Y term."""
    cfg = small_config(tmp_path)
    cfg.sz.calc_integ = True
    sess = build_session(cfg, device="cpu")
    js = jax_session(cfg)
    jsz, jxr = jax_stacks(js, 2)
    assert float(np.asarray(jsz.integ_mu)[1]) != float(
        np.asarray(jsz.integ_mu)[0])
    sz, xr = port_stacks_from_jax(jsz, jxr)
    rows = truth_rows(sess.params, 5, seed=8)
    thetas = np.stack([rows, rows])
    a = make_multicluster_log_like(sess.model, sz, xr)(
        torch.tensor(thetas)).numpy()
    b = np.asarray(jmc.make_multicluster_log_like(
        js.model, jsz, jxr, flatten=True)(jnp.asarray(thetas)))
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    # and the float32 constants carry a per-cluster centre
    stack = pack_consts_stack(sess, sz, xr)
    mui = [float(c.arrays["mui"][0]) for c in stack.clusters]
    assert mui[0] != mui[1] and mui[0] > 0
    lp = multicluster_ll_plain(torch.tensor(thetas, dtype=torch.float32),
                               stack).numpy()
    np.testing.assert_allclose(lp, b, rtol=RTOL, atol=ATOL)


def test_multicluster_log_like_needs_both_stacks(setup):
    sess = setup["sess"]
    with pytest.raises(ValueError, match="both stacked"):
        make_multicluster_log_like(sess.model, setup["port"][0], None)
    ll = make_multicluster_log_like(sess.model, *setup["port"])
    with pytest.raises(ValueError, match="thetas must be"):
        ll(torch.zeros(C + 1, 4, 13, dtype=torch.float64))


# -- (c) the stacked constants ----------------------------------------------

def _jax_consts(js32, jsz32, jxr32):
    full = _build_spec(js32)
    stacks = make_multicluster_consts(js32, jsz32, jxr32, spec=full,
                                      device=False)
    return full["spec"], dict(zip(full["spec"]["cnames"], stacks))


def test_consts_stack_matches_jax_array_by_array(setup):
    sess, js32 = setup["sess"], setup["js32"]
    spec, J = _jax_consts(js32, *setup["jax32"])
    stack = pack_consts_stack(sess, *setup["port32"])
    I = stack.ints
    n_p, n_pix, n_d = I["n_press"], I["n_pix"], I["n_data"]
    n_sh, n_b, n_a, nT = I["n_sh"], I["n_band"], I["n_ann"], I["nT"]
    D = I["D"]
    assert stack.buf.shape[0] == C and stack.stride % 4 == 0
    order = list(J)
    by_pos = {k: J[k] for k in order}
    vals = list(by_pos.values())
    # positions follow _cluster_arrays' return order
    (r, lnr, _mask, LT, GT, flux, w, wT0, midr, lnmid, _kv) = vals[:11]
    sig, bg, cm, ct, lo, hi, isg, mu, sg, wint, mui = vals[-11:]
    for c in range(C):
        A = {k: v.numpy() for k, v in stack.clusters[c].arrays.items()}
        eq = np.testing.assert_allclose
        eq(A["r"], r[c, 0, :n_p], rtol=1e-6)
        eq(A["lnr"], lnr[c, 0, :n_p], rtol=1e-6)
        eq(A["LT"], LT[c, :n_p, :n_pix], rtol=1e-6, atol=1e-30)
        eq(A["GT"], GT[c, :n_pix, :n_d], rtol=1e-6, atol=1e-30)
        eq(A["flux"], flux[c, 0, :n_d], rtol=1e-6)
        eq(A["wres"], w[c, 0, :n_d], rtol=1e-6)
        eq(A["wT0"], wT0[c, 0, :I["sep"]], rtol=1e-6, atol=1e-30)
        eq(A["midr"], midr[c, 0, :n_sh], rtol=1e-6)
        eq(A["lnmid"], lnmid[c, 0, :n_sh], rtol=1e-6)
        eq(A["sigf"].ravel(), sig[c, 0, :n_b * n_a], rtol=1e-6)
        eq(A["bgf"].ravel(), bg[c, 0, :n_b * n_a], rtol=1e-6)
        eq(A["cmf"].ravel(), cm[c, 0, :n_b * n_a])
        eq(A["ctf"].ravel(), ct[c, 0, :n_b * n_a])
        eq(A["lo"], lo[c, 0, :D], rtol=1e-6)
        eq(A["hi"], hi[c, 0, :D], rtol=1e-6)
        eq(A["mu"], mu[c, 0, :D], rtol=1e-6)
        isg_c, sg_c = isg[c, 0, :D], sg[c, 0, :D]
        eq(A["wg"], isg_c / (sg_c * sg_c), rtol=1e-6)
        eq(A["wint"], wint[c, 0, :n_p], rtol=1e-6, atol=1e-30)
        eq(A["mui"], mui[c, 0], rtol=1e-6)
        # the count-rate tables: row b of LR0 is the hat operator's column
        # of (band b, shell 0) over shell 0's nT rows
        tabs = vals[11:-11]
        M0 = tabs[0][c]
        nbs = M0.shape[1] // 2 if len(tabs) == 2 else M0.shape[1]
        for b in range(n_b):
            eq(A["LR0"][b], M0[:nT, b * n_sh], rtol=1e-6)
            M1col = (M0[:nT, nbs + b * n_sh] if len(tabs) == 2
                     else tabs[1][c][:nT, b * n_sh])
            eq(A["LR1"][b], M1col, rtol=1e-6)
        # per-cluster data differ, shared grids do not
        if c:
            A0 = stack.clusters[0].arrays
            assert not torch.equal(stack.clusters[c].arrays["flux"],
                                   A0["flux"])
            assert not torch.equal(stack.clusters[c].arrays["ctf"],
                                   A0["ctf"])
            assert torch.equal(stack.clusters[c].arrays["r"], A0["r"])
    assert spec["sep"] == I["sep"] and spec["n_press"] == n_p


def test_single_cluster_consts_are_a_stack_of_one(setup):
    sess = setup["sess"]
    c1 = pack_consts(sess)
    m = sess.model
    stack = pack_consts_stack(sess, stack_sz_data([m.sz_data]),
                              stack_xray_data([m.xray_data]))
    assert stack.n_clusters == 1
    assert torch.equal(stack.buf[0], c1.buf)
    assert stack.clusters[0].offsets == c1.offsets
    assert c1.arrays["mui"].shape == (1,) and "mui" not in c1.floats


def _mismatch_cases(sess):
    m = sess.model
    sz0, xr0 = m.sz_data, m.xray_data
    tab = xr0.table
    rep = dataclasses.replace
    return {
        "pressure radial grid": (rep(sz0, r_press_kpc=sz0.r_press_kpc * 1.01),
                                 xr0),
        "sep": (rep(sz0, sep=sz0.sep - 1), xr0),
        "conversion tables": (rep(sz0, conv_val=sz0.conv_val * 1.1), xr0),
        "X-ray data presence": (sz0, None),
        "log-T grids": (sz0, rep(xr0, table=rep(tab, Tlog=tab.Tlog + 0.01))),
        "flux profile longer": (
            rep(sz0, flux=torch.cat([sz0.flux, sz0.flux[:1]]),
                flux_err=torch.cat([sz0.flux_err, sz0.flux_err[:1]])), xr0),
    }


@pytest.mark.parametrize("what", ["pressure radial grid", "sep",
                                  "conversion tables", "X-ray data presence",
                                  "log-T grids", "flux profile longer"])
def test_stack_mismatch(setup, what):
    sess = setup["sess"]
    sz, xr = _mismatch_cases(sess)[what]
    sz_stack = stack_sz_data([sz, sz])
    xr_stack = None if xr is None else stack_xray_data([xr, xr])
    with pytest.raises(StackMismatch, match=what):
        pack_consts_stack(sess, sz_stack, xr_stack)


# -- (b) the half-step -------------------------------------------------------

def hash_bits(seed: int, step: int, which: int, n_clusters: int, H: int):
    """(C, H, 4) interpret-mode bits of ``make_multicluster_step_kernel``
    (``_make_random_bits`` with ``extra=cluster``)."""
    out = []
    for cid in range(n_clusters):
        idx = (np.arange(H, dtype=np.uint32)[:, None] * np.uint32(4)
               + np.arange(4, dtype=np.uint32)[None, :])
        off = (seed * 2654435761 + step * 40503 + which * 10007
               + cid * 7919) % 2 ** 32
        v = idx + np.uint32(off)
        v = v ^ (v >> np.uint32(15))
        v = v * np.uint32(2246822519)
        v = v ^ (v >> np.uint32(13))
        v = v * np.uint32(3266489917)
        v = v ^ (v >> np.uint32(16))
        out.append(v.astype(np.int64))
    return torch.from_numpy(np.stack(out))


def test_half_step_matches_interpret_kernel(setup):
    sess, js32 = setup["sess"], setup["js32"]
    jsz32, jxr32 = setup["jax32"]
    stack = pack_consts_stack(sess, *setup["port32"])
    rows = truth_rows(sess.params, C * W, seed=21, spread=0.02)
    x0 = rows.astype(np.float32).reshape(C, W, -1)
    full = _build_spec(js32)
    consts = make_multicluster_consts(js32, jsz32, jxr32, spec=full)
    core = make_joint_core(js32, block_b=8, interpret=True, spec=full)
    lp0 = np.stack([np.asarray(core._jitted(
        jnp.asarray(x0[c]), tuple(v[c] for v in consts)))
        for c in range(C)]).reshape(C, W)
    assert np.all(np.isfinite(lp0))
    # init/lp0 through the port's per-cluster likelihood agree with it
    np.testing.assert_allclose(
        multicluster_ll(torch.tensor(x0), stack).numpy(), lp0, rtol=RTOL,
        atol=ATOL)

    step = make_multicluster_step_kernel(
        js32, jsz32, jxr32, n_inner=STEPS, n_walkers=W, interpret=True,
        thin=1, consts=consts, spec=full)
    xk, lpk, acck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.zeros((C, W)), SEED))
    assert chain.shape == (C, STEPS, W, x0.shape[-1])

    x, lp = torch.tensor(x0), torch.tensor(lp0)
    acc = torch.zeros(C, W)
    for i in range(STEPS):
        for which in (0, 1):
            x, lp, acc, accept, margin = half_step_multicluster_plain(
                x, lp, acc, which, hash_bits(SEED, i, which, C, W // 2),
                stack)
            # no decision of this run sits at the threshold
            assert float(margin.abs().min()) > 1e-3
        np.testing.assert_allclose(x.numpy(), chain[:, i], rtol=1e-5, atol=0)
        np.testing.assert_allclose(lp.numpy(), chain_lp[:, i], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(acc.numpy(), acck)
    assert 0 < acck.sum() < STEPS * C * W
    np.testing.assert_allclose(x.numpy(), xk, rtol=1e-5, atol=0)
    # same start, other data: the clusters part ways
    assert not np.allclose(xk[0], xk[1])


@pytest.mark.parametrize("thin", [1, 2])
def test_steps_match_interpret_kernel(setup, thin):
    """One launch's plain path over a chunk of 4 steps against the TPU
    kernel's n_inner = 4 call, frames read at thin 1 and 2."""
    sess, js32 = setup["sess"], setup["js32"]
    jsz32, jxr32 = setup["jax32"]
    stack = pack_consts_stack(sess, *setup["port32"])
    n_inner = 4
    x0 = truth_rows(sess.params, C * W, seed=22, spread=0.02).astype(
        np.float32).reshape(C, W, -1)
    full = _build_spec(js32)
    consts = make_multicluster_consts(js32, jsz32, jxr32, spec=full)
    lp0 = multicluster_ll(torch.tensor(x0), stack).numpy()
    step = make_multicluster_step_kernel(
        js32, jsz32, jxr32, n_inner=n_inner, n_walkers=W, interpret=True,
        thin=thin, consts=consts, spec=full)
    xk, lpk, acck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.zeros((C, W)), SEED))
    x, lp, acc, frames, frames_lp = steps_multicluster_plain(
        torch.tensor(x0), torch.tensor(lp0), torch.zeros(C, W), n_inner,
        lambda step, which: hash_bits(SEED, step, which, C, W // 2), stack,
        thin=thin)
    assert chain.shape == frames.shape == (C, n_inner // thin, W, 13)
    np.testing.assert_allclose(frames.numpy(), chain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(frames_lp.numpy(), chain_lp, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(acc.numpy(), acck)
    assert 0 < acck.sum() < n_inner * C * W
    np.testing.assert_allclose(x.numpy(), xk, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lp.numpy(), lpk, rtol=RTOL, atol=ATOL)


def test_cluster_streams_do_not_depend_on_the_cluster_count():
    H = 8
    b3 = multicluster_bits(77, "cpu", 5, 1, 3, H)
    b2 = multicluster_bits(77, "cpu", 5, 1, 2, H)
    assert b3.shape == (3, H, 4)
    assert torch.equal(b3[:2], b2)
    assert torch.equal(b3[0], philox_stream(77, "cpu")(5, 1, H, 4))
    assert not torch.equal(b3[1], b3[2])


def test_cpu_wrapper_updates_in_place_without_launches(setup):
    sess = setup["sess"]
    stack = pack_consts_stack(sess, *setup["port32"])
    x0 = torch.tensor(truth_rows(sess.params, C * W, seed=4, spread=0.02),
                      dtype=torch.float32).reshape(C, W, -1).contiguous()
    lp0 = multicluster_ll(x0, stack)
    assert torch.equal(lp0, multicluster_ll_plain(x0, stack))
    x, lp, acc = x0.clone(), lp0.clone(), torch.zeros(C, W)
    before = stretch_steps_multicluster.launches
    chain, chain_lp = stretch_steps_multicluster(x, lp, acc, SEED, 2, stack,
                                                 thin=1, step0=2)
    assert stretch_steps_multicluster.launches == before
    want = steps_multicluster_plain(
        x0, lp0, torch.zeros(C, W), 2,
        lambda step, which: multicluster_bits(SEED, "cpu", step, which, C,
                                              W // 2), stack, thin=1,
        step0=2)
    assert torch.equal(x, want[0]) and torch.equal(lp, want[1])
    assert torch.equal(acc, want[2]) and float(acc.sum()) > 0
    assert torch.equal(chain, want[3]) and torch.equal(chain_lp, want[4])
    assert chain.shape == (C, 2, W, 13) and torch.equal(chain[:, -1], x)
    # stored lp is each cluster's own likelihood of the stored position
    for c in range(C):
        assert torch.equal(joint_ll_plain(x[c], stack.clusters[c]), lp[c])
    with pytest.raises(ValueError, match="state must be"):
        stretch_steps_multicluster(x[:2].contiguous(), lp[:2].contiguous(),
                                   acc[:2].contiguous(), SEED, 1, stack)
    with pytest.raises(ValueError, match="multiple of thin"):
        stretch_steps_multicluster(x, lp, acc, SEED, 3, stack, thin=2)


def test_run_multicluster_steps_thins(setup):
    sess = setup["sess"]
    stack = pack_consts_stack(sess, *setup["port32"])
    x = torch.tensor(truth_rows(sess.params, C * W, seed=5, spread=0.02),
                     dtype=torch.float32).reshape(C, W, -1).contiguous()
    lp = multicluster_ll(x, stack)
    acc = torch.zeros(C, W)
    assert run_multicluster_steps(stack, x, lp, acc, 2, 3) is None
    chain, chain_lp = run_multicluster_steps(stack, x, lp, acc, 4, 4, thin=2)
    assert chain.shape == (C, 2, W, 13) and chain_lp.shape == (C, 2, W)
    assert torch.equal(chain[:, -1], x) and torch.equal(chain_lp[:, -1], lp)
    assert float(acc.max()) <= 6
    with pytest.raises(ValueError, match="multiple of thin"):
        run_multicluster_steps(stack, x, lp, acc, 5, 4, thin=2)


# -- (f) simulation -----------------------------------------------------------

def test_simulate_survey_shapes_and_mask(setup):
    sess = setup["sess"]
    m = sess.model
    xr0 = m.xray_data
    mask = xr0.counts_mask.clone()
    mask[0, 0] = 0.0                           # one excluded cell
    model = dataclasses.replace(m, xray_data=dataclasses.replace(
        xr0, counts_mask=mask))
    thetas = truth_rows(sess.params, 3, seed=12, spread=0.01)
    rng = np.random.default_rng(5)
    sv = simulate_survey(model, thetas, rng)
    assert sv.sz_stack.flux.shape == (3,) + tuple(m.sz_data.flux.shape)
    assert sv.xray_stack.counts_filled.shape == (3,) + tuple(mask.shape)
    assert torch.equal(sv.xray_stack.counts_mask[1], mask)
    assert float(sv.xray_stack.counts_filled[:, 0, 0].abs().sum()) == 0.0
    np.testing.assert_array_equal(sv.thetas_true, thetas)
    mock = sv.mocks[0]
    assert mock.sz_flux.shape == mock.sz_flux_true.shape
    assert np.all(mock.xray_counts == np.round(mock.xray_counts))
    # a mock is a likely dataset at its own truth
    ll = mock.model.log_like_batch(torch.tensor(thetas[:1]))
    assert bool(torch.isfinite(ll).all())
    # noiseless: the model prediction itself
    clean = simulate_observation(model, thetas[0], rng, sz_noise=False,
                                 xray_noise=False)
    np.testing.assert_array_equal(clean.sz_flux, clean.sz_flux_true)
    np.testing.assert_array_equal(clean.xray_counts[0, 1:],
                                  clean.xray_pred_true[0, 1:])
    # deterministic in the generator's seed
    again = simulate_survey(model, thetas, np.random.default_rng(5))
    assert torch.equal(again.sz_stack.flux, sv.sz_stack.flux)


def test_simulate_support_guard(setup):
    sess = setup["sess"]
    theta = truth_rows(sess.params, 1, seed=1)[0]
    theta[sess.params.thawed.index("backscale")] = -1e3
    with pytest.raises(ValueError, match="outside the likelihood's support"):
        simulate_observation(sess.model, theta, np.random.default_rng(0))
