"""Port parity: the model families of the joint likelihood.

``joxsz_tpu`` specialises its joint likelihood along three axes
(``pallas_joint.py::_detect_family``): pressure gNFW | knots, temperature
UPP | Vikhlinin | none (SZ-only), density single | double, with the
optional ``line_scale`` nuisance.  For every row of the family table, on
the small synthetic dataset of ``test_torch_build.small_config`` built
through both packages' ``build_session`` from the same config:

  (a) the port's float64 ``log_like_batch`` against ``joxsz_tpu``'s on the
      same rows at 1e-9 relative, with identical vetoes;
  (b) kernel 1's plain version ``joint_ll_plain`` against the interpret-
      mode ``make_joint_core`` at ``rtol=2e-4, atol=0.5`` (the tolerance of
      ``tests/test_pallas_joint.py``) with identical finite masks;
  (c) the plain step of the step kernel at K=1 and K=4 stays
      self-consistent: every stored lp equals a fresh plain kernel-1
      value (to float32 rounding: the CPU's vectorised exp and log1p give
      a row other last bits in a batch of another size);
  (d) a session rebuilt from the JAX session's arrays
      (``session_from_arrays``) carries theta by name: the same thawed
      columns, kernel roles at the JAX columns, the same log-posterior.

The rows are drawn around ``synth.truth_theta`` with one row each vetoed
by the box, by r_c > r_s and by the HSE mass, and rows colder and hotter
than the count-rate table's grid.  Beside them: a thawed layout outside
every family raises in ``pack_consts``, the survey fits a family on the
cluster grid, and the count-rate table is found without ``table_path``
as ``joxsz_tpu`` finds it.
"""

import copy
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch import run
from joxsz_torch.build import (TableSpec, build_session, find_table,
                               session_from_arrays)
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import philox_stream, steps_plain
from joxsz_torch.sampling.kernel import rung_tensors
from joxsz_torch.sampling.tempered import default_betas
from joxsz_torch.synth import truth_theta
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.config import JoXSZConfig as JaxConfig
from joxsz_tpu.ops.pallas_joint import make_joint_core
from joxsz_tpu.tablegen import TableSpec as JaxTableSpec

from test_torch_build import small_config

RTOL, ATOL = 2e-4, 0.5

# tag -> (run flags, thawed D on the small dataset)
FAMILIES = {
    "knots": (("--pressure", "knots"), 16),
    "vikhlinin_T": (("--temperature", "vikhlinin"), 18),
    "double_density": (("--density", "double"), 16),
    "line_scale": (("--line-systematic",), 14),
    "sz_only": (("--sz-only",), 10),
    "config4": (("--pressure", "knots", "--temperature", "vikhlinin"), 21),
    "widest": (("--pressure", "knots", "--temperature", "vikhlinin",
                "--density", "double", "--line-systematic"), 25),
}


def family_configs(cfg, flags):
    """The port's and the JAX package's config of the family ``flags``
    select, and whether it is SZ-only."""
    args = run.build_parser().parse_args(list(flags))
    fcfg = run.apply_model_flags(copy.deepcopy(cfg), args)
    return fcfg, JaxConfig.from_json(fcfg.to_json()), args.sz_only


@pytest.fixture(scope="module")
def base_config(tmp_path_factory):
    return small_config(tmp_path_factory.mktemp("torch_families"))


@pytest.fixture(scope="module")
def families(base_config):
    """tag -> (port f64 session, JAX f64 session, JAX f32 session)."""
    out = {}
    for tag, (flags, _) in FAMILIES.items():
        cfg, jc, sz_only = family_configs(base_config, flags)
        sess = build_session(cfg, device="cpu", sz_only=sz_only)
        jsess = {}
        for dt in ("float64", "float32"):
            jc.dtype = dt
            jsess[dt] = jax_build_session(copy.deepcopy(jc), sz_only=sz_only,
                                          use_cache=False)
        out[tag] = (sess, jsess["float64"], jsess["float32"])
    return out


def family_rows(sess, n: int = 24, seed: int = 5) -> np.ndarray:
    """n rows within 3% of ``truth_theta``, then one row out of the box,
    one with r_c > r_s, one with a falling HSE mass (the knots reversed
    for knot pressure) and, with X-ray data, ``truth_theta`` made colder
    than the count-rate grid and made hot (T_X above it for UPP, T_0 out
    of its box for Vikhlinin)."""
    p = sess.params
    ix = p.thawed.index
    th0 = truth_theta(sess)
    rng = np.random.default_rng(seed)
    rows = th0 * (1 + 0.03 * rng.standard_normal((n + 5, th0.size)))
    rows[n, ix("log(n_0)")] = 5.0
    rows[n + 1, ix("log(r_c)")], rows[n + 1, ix("log(r_s)")] = 3.0, 2.0
    knots = "logP_0" in p.thawed
    if knots:
        k = slice(ix("logP_0"), ix("logP_0") + sess.model.pressure.n_knots)
        rows[n + 2, k] = rows[n + 2, k][::-1]
    else:
        rows[n + 2, [ix("b"), ix("a"), ix("r_p"), ix(r"\beta")]] = (
            14.0, 5.0, 150.0, 0.2)
    if sess.model.xray_data is None:
        return rows[:n + 3]
    rows[n + 3:] = th0
    if "T_0" in p.thawed:
        rows[n + 3, [ix("T_0"), ix("T_{min}/T_0")]] = (0.5, 0.05)
        rows[n + 4, ix("T_0")] = 200.0
    elif knots:
        rows[n + 3, k] -= 3.0
        rows[n + 4, k] += 1.0
        rows[n + 4, ix("log(T_X/T_{SZ})")] = 0.98
    else:
        rows[n + 3, ix("P_0")] = 2e-4
        rows[n + 4, [ix("log(T_X/T_{SZ})"), ix("P_0")]] = (0.98, 1.5)
    return rows


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_family_layout(families, tag):
    """Both packages thaw the same parameters in the same order, D as in
    the family table."""
    sess, js, _ = families[tag]
    assert sess.params.thawed == list(js.params.thawed)
    assert sess.params.ndim == FAMILIES[tag][1]
    assert (sess.model.xray_data is None) == (tag == "sz_only")


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_float64_model_matches_jax(families, tag):
    """(a) the f64 log-posterior at 1e-9 relative, identical vetoes."""
    sess, js, _ = families[tag]
    rows = family_rows(sess)
    a = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    b = np.asarray(jax.jit(jax.vmap(js.model.log_like))(jnp.asarray(rows)))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert fin[:24].sum() >= 8 and not fin[24:27].any()
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_plain_kernel_matches_interpret_kernel(families, tag):
    """(b) joint_ll_plain against the interpret-mode Pallas kernel."""
    sess, _, js32 = families[tag]
    rows = family_rows(sess).astype(np.float32)
    core = make_joint_core(js32, block_b=8, interpret=True)
    assert core is not None
    b = np.asarray(core(jnp.asarray(rows)))
    a = joint_ll_plain(torch.tensor(rows), pack_consts(sess)).numpy()
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert fin[:24].sum() >= 8 and not fin[24:27].any()
    if sess.model.xray_data is not None:
        assert np.isfinite(a[27])         # colder than the grid, finite
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("tag", list(FAMILIES))
def test_plain_step_self_consistent(families, tag, K):
    """(c) 4 plain steps of the step kernel at K rungs and 16 walkers:
    moves accepted, and every stored lp the fresh plain kernel-1 value of
    its row."""
    sess, _, _ = families[tag]
    c = pack_consts(sess)
    W, D = 16, sess.params.ndim
    rng = np.random.default_rng(7 + K)
    th0 = truth_theta(sess)
    x = torch.empty((K * W, D))
    lp = torch.full((K * W,), -float("inf"))
    while not bool(torch.isfinite(lp).all()):
        bad = ~torch.isfinite(lp)
        x[bad] = torch.tensor(th0 * (1 + 0.01 * rng.standard_normal(
            (int(bad.sum()), D))), dtype=torch.float32)
        lp[bad] = joint_ll_plain(x[bad], c)
    beta, db = rung_tensors(default_betas(K) if K > 1 else [1.0], "cpu")
    x, lp, acc, _, chain, chain_lp = steps_plain(
        x.reshape(K, W, D), lp.reshape(K, W), torch.zeros(K, W), beta,
        db.tolist(), 3, 4, philox_stream(3, "cpu"),
        lambda th: joint_ll_plain(th, c), thin=2)
    assert float(acc.mean()) > 0 and chain.shape == (2, W, D)
    assert bool(torch.isfinite(lp).all())
    fresh = torch.stack([joint_ll_plain(x[k, w:w + 1], c)[0]
                         for k in range(K) for w in range(W)]).reshape(K, W)
    np.testing.assert_allclose(fresh.numpy(), lp.numpy(), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(chain[-1].numpy(), x[0].numpy())


def family_arrays(js) -> dict:
    """The arrays that define a JAX session of any family, keyed as
    ``joxsz_torch.build.session_from_arrays`` takes them."""
    m, op, p = js.model, js.sz_operator, js.model.params
    sz, xr = m.sz_data, m.xray_data

    def n(a):
        return np.asarray(a, dtype=np.float64)

    out = {
        "sz.L": n(op.L), "sz.G": n(op.G), "sz.w_T0": n(op.w_T0),
        "sz.w_y0": n(op.w_y0), "sz.integ_w": n(op.integ_w),
        "sz.y_prefactor": float(op.y_prefactor),
        "sz.r_press_kpc": n(sz.r_press_kpc), "sz.sep": int(sz.sep),
        "sz.flux_r": n(sz.flux_r), "sz.flux": n(sz.flux),
        "sz.flux_err": n(sz.flux_err), "sz.conv_T": n(sz.conv_T),
        "sz.conv_val": n(sz.conv_val), "sz.calc_integ": bool(sz.calc_integ),
        "sz.integ_mu": float(sz.integ_mu),
        "sz.integ_sig": float(sz.integ_sig),
        "params.names": list(p.names),
        "params.values": np.array([p[k].val for k in p.names]),
        "params.frozen": np.array([p[k].frozen for k in p.names]),
        "params.lo": n(p.lo), "params.hi": n(p.hi),
        "params.is_gauss": np.asarray(p.is_gauss), "params.mu": n(p.mu),
        "params.sigma": n(p.sigma),
        "exclude_unphysical_mass": bool(m.exclude_unphysical_mass),
        "model.pressure": ("knots" if hasattr(m.pressure, "knots_logr")
                           else "gnfw"),
        "model.temperature": ("upp" if hasattr(m.temperature, "pressure")
                              else "vikhlinin"),
        "model.density_mode": m.density.mode,
    }
    if hasattr(m.pressure, "knots_logr"):
        out["model.knots_logr"] = n(m.pressure.knots_logr)
    if xr is not None:
        out.update({
            "xray.counts": n(xr.counts), "xray.exposures": n(xr.exposures),
            "xray.areascales": n(xr.areascales), "xray.areas": n(xr.areas),
            "xray.backrates": n(xr.backrates),
            "xray.vols_norm": n(xr.vols_norm),
            "xray.midpt_kpc": n(xr.midpt_kpc),
            "xray.norm_per_cm3": float(xr.norm_per_cm3),
            "table.Tlog": n(xr.table.Tlog),
            "table.lograte_Z0": n(xr.table.lograte_Z0),
            "table.lograte_Z1": n(xr.table.lograte_Z1)})
    return out


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_theta_carried_by_name(families, tag):
    """(d) a session rebuilt from the JAX session's arrays: theta carried
    from the JAX ParamSet by name lands in the same columns, the kernel's
    roles point at the JAX columns, and the log-posterior is the same."""
    _, js, _ = families[tag]
    sess = session_from_arrays(family_arrays(js), device="cpu")
    jp, p = js.model.params, sess.params
    assert p.thawed == list(jp.thawed)
    by_name = {n: jp[n].val for n in jp.thawed}
    theta = np.array([by_name[n] for n in p.thawed])
    np.testing.assert_array_equal(theta, np.asarray(jp.thawed_values()))
    c = pack_consts(sess)
    assert all(list(jp.thawed).index(r) == col for r, col in c.roles.items())
    rows = family_rows(sess)
    a = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    b = np.asarray(jax.jit(jax.vmap(js.model.log_like))(jnp.asarray(rows)))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)


def test_layout_outside_every_family_raises(families):
    """Thawing alpha leaves every family (the JAX package's
    make_joint_core returns None there): the port's packer raises."""
    sess, _, _ = families["config4"]
    s = copy.copy(sess)
    s.model = copy.copy(sess.model)
    s.model.params = copy.deepcopy(sess.params)
    s.model.params.thaw(r"\alpha")
    with pytest.raises(NotImplementedError, match="families"):
        pack_consts(s)


def test_survey_refuses_a_family(base_config, tmp_path):
    """The survey no longer refuses a family: a knot-pressure ``--mock 2``
    runs on the cluster-grid route (the plain version of kernel 4's family
    instance here), with no fallback warning, the truths spread in the
    knot values."""
    import warnings

    from joxsz_torch import survey
    from joxsz_torch.synth import config_json

    cfg, _, _ = family_configs(base_config, ("--pressure", "knots"))
    path = config_json(cfg, tmp_path / "knots.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = survey.main(["--mock", "2", "--config", path, "--cpu",
                           "--quick", "--out", str(tmp_path / "s.json")])
    assert set(res.timings) == {"setup_s", "pack_s", "init_s",
                                "sampling_s", "summary_s"}
    assert res.chain.shape == (30, 2, 32, FAMILIES["knots"][1])
    k = [i for i, n in enumerate(res.param_names) if n.startswith("logP_")]
    np.testing.assert_allclose(res.truths[1, k] - res.truths[0, k],
                               np.log10(1.3 / 0.7))
    assert np.all(np.isfinite(res.chain))


def test_table_found_without_table_path(base_config):
    """Without xray.table_path both packages choose the bundled table
    (its metadata match the CL J1226 z, NH and bands) under the same
    TableSpec key, and build the same likelihood."""
    cfg = copy.deepcopy(base_config)
    cfg.xray.table_path = None
    cfg.xray.rmf, cfg.xray.arf = "source.rmf", "source.arf"
    spec = dict(rmf="source.rmf", arf="source.arf",
                bands_eV=tuple(cfg.xray.bands_eV), z=cfg.redshift,
                NH_1022pcm2=cfg.xray.NH_1022pcm2)
    assert repr(TableSpec(**spec)) == repr(JaxTableSpec(**spec))
    assert TableSpec(**spec).key() == hashlib.sha256(
        repr(JaxTableSpec(**spec)).encode()).hexdigest()[:12]
    path = find_table(cfg)
    assert path.endswith("cl1226_ctrate.npz")
    sess = build_session(cfg, device="cpu")
    jc = JaxConfig.from_json(cfg.to_json())
    jc.dtype = "float64"
    js = jax_build_session(jc, use_cache=False)
    rows = family_rows(sess)
    a = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    b = np.asarray(jax.jit(jax.vmap(js.model.log_like))(jnp.asarray(rows)))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)


def test_no_matching_table_raises(base_config, tmp_path, monkeypatch):
    """Where no table matches the config, the port generates one from the
    config's RMF/ARF; without those files it raises before writing
    anything into the tables directory."""
    from joxsz_torch import build

    monkeypatch.setattr(build, "TABLES_DIR", tmp_path / "tables")
    cfg = copy.deepcopy(base_config)
    cfg.xray.table_path = None
    cfg.redshift = 0.5
    cfg.xray.rmf = str(tmp_path / "missing.rmf")
    with pytest.raises(FileNotFoundError, match="missing.rmf"):
        find_table(cfg, device="cpu")
    assert not (tmp_path / "tables").exists()


def test_mle_runs_on_the_cpu_in_float64(families, monkeypatch):
    """find_mle evaluates its objective on a float64 copy of the model on
    the CPU, whatever the session's device and dtype (here float32)."""
    from joxsz_torch.models.joint import JointModel
    from joxsz_torch.sampling import mle

    sess, _, _ = families["sz_only"]
    f32 = sess.model.to("cpu", torch.float32)
    assert f32.sz_data.L.dtype == torch.float32
    seen = set()
    real = JointModel.log_like

    def spy(self, theta):
        seen.add((theta.device.type, theta.dtype, self.sz_data.L.dtype))
        return real(self, theta)

    monkeypatch.setattr(JointModel, "log_like", spy)
    th0 = truth_theta(sess)
    p = sess.params
    theta, ll = mle.find_mle(f32, th0, p.lo, p.hi, device="cpu",
                             max_restarts=1)
    assert seen == {("cpu", torch.float64, torch.float64)}
    assert mle.mle_device("cuda").type == "cpu"
    assert mle.mle_device("cuda", prefer_cpu=False).type == "cuda"
    assert theta.shape == th0.shape
    assert ll >= float(real(sess.model, torch.tensor(th0))) - 1e-9


def test_auto_extend_promotes_a_head_transient(families, monkeypatch):
    """The warmup-aware fallback of joxsz_tpu's driver: where the
    accumulated chain passes the length rule but not split-R-hat and its
    trailing half certifies on both, the head is promoted to burn-in
    instead of extending (convergence stubbed: the whole chain fails
    split-R-hat, any half of it passes)."""
    from joxsz_torch.sampling import driver

    sess, _, _ = families["sz_only"]
    monkeypatch.setattr(driver, "convergence", lambda chain, thin: (
        1.0, 1.0 if chain.shape[0] <= 8 else 2.0))
    p = sess.params
    res = driver.run_fit(sess.model, None, truth_theta(sess), p.lo, p.hi,
                         p.thawed, nwalkers=16, nburn=0, nsteps=80, nthin=5,
                         seed=2, prelim_iterations=10, max_prelim_rounds=1,
                         auto_extend=2, do_mle=False, verbose=False)
    t = res.timings
    assert t["extra_burn_steps"] == 40 and t["auto_extend_rounds"] == 0
    assert t["split_rhat"] == 1.0
    assert res.chain.shape == (8, 16, p.ndim)
    assert res.log_prob.shape == (8, 16)


def test_init_reflects_draws_into_the_box_after_a_shrink():
    """A centre with six parameters on their box edges (an MLE of the
    widest family has four): almost every draw leaves the box, so the
    walkers' initialisation fails unless, after the first shrink of the
    spread, draws are reflected into the box."""
    from joxsz_torch.sampling.stretch import generate_init_positions

    D = 8
    lo, hi = np.zeros(D), np.ones(D)

    def box_lp(x):
        inside = ((x >= torch.as_tensor(lo, dtype=x.dtype))
                  & (x <= torch.as_tensor(hi, dtype=x.dtype))).all(dim=1)
        zero = torch.zeros(x.shape[0])
        return torch.where(inside, zero, zero - float("inf"))

    center = np.full(D, 0.5)
    center[:6] = 0.0
    g = torch.Generator()
    g.manual_seed(0)
    with pytest.raises(RuntimeError, match="finite-likelihood"):
        generate_init_positions(box_lp, center, 512, g, device="cpu",
                                max_tries=2)
    g.manual_seed(0)
    pos = generate_init_positions(box_lp, center, 512, g, device="cpu",
                                  max_tries=2, lo=lo, hi=hi)
    assert bool(torch.isfinite(box_lp(pos)).all())
    assert float(pos[:, :6].std()) > 0 and float(pos[:, 6:].std()) > 0
