"""Port parity: the model families on the survey's cluster grid.

For every family of ``tests/test_torch_families.py`` but the widest (knot
pressure, Vikhlinin T, double density, line_scale, SZ-only and config #4)
three clusters of the small synthetic dataset are stacked in both
packages from the same numpy arrays (flux scaled and counts shifted per
cluster, as ``tests/test_torch_multicluster.py`` does for the flagship):

  * ``make_multicluster_log_like`` against ``joxsz_tpu``'s, ``flatten=True``
    and ``False``, in float64 at 1e-9 relative with identical vetoes
    (an SZ-only model takes ``xray_stack=None`` in both);
  * the plain float32 ``multicluster_ll`` on ``pack_consts_stack`` (the
    constants kernel 4's family instance reads) against it at rtol 2e-4 /
    atol 0.5 with identical vetoes;
  * the plain half-steps of kernel 4 (``half_step_multicluster_plain``,
    3 steps at C=3, W=16) against the interpret-mode
    ``make_multicluster_step_kernel`` on the same hash bits, step by step.

Then the survey itself on the CPU: a ``--spec`` that mixes families
splits into one group per family in spec order and its CLI writes the
merged summary without any fallback warning; ``--population`` on it is
refused; ``--sz-only --mock 3`` end to end; ``--save-chains`` files load
back equal to the result; ``--population`` on a flagship mock.
"""

import copy
import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch import run, survey
from joxsz_torch.build import build_session
from joxsz_torch.io.checkpoint import load_chain
from joxsz_torch.models.multicluster import make_multicluster_log_like
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts_stack
from joxsz_torch.ops.multicluster_kernel import (
    half_step_multicluster_plain, multicluster_ll, multicluster_ll_plain)
from joxsz_torch.synth import config_json, truth_theta
from joxsz_tpu.models import multicluster as jmc
from joxsz_tpu.ops.pallas_joint import (_build_spec, make_joint_core,
                                        make_multicluster_consts,
                                        make_multicluster_step_kernel)

from test_torch_build import small_config
from test_torch_families import FAMILIES, family_configs, family_rows
from test_torch_multicluster import hash_bits, port_stacks_from_jax

C, W, STEPS, SEED = 3, 16, 3, 9
RTOL, ATOL = 2e-4, 0.5
MARGIN = 0.05       # decisions this close to their threshold may flip


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU tests run torch on one thread: the population fit's plain
    loop of small batched ops slowed ~200x under the suite's six
    parallel workers with torch's default thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TAGS = ["knots", "vikhlinin_T", "double_density", "line_scale", "sz_only",
        "config4"]


def jax_stacks(js, n: int):
    """n clusters on the JAX side: flux x (1 + 0.05 c) and, with X-ray
    data, counts + c (None for an SZ-only session)."""
    sz0, xr0 = js.model.sz_data, js.model.xray_data
    szs = [dataclasses.replace(sz0, flux=sz0.flux * (1 + 0.05 * c))
           for c in range(n)]
    if xr0 is None:
        return jmc.stack_sz_data(szs), None
    xrs = [dataclasses.replace(xr0, counts=xr0.counts + c,
                               counts_filled=xr0.counts_filled + c)
           for c in range(n)]
    return jmc.stack_sz_data(szs), jmc.stack_xray_data(xrs)


@pytest.fixture(scope="module")
def base_config(tmp_path_factory):
    return small_config(tmp_path_factory.mktemp("torch_survey_families"))


_CACHE = {}


def family(base_config, tag):
    """tag -> dict(sess, js, js32, jax, jax32, port, port32), built once."""
    if tag not in _CACHE:
        cfg, jc, sz_only = family_configs(base_config, FAMILIES[tag][0])
        sess = build_session(cfg, device="cpu", sz_only=sz_only)
        out = dict(sess=sess)
        for suffix, dt in (("", "float64"), ("32", "float32")):
            from joxsz_tpu.build import build_session as jbs

            j = copy.deepcopy(jc)
            j.dtype = dt
            js = jbs(j, sz_only=sz_only, use_cache=False)
            stacks = jax_stacks(js, C)
            out["js" + suffix] = js
            out["jax" + suffix] = stacks
            out["port" + suffix] = port_stacks_from_jax(
                *stacks, torch.float64 if dt == "float64" else
                torch.float32)
        _CACHE[tag] = out
    return _CACHE[tag]


def cluster_rows(sess):
    """(C, n, D) rows: the family's rows (vetoed ones last) scaled by
    1 + 0.002 c, the vetoed rows left as they are."""
    rows = family_rows(sess, n=10)
    n_veto = rows.shape[0] - 10
    th = np.stack([rows * (1 + 0.002 * c) for c in range(C)])
    th[:, -n_veto:] = rows[-n_veto:]
    return th, n_veto


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("tag", TAGS)
def test_family_log_like_matches_jax(base_config, tag, flatten):
    f = family(base_config, tag)
    sess, js = f["sess"], f["js"]
    th, n_veto = cluster_rows(sess)
    a = make_multicluster_log_like(sess.model, *f["port"])(
        torch.tensor(th)).numpy()
    with warnings.catch_warnings():
        # flatten=True without shared grids warns and takes the nested path
        warnings.simplefilter("ignore")
        b = np.asarray(jmc.make_multicluster_log_like(
            js.model, *f["jax"], flatten=flatten)(jnp.asarray(th)))
    fin = np.isfinite(b)
    assert a.shape == b.shape == th.shape[:2]
    assert np.array_equal(np.isfinite(a), fin)
    assert fin.sum() >= C * 3 and not fin[:, -n_veto:-n_veto + 3].any()
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)
    # the clusters see their own data
    same = make_multicluster_log_like(sess.model, *f["port"])(
        torch.tensor(np.stack([th[0]] * C))).numpy()
    both = fin[0] & np.isfinite(same[1])
    assert np.abs(same[1][both] - same[0][both]).min() > 1e-3


@pytest.mark.parametrize("tag", TAGS)
def test_family_plain_f32_stack_matches_jax(base_config, tag):
    """The float32 constants of kernel 4's family instance, evaluated by
    the plain kernel-1 arithmetic per cluster, against the float64 JAX
    multicluster likelihood."""
    f = family(base_config, tag)
    sess = f["sess"]
    th, _ = cluster_rows(sess)
    stack = pack_consts_stack(sess, *f["port32"])
    assert stack.n_clusters == C
    assert stack.ints["has_xray"] == int(tag != "sz_only")
    lp = multicluster_ll_plain(torch.tensor(th, dtype=torch.float32),
                               stack).numpy()
    # the wrapper takes the plain version for CPU tensors
    assert np.array_equal(lp, multicluster_ll(
        torch.tensor(th, dtype=torch.float32), stack).numpy())
    b = np.asarray(jmc.make_multicluster_log_like(
        f["js"].model, *f["jax"], flatten=False)(jnp.asarray(th)))
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(lp), fin)
    np.testing.assert_allclose(lp[fin], b[fin], rtol=RTOL, atol=ATOL)


def start_state(sess, stack, seed: int) -> np.ndarray:
    """(C, W, D) float32 rows within 1% of ``truth_theta``, each cluster's
    W the first of its draws with a finite log-posterior."""
    th0 = truth_theta(sess)
    rng = np.random.default_rng(seed)
    out = []
    for cc in stack.clusters:
        cand = (th0 * (1 + 0.01 * rng.standard_normal((8 * W, th0.size))))
        cand = torch.tensor(cand, dtype=torch.float32)
        ok = torch.isfinite(joint_ll_plain(cand, cc))
        assert int(ok.sum()) >= W
        out.append(cand[ok][:W].numpy())
    return np.stack(out)


@pytest.mark.parametrize("tag", TAGS)
def test_family_steps_match_interpret_kernel(base_config, tag):
    """The plain version of a launch of kernel 4 against the TPU kernel's
    cluster grid (interpret mode) on the same hash bits, step by step: each
    step is a call of n_inner = 1 from the TPU kernel's state, the plain
    step fed the TPU kernel's own likelihood (``make_joint_core`` per
    cluster).  Rows whose decision lies within MARGIN of its threshold
    (float32 rounding of a ~4e4 log-posterior may flip it), and a
    cluster's second half after such a row in its first, are left out;
    every other row's position matches to 1e-5 and its accept count
    exactly.  The port's plain likelihood of each state matches the
    kernel's stored lp at rtol 2e-4 / atol 0.5."""
    f = family(base_config, tag)
    sess, js32 = f["sess"], f["js32"]
    jsz32, jxr32 = f["jax32"]
    stack = pack_consts_stack(sess, *f["port32"])
    x0 = start_state(sess, stack, seed=21)
    full = _build_spec(js32)
    consts = make_multicluster_consts(js32, jsz32, jxr32, spec=full)
    assert consts is not None
    core = make_joint_core(js32, block_b=8, interpret=True, spec=full)
    per_c = [tuple(v[c] for v in consts) for c in range(C)]

    def jax_lp(th):
        return torch.tensor(np.stack([np.asarray(core._jitted(
            jnp.asarray(th[c].numpy()), per_c[c])) for c in range(C)]))

    step = make_multicluster_step_kernel(
        js32, jsz32, jxr32, n_inner=1, n_walkers=W, interpret=True,
        consts=consts, spec=full)
    H = W // 2
    xj, lpj = torch.tensor(x0), jax_lp(torch.tensor(x0))
    assert np.all(np.isfinite(lpj.numpy()))
    compared = 0
    for i in range(STEPS):
        np.testing.assert_allclose(multicluster_ll(xj, stack).numpy(),
                                   lpj.numpy(), rtol=RTOL, atol=ATOL)
        xk, lpk, acck = (torch.tensor(np.asarray(v)) for v in step(
            jnp.asarray(xj.numpy()), jnp.asarray(lpj.numpy()),
            jnp.zeros((C, W)), SEED + i))
        x, lp, acc = xj, lpj, torch.zeros(C, W)
        near = torch.zeros(C, W, dtype=torch.bool)
        for which in (0, 1):
            x, lp, acc, _, margin = half_step_multicluster_plain(
                x, lp, acc, which, hash_bits(SEED + i, 0, which, C, H),
                stack, lp_fn=jax_lp)
            near[:, which * H:(which + 1) * H] = margin.abs() < MARGIN
        near[:, H:] |= near[:, :H].any(dim=1, keepdim=True)
        ok = ~near
        np.testing.assert_allclose(x[ok].numpy(), xk[ok].numpy(),
                                   rtol=1e-5, atol=0)
        assert torch.equal(acc[ok], acck[ok])
        compared += int(ok.sum())
        xj, lpj = xk, lpk
    assert compared >= STEPS * C * W // 2


# -- the survey on the CPU ---------------------------------------------------

def write_spec(base_config, root, flags_list):
    """A --spec of one config per entry of ``flags_list`` (run flags; an
    SZ-only entry has no X-ray part), all on the small dataset."""
    entries = []
    for i, flags in enumerate(flags_list):
        args = run.build_parser().parse_args(list(flags))
        cfg = run.apply_model_flags(copy.deepcopy(base_config), args)
        if args.sz_only:
            cfg.xray = None
        cfg.name = f"cl{i}"
        entries.append({"name": f"cl{i}",
                        "config": config_json(cfg, root / f"cl{i}.json")})
    spec = root / "survey.json"
    spec.write_text(json.dumps({"clusters": entries}))
    return spec


MIXED = ((), ("--pressure", "knots"), (), ("--sz-only",))


def test_spec_survey_groups_mixed_families(base_config, tmp_path):
    """gnfw, knots, gnfw (and an SZ-only cluster): one group per family,
    each with its own thawed vector, in spec order."""

    class Args:
        sz_only = False
        mle = False

    spec = write_spec(base_config, tmp_path, MIXED)
    groups = survey._build_spec_survey(str(spec), Args(), "cpu")
    assert [tuple(g[6]) for g in groups] == [(0, 2), (1,), (3,)]
    gnfw, knots, sz = (list(g[0].params.thawed) for g in groups)
    assert "P_0" in gnfw and "P_0" not in knots
    assert any(n.startswith("logP_") for n in knots)
    assert "Z" not in sz and groups[2][2] is None and groups[0][2] is not None
    assert groups[0][3].shape == (2, len(gnfw))
    assert groups[1][3].shape == (1, len(knots))


@pytest.fixture(scope="module")
def mixed_run(base_config, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mixed")
    spec = write_spec(base_config, root, MIXED)
    out = root / "mixed_summary.json"
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no fallback may happen
        bundles = survey.main([
            "--spec", str(spec), "--cpu", "--walkers", "48", "--burn", "6",
            "--steps", "10", "--thin", "2", "--seed", "5", "--save-chains",
            "--out", str(out)])
    return spec, out, bundles


def test_survey_cli_mixed_families(mixed_run):
    """Every family group reaches the cluster-grid route (kernel timings,
    no warning); the summary carries each family's vector with the
    clusters in spec order."""
    _, out, bundles = mixed_run
    assert isinstance(bundles, list) and len(bundles) == 3
    assert [specs for _, specs in bundles] == [[0, 2], [1], [3]]
    for fres, _ in bundles:
        assert set(fres.timings) == {"groups"} or set(fres.timings) == {
            "setup_s", "pack_s", "init_s", "sampling_s", "summary_s"}
        assert np.all(np.isfinite(fres.log_prob))
        assert fres.chain.shape[:3] == (5, fres.chain.shape[1], 48)
    summary = json.loads(out.read_text())
    assert summary["param_names"] is None
    assert len(summary["families"]) == 3
    assert [c["name"] for c in summary["clusters"]] == [
        "cl0", "cl1", "cl2", "cl3"]
    med = [c["median"] for c in summary["clusters"]]
    assert "P_0" in med[0] and "P_0" not in med[1] and "Z" not in med[3]
    assert med[0].keys() == med[2].keys()
    for c in summary["clusters"]:
        assert np.isfinite(list(c["median"].values())).all()


def test_save_chains_load_back_equal(mixed_run):
    """One chain per cluster beside --out, in the format ``run
    --postprocess`` reads, equal to the cluster's rows of the result."""
    _, out, bundles = mixed_run
    suffix = survey.chain_suffix()
    for fres, specs in bundles:
        for local, sp in enumerate(specs):
            d = load_chain(str(out.parent / f"cl{sp}_chain{suffix}"))
            np.testing.assert_array_equal(d["chain"], fres.chain[:, local])
            np.testing.assert_array_equal(d["log_prob"],
                                          fres.log_prob[:, local])
            assert d["param_names"] == fres.param_names
            assert d["burn"] == 6 and d["thin"] == 2


def test_survey_cli_mixed_families_population_rejected(mixed_run):
    spec, out, _ = mixed_run
    with pytest.raises(SystemExit, match="shared model family"):
        survey.main(["--spec", str(spec), "--cpu", "--walkers", "48",
                     "--burn", "2", "--steps", "2", "--thin", "2",
                     "--population", "P_0", "--out", str(out)])


def test_sz_only_mock_survey_end_to_end(base_config, tmp_path):
    path = config_json(base_config, tmp_path / "cfg.json")
    out = tmp_path / "sz.json"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = survey.main(["--mock", "3", "--config", path, "--cpu",
                           "--sz-only", "--quick", "--seed", "4", "--out",
                           str(out)])
    assert res.param_names == ["log(n_0)", r"\beta", "log(r_c)", "log(r_s)",
                               r"\epsilon", "P_0", "a", "b", "r_p",
                               "calibration"]
    assert res.chain.shape == (30, 3, 32, 10)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(
        res.log_prob))
    assert set(res.timings) == {"setup_s", "pack_s", "init_s",
                                "sampling_s", "summary_s"}
    acc = res.acceptance.mean(axis=1)
    assert np.all((acc > 0.02) & (acc < 0.9))
    i = res.param_names.index("P_0")
    assert res.truths[2, i] / res.truths[0, i] == pytest.approx(1.3 / 0.7)
    summary = json.loads(out.read_text())
    assert summary["param_names"] == res.param_names
    assert len(summary["clusters"]) == 3


def test_population_after_a_mock_survey(base_config, tmp_path):
    """--population P_0 runs after the whole fit and writes its block."""
    path = config_json(base_config, tmp_path / "cfg.json")
    out = tmp_path / "pop.json"
    res = survey.main(["--mock", "3", "--config", path, "--cpu", "--quick",
                       "--seed", "2", "--population", "P_0", "--out",
                       str(out)])
    pop = json.loads(out.read_text())["population"]
    assert pop["param"] == "P_0" and pop["family"] == "lognormal"
    assert len(pop["weight_n_eff"]) == 3
    assert np.isfinite([pop["mu"], pop["sigma"], pop["mu_sd"]]).all()
    # the population mean lies among the clusters' log medians
    lm = np.log(res.medians[:, res.param_names.index("P_0")])
    assert lm.min() - 1.0 < pop["mu"] < lm.max() + 1.0


@pytest.mark.parametrize("flags", [(), ("--sz-only",)], ids=["joint",
                                                            "sz_only"])
def test_write_observation_roundtrip(base_config, tmp_path, flags):
    """A mock written as a dataset (``synth.write_observation``) builds a
    session whose data are the mock's: flux and counts equal, the rest the
    base dataset's; a mock without counts gives an SZ-only config."""
    from joxsz_torch.simulate import simulate_survey
    from joxsz_torch.synth import write_observation

    cfg, _, sz_only = family_configs(base_config, flags)
    sess = build_session(cfg, device="cpu", sz_only=sz_only)
    truths = survey.mock_truths(sess.params, 2)
    mock = simulate_survey(sess.model, truths,
                           np.random.default_rng(3)).mocks[1]
    new = write_observation(cfg, mock, tmp_path / "mock")
    assert (new.xray is None) == sz_only
    back = build_session(new, device="cpu")
    np.testing.assert_allclose(back.model.sz_data.flux.numpy(),
                               mock.sz_flux, rtol=1e-15)
    assert torch.equal(back.model.sz_data.L, sess.model.sz_data.L)
    if not sz_only:
        np.testing.assert_array_equal(
            back.model.xray_data.counts_filled.numpy(), mock.xray_counts)
        assert torch.equal(back.model.xray_data.exposures,
                           sess.model.xray_data.exposures)
    assert back.params.thawed == sess.params.thawed
