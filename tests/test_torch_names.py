"""The port's public names: every public name of ``joxsz_tpu`` has a
counterpart in ``joxsz_torch``, module by module, apart from ``ALLOWED``.

The JAX package is read with ``ast`` (its public top-level functions,
classes and assignments, the names its ``__init__`` files re-export, and
the public methods and properties of its classes); the port is imported
and asked with ``getattr``, so its lazy exports count.  A name the port
lacks fails here unless ``ALLOWED`` gives the reason it needs no
counterpart; an entry the port has come to cover fails too, so the list
stays true.

The functions added to close the last gaps are held against their JAX
counterparts on the same numpy float64 inputs, at rtol 1e-12 (atol
1e-15 where a value can be 0).
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_build import jax_session, small_config, truth_rows

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "joxsz_tpu"
TOL = 1e-12

# (module, name) -> why the port needs no counterpart; a module entry
# has name None
ALLOWED = {
    ("ops/pallas_joint.py", None):
        "the Pallas kernels: the port's are joxsz_torch/csrc/*.cu with "
        "their bindings in joxsz_torch/ops/*_kernel.py",
    ("ops/pallas_kernels.py", None):
        "the Pallas SZ core: the port's is ops/sz_core.py over "
        "csrc/sz_core.cu",
    ("ops/__init__.py", "make_joint_core"):
        "the Pallas joint-likelihood builder: the port's counterpart is "
        "ops/joint_kernel.py::joint_ll",
    ("config.py", "MCMCConfig.converged_tpu"):
        "the TPU production schedule: the port's is "
        "MCMCConfig.converged_gpu",
    ("parallel/mesh.py", "walker_sharding"):
        "a jax.sharding builder: the port places blocks on a Mesh of "
        "devices (parallel/mesh.py::scatter)",
    ("parallel/mesh.py", "cluster_walker_sharding"):
        "a jax.sharding builder (see walker_sharding)",
    ("parallel/mesh.py", "replicated"):
        "a jax.sharding builder (see walker_sharding)",
    ("parallel/sharded.py", "make_sharded_drive"):
        "a shard_map program builder: the port runs each shard's block "
        "through run_sharded_ensemble",
    ("parallel/sharded.py", "make_multicluster_step"):
        "a shard_map program builder: the port's cluster blocks run "
        "through run_multi_cluster",
    ("parallel/kernel_sharded.py", "make_sharded_kernel_step"):
        "a shard_map program builder: the port's per-shard kernel runs "
        "are run_sharded_kernel_ensembles",
    ("parallel/kernel_sharded.py", "make_sharded_tempered_step"):
        "a shard_map program builder: the port's are "
        "run_sharded_tempered_ensembles",
    ("parallel/__init__.py", "walker_sharding"):
        "re-export of parallel/mesh.py::walker_sharding",
    ("parallel/__init__.py", "cluster_walker_sharding"):
        "re-export of parallel/mesh.py::cluster_walker_sharding",
    ("parallel/__init__.py", "replicated"):
        "re-export of parallel/mesh.py::replicated",
    ("parallel/__init__.py", "make_sharded_drive"):
        "re-export of parallel/sharded.py::make_sharded_drive",
    ("parallel/__init__.py", "make_sharded_kernel_step"):
        "re-export of parallel/kernel_sharded.py::make_sharded_kernel_step",
    ("parallel/__init__.py", "make_sharded_tempered_step"):
        "re-export of parallel/kernel_sharded.py::"
        "make_sharded_tempered_step",
    ("tablegen/generate.py", "build_native"):
        "builds the JAX package's C++ table core: the port generates "
        "tables in torch (tablegen/spectrum.py)",
    ("tablegen/__init__.py", "build_native"):
        "re-export of tablegen/generate.py::build_native",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_names(path: pathlib.Path) -> set:
    """Public names of one JAX module: top-level functions, classes and
    assignments, re-exports of an ``__init__``, and "Class.method" for
    the public methods and properties of its public classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _public(m.name)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets
                    if isinstance(t, ast.Name) and _public(t.id)}
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out |= {a.asname or a.name for a in node.names
                    if _public(a.asname or a.name)}
    return out


def _modules():
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def torch_module(rel: str):
    parts = ["joxsz_torch"] + rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    try:
        return importlib.import_module(".".join(parts))
    except ModuleNotFoundError:
        return None


def has_name(mod, name: str) -> bool:
    obj = mod
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def missing(rel: str) -> set:
    mod = torch_module(rel)
    if mod is None:
        return {None}
    return {n for n in jax_names(JAX_PKG / rel) if not has_name(mod, n)}


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    allowed = {n for (m, n) in ALLOWED if m == rel}
    if None in allowed:
        assert torch_module(rel) is None, f"{rel}: now ported; drop it " \
            "from ALLOWED"
        return
    gaps = missing(rel)
    assert gaps <= allowed, f"{rel}: no counterpart in joxsz_torch for " \
        f"{sorted(gaps - allowed)}"
    assert allowed <= gaps, f"{rel}: ALLOWED lists names the port now " \
        f"has: {sorted(allowed - gaps)}"


def test_allowed_entries_name_jax_modules_and_give_a_reason():
    for (rel, name), why in ALLOWED.items():
        assert (JAX_PKG / rel).exists(), rel
        assert name is None or name in jax_names(JAX_PKG / rel), (rel, name)
        assert why.strip(), (rel, name)


# ---- the new functions against their JAX counterparts --------------------

@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    from joxsz_torch.build import build_session

    cfg = small_config(tmp_path_factory.mktemp("torch_names"))
    return build_session(cfg, device="cpu"), jax_session(cfg)


SZ_OUTPUTS = ("ll", "chisq", "pp", "bright", "integ")


@pytest.mark.parametrize("output", SZ_OUTPUTS)
def test_sz_outputs_matches_jax(sessions, output):
    from joxsz_torch.models import sz_outputs
    from joxsz_tpu.models import sz_outputs as j_sz_outputs

    sess, js = sessions
    rows = truth_rows(sess.params, 4, seed=5)
    m, jm = sess.model, js.model
    a = sz_outputs(m.params.unpack(torch.tensor(rows)), m.sz_data,
                   m.pressure, m.temperature, output).numpy()

    def one(th):
        return j_sz_outputs(jm.params.unpack(th), jm.sz_data, jm.pressure,
                            jm.temperature, output)

    b = np.asarray(jax.vmap(one)(jnp.asarray(rows)))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=TOL, atol=0)


def test_sz_outputs_chisq_leaves_out_the_integrated_y_term(sessions):
    """'chisq' is the flux chi^2 only: with the integrated-Y term on,
    'll' = -chisq/2 less that term; an unknown output raises the JAX
    package's ValueError text."""
    import dataclasses

    from joxsz_torch.models import sz_integrated_y, sz_outputs

    sess, _ = sessions
    m = sess.model
    sz = dataclasses.replace(m.sz_data, calc_integ=True, integ_mu=0.0,
                             integ_sig=1e-3)
    pars = m.params.unpack(torch.tensor(truth_rows(sess.params, 3, 7)))
    args = (pars, sz, m.pressure, m.temperature)
    chisq, ll = sz_outputs(*args, "chisq"), sz_outputs(*args, "ll")
    integ = sz_integrated_y(pars, sz, m.pressure)
    term = 0.5 * ((integ - sz.integ_mu) / sz.integ_sig) ** 2
    assert bool((term > 0).all())
    torch.testing.assert_close(ll, -0.5 * chisq - term, rtol=TOL, atol=0)
    with pytest.raises(ValueError, match="output must be one of 'll', "
                                         "'chisq', 'pp', 'bright', 'integ'"):
        sz_outputs(*args, "nope")


@pytest.mark.parametrize("extrapolate", [True, False])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["1d", "leading-axis"])
def test_lerp_lookup_matches_jax(extrapolate, lead):
    from joxsz_torch.ops import lerp_lookup
    from joxsz_tpu.ops import lerp_lookup as j_lerp_lookup

    rng = np.random.default_rng(2)
    tx = np.sort(rng.uniform(0.0, 40.0, 12))
    ty = rng.standard_normal(lead + (12,))
    # inside, on the knots, and past both ends
    x = np.concatenate([rng.uniform(-10.0, 55.0, 40), tx,
                        [tx[0] - 3.0, tx[-1] + 7.0]]).reshape(6, 9)
    a = lerp_lookup(torch.tensor(tx), torch.tensor(ty), torch.tensor(x),
                    extrapolate=extrapolate).numpy()
    b = np.asarray(j_lerp_lookup(jnp.asarray(tx), jnp.asarray(ty),
                                 jnp.asarray(x), extrapolate=extrapolate))
    assert a.shape == b.shape == lead + x.shape
    np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-15)
    if not extrapolate:
        assert a.min() >= ty.min() and a.max() <= ty.max()


def test_forward_abel_matches_jax():
    from joxsz_torch.ops import forward_abel
    from joxsz_tpu.ops import forward_abel as j_forward_abel

    r = np.linspace(0.5, 40.0, 60)
    f = (1.0 + (r / 8.0) ** 2) ** -1.5
    for scheme in ("pyabel", "exact-linear"):
        np.testing.assert_allclose(forward_abel(f, r, scheme),
                                   j_forward_abel(f, r, scheme),
                                   rtol=TOL, atol=0)


def _hat_inputs():
    grid = np.linspace(np.log(0.06), np.log(60.0), 200)
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(grid[0] - 1.0, grid[-1] + 1.0, 30),
                        grid[[0, 1, 100, -2, -1]], [np.nan]]).reshape(6, 6)
    return grid, x


def test_uniform_hat_weights_matches_jax():
    from joxsz_torch.models.xray import uniform_hat_weights
    from joxsz_tpu.models.xray import uniform_hat_weights as j_weights

    grid, x = _hat_inputs()
    a = uniform_hat_weights(torch.tensor(grid), torch.tensor(x)).numpy()
    b = np.asarray(j_weights(jnp.asarray(grid), jnp.asarray(x)))
    assert a.shape == b.shape == x.shape + grid.shape
    np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-15)
    assert not a[5, 5].any()                        # the NaN position


def test_uniform_hat_weights_equal_the_two_tap_lerp():
    """The dense form times a table is ``uniform_hat_lerp``, the NaN rule
    included (both give 0)."""
    from joxsz_torch.models.xray import uniform_hat_lerp, uniform_hat_weights

    grid, x = _hat_inputs()
    table = np.random.default_rng(6).standard_normal((10, grid.size))
    g, xt, tt = (torch.tensor(v) for v in (grid, x, table))
    dense = torch.einsum("...j,bj->...b", uniform_hat_weights(g, xt), tt)
    taps = uniform_hat_lerp(g, tt, xt)
    torch.testing.assert_close(dense, taps, rtol=TOL, atol=1e-14)
    assert not taps[5, 5].any()


def test_count_rate_table_flux_matches_jax():
    from joxsz_torch.models.xray import CountRateTable
    from joxsz_tpu.models.xray import CountRateTable as JTable

    path = REPO / "data" / "tables" / "cl1226_ctrate.npz"
    tt = CountRateTable.from_npz(str(path), dtype=torch.float64,
                                 device="cpu")
    jt = JTable.from_npz(str(path))
    rng = np.random.default_rng(8)
    t_kev = rng.uniform(0.03, 80.0, (4, 7))         # past both ends too
    z = rng.uniform(0.0, 1.0, (4, 7))
    ne = rng.uniform(1e-4, 1e-1, (4, 7))
    a = tt.flux(*(torch.tensor(v) for v in (t_kev, z, ne)), 3.0e-15)
    b = jt.flux(*(jnp.asarray(v) for v in (t_kev, z, ne)), 3.0e-15)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=0)


def test_session_and_param_names_match_jax(sessions):
    """``FitSession.log_like``, ``Annuli.nshells``,
    ``ParamSet.table_rows`` and ``ParamSet.set_thawed_values``."""
    sess, js = sessions
    th = truth_rows(sess.params, 1, 9)[0]
    np.testing.assert_allclose(float(sess.log_like(torch.tensor(th))),
                               float(js.log_like(jnp.asarray(th))),
                               rtol=TOL)
    assert sess.annuli.nshells == js.annuli.nshells == 6
    assert sess.params.table_rows() == js.params.table_rows()
    sess.params.set_thawed_values(th)
    js.params.set_thawed_values(th)
    assert sess.params.table_rows() == js.params.table_rows()
    np.testing.assert_array_equal(sess.params.thawed_values(), th)
