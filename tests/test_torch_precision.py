"""Port parity in float32 at the likelihood's edges: the counterpart of the
kernel cases of ``tests/test_precision.py``.

Those cases need the real CL J1226 files and skip without them; here both
packages run on the synthetic CL J1226 dataset (``joxsz_torch.synth``,
seed 11), and the port's float32 kernel arithmetic (``joint_ll_plain``,
which the CUDA kernel follows step for step) is held to them:

* the veto-flip pin: 512 walkers at multiplicative spreads 0.1 and 0.2
  around the synthetic truth (``np.random.default_rng(7)``, as there), for
  the flagship, double density and knots, each cloud straddling the veto
  boundary; ``joint_ll_plain`` gives the JAX package's float64 verdict on
  every row.  It differs from the JAX kernel in interpret mode on exactly
  the rows where that float32 kernel flips against float64 (``PINNED``):
  one row of the flagship's 0.2 cloud, a state float64 keeps whose mass
  sits on the monotonicity veto's boundary at the outermost radius (the
  JAX package's PARITY.md deviation 5), which the JAX kernel vetoes and
  its float32 ``log_like`` keeps; the port decides such near-ties as
  float64 does (``ops/mass_veto.py``), a deliberate difference from the
  JAX float32 kernel, adjudicated here in float64;
* the gNFW derivative at ``_UNDERFLOW_THETA`` (a ~ 19.7, r_p ~ 126):
  strictly negative in float32 at the outermost pressure radius, and the
  float32 log-posterior finite where float64 is;
* the softplus overflow edge: a = 25, 28 and 40 inside a box whose upper
  bound of ``a`` is 60, the float32 kernel arithmetic finite where the
  JAX package's float32 ``log_like`` is and within 0.1 of it.

``test_phase_26_on_card`` runs the card's side (``chip_smoke.py --only
26``: these clouds through kernel 1) and skips without a card.
"""

import copy
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.synth import truth_theta, write_synthetic_dataset
from joxsz_tpu.ops.pallas_joint import make_joint_core

from test_torch_build import jax_session

REPO = pathlib.Path(__file__).resolve().parents[1]
SPREADS = (0.1, 0.2)
FAMILIES = {"flagship": {}, "double": {"density_mode": "double"},
            "knots": {"pressure_model": "knots"}}
# (family, spread) -> rows where the JAX float32 kernel vetoes and the JAX
# float32 log_like and float64 keep: near-ties that joint_ll_plain decides
# as float64 does, so that it differs from the JAX kernel there (a
# deliberate difference); elsewhere none
PINNED = {("flagship", 0.2): [200]}
# a flip's float64 mass-veto margin, min(gradient(M)) / max|gradient(M)|,
# lies below this: the state sits on the veto's boundary
BOUNDARY = 1e-3
# tests/test_precision.py:_UNDERFLOW_THETA
_UNDERFLOW_THETA = {
    "log(n_0)": -1.3871971, r"\beta": 0.21283358, "log(r_c)": 1.7109979,
    "log(r_s)": 2.1557074, r"\epsilon": 2.6171775,
    "log(T_X/T_{SZ})": 0.093440391, "Z": 0.20441175, "P_0": 0.19654875,
    "a": 19.731991, "b": 2.0354238, "r_p": 125.73824,
    "backscale": 0.96535051, "calibration": 1.1109961,
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(
        str(tmp_path_factory.mktemp("torch_precision")), 11)


def veto_cloud(sess, spread: float) -> np.ndarray:
    """The pin's 512 float32 rows around the synthetic truth."""
    th0 = truth_theta(sess)
    rng = np.random.default_rng(7)
    return (th0[None] * (1 + spread * rng.standard_normal(
        (512, th0.size)))).astype(np.float32)


def mass_margin(js64, row) -> float:
    """The float64 mass-veto margin of ``row``: min(gradient(M)) over the
    pressure grid relative to max|gradient(M)| (the JAX package's
    ``scripts/cpu_finite_mask_adjudicate.py``)."""
    m = js64.model
    pars = m.params.unpack(jnp.asarray(row, jnp.float64))
    g = np.gradient(np.asarray(m.mass(pars, jnp.asarray(
        m.sz_data.r_press_kpc, jnp.float64))))
    return float(g.min() / np.abs(g).max())


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_veto_flip_rate_pinned(dataset, fam):
    cfg = copy.deepcopy(dataset)
    for k, v in FAMILIES[fam].items():
        setattr(cfg, k, v)
    sess = build_session(cfg, device="cpu")
    c = pack_consts(sess)
    js32 = jax_session(cfg, "float32")
    core = make_joint_core(js32, block_b=64, interpret=True)
    assert core is not None
    xla = jax.jit(jax.vmap(js32.log_like))
    js64 = jax_session(cfg)
    xla64 = jax.jit(jax.vmap(js64.log_like))
    for spread in SPREADS:
        rows = veto_cloud(sess, spread)
        p = np.isfinite(joint_ll_plain(torch.tensor(rows), c).numpy())
        k = np.isfinite(np.asarray(core(jnp.asarray(rows))))
        x = np.isfinite(np.asarray(xla(jnp.asarray(rows))))
        f64 = np.isfinite(np.asarray(xla64(jnp.asarray(rows, jnp.float64))))
        assert 0.05 < x.mean() < 0.95, (fam, spread, x.mean())
        assert np.array_equal(p, f64), (fam, spread,
                                        np.flatnonzero(p != f64).tolist())
        flips = np.flatnonzero(p != k).tolist()
        assert flips == np.flatnonzero(k != x).tolist()
        assert flips == PINNED.get((fam, spread), []), (fam, spread, flips)
        assert p[flips].all() and not k[flips].any()
        for i in flips:
            assert 0 < mass_margin(js64, rows[i]) < BOUNDARY


@pytest.fixture(scope="module")
def flagship(dataset):
    sess = build_session(dataset, device="cpu")
    return (sess, build_session(dataset, device="cpu", dtype=torch.float32),
            jax_session(dataset, "float32"))


def test_f32_gnfw_derivative_no_underflow_veto(flagship):
    s64, s32, js32 = flagship
    theta = np.array([_UNDERFLOW_THETA[n] for n in s64.params.thawed])
    r_edge = s64.model.sz_data.r_press_kpc[-1:]
    d64 = float(s64.model.pressure.derivative(
        s64.params.unpack(torch.tensor(theta[None])), r_edge)[0, 0])
    d32 = float(s32.model.pressure.derivative(
        s32.params.unpack(torch.tensor(theta[None], dtype=torch.float32)),
        r_edge.float())[0, 0])
    dj = float(js32.model.pressure.derivative(
        js32.params.unpack(jnp.asarray(theta, jnp.float32)),
        jnp.float32(r_edge[0])))
    assert d64 < 0
    assert d32 < 0, "f32 dP/dr underflowed to -0 at the outer grid point"
    assert abs(d32 - d64) < 1e-4 * abs(d64)
    assert abs(d32 - dj) < 1e-5 * abs(dj)
    ll64 = float(s64.model.log_like_batch(torch.tensor(theta[None]))[0])
    assert np.isfinite(ll64)
    row = torch.tensor(theta[None], dtype=torch.float32)
    assert np.isfinite(float(joint_ll_plain(row, pack_consts(s64))[0])), \
        "f32 kernel arithmetic falsely vetoed a genuine posterior state"
    assert np.isfinite(float(s32.model.log_like_batch(row)[0]))


def test_kernel_gnfw_softplus_no_overflow_veto(flagship):
    """Past the float32 exp overflow edge (a ln x > 88.7 at the outer
    radii) the kernel arithmetic's stable softplus keeps genuine states."""
    sess, _, js32 = flagship
    ia = sess.params.thawed.index("a")
    hi = sess.params.hi[ia], js32.params.hi[ia]
    sess.params.hi[ia] = js32.params.hi[ia] = 60.0   # a custom prior box
    try:
        theta = np.array([_UNDERFLOW_THETA[n] for n in sess.params.thawed],
                         dtype=np.float32)
        rows = np.repeat(theta[None], 3, axis=0)
        rows[:, ia] = (25.0, 28.0, 40.0)
        lx = np.asarray(jax.jit(jax.vmap(js32.log_like))(jnp.asarray(rows)))
        lp = joint_ll_plain(torch.tensor(rows), pack_consts(sess)).numpy()
        lk = np.asarray(make_joint_core(js32, block_b=64, interpret=True)(
            jnp.asarray(rows)))
    finally:
        sess.params.hi[ia], js32.params.hi[ia] = hi
    assert np.all(np.isfinite(lx)), lx
    assert np.all(np.isfinite(lp)), ("falsely vetoed past the exp overflow "
                                     "edge", lp)
    assert np.max(np.abs(lp - lx)) < 0.1, (lp, lx)
    np.testing.assert_allclose(lp, lk, rtol=2e-4, atol=0.5)


def test_launch_plan_mirror_at_cl1226(flagship):
    """The host's mirror of the launch plan needs, for the step kernel at
    the CL J1226 shapes, exactly the 203008 B of shared memory a block
    that the card reports for it (``chip_smoke.py`` phase 6): staged
    there, the constants read in place one byte below."""
    from joxsz_torch.ops.consts_layout import launch_plan

    params = pack_consts(flagship[0]).params
    assert launch_plan(params, "stretch_steps") == "staged"
    assert launch_plan(params, "stretch_steps", 203008) == "staged"
    assert launch_plan(params, "stretch_steps", 203007) == "in place"


@pytest.mark.gpu
def test_phase_26_on_card():
    """The card's side of this file: ``chip_smoke.py --only 26`` takes
    these clouds through kernel 1 against ``joint_ll_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--only", "26"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert '"ok": true' in out.stdout.strip().splitlines()[-1]
