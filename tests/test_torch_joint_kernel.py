"""Port parity: kernel 1's plain version against the Pallas joint kernel.

``joxsz_torch.ops.joint_kernel.joint_ll_plain`` is the float32 arithmetic
of the CUDA kernel ``csrc/joint_ll.cu`` written in plain torch.  Here it
is held against ``joxsz_tpu.ops.pallas_joint.make_joint_core`` in
interpret mode (the JAX package's own CPU route to that kernel) at
``rtol=2e-4, atol=0.5`` — the kernel-vs-XLA tolerance of
``tests/test_pallas_joint.py``: float32 roundoff of ~1e4-magnitude sums —
with identical veto masks.  The rows cover every veto and count-rate
lookups below and above the table's temperature grid.

A second dataset at z = 0.3 has more map radii than one pass of the
kernel's ``pp @ L^T`` (96) and more pressure radii; rows drawn around the
synthetic truth, with one row per veto, hold there too.

The CUDA kernel itself runs only on a card: ``test_kernel_matches_plain_
on_card`` is marked ``gpu`` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops import consts_layout
from joxsz_torch.ops.joint_kernel import (MAX_D, JointConsts, joint_ll,
                                          joint_ll_plain, pack_consts)
from joxsz_torch.ops.sz_core import KSPLIT
from joxsz_torch.synth import TRUTH, write_synthetic_dataset
from joxsz_tpu.ops.pallas_joint import make_joint_core

from test_torch_build import jax_session, small_config
from test_torch_models import veto_rows

RTOL, ATOL = 2e-4, 0.5


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_joint"))
    sess = build_session(cfg, device="cpu")
    return sess, pack_consts(sess), jax_session(cfg, "float32")


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """Six annuli x 10 bands, six SZ points out to 160" at z = 0.3: 107
    map radii, 130 pressure radii."""
    cfg = write_synthetic_dataset(
        str(tmp_path_factory.mktemp("torch_joint_wide")), 3, n_annuli=6,
        n_sz=6, max_radius_arcsec=160.0, extent_kpc=1200.0, redshift=0.3)
    sess = build_session(cfg, device="cpu")
    return sess, pack_consts(sess), jax_session(cfg, "float32")


def truth_rows(params, n: int = 21, seed: int = 6):
    """n draws within 3% of the synthetic truth (log(r_s) held at 2.85,
    inside its box, which ends at 2.93 here), then one row out of the box,
    one with r_c > r_s and one with a falling HSE mass."""
    th0 = np.array([TRUTH[k] for k in params.thawed])
    rng = np.random.default_rng(seed)
    rows = th0 * (1 + 0.03 * rng.standard_normal((n + 3, th0.size)))
    ix = params.thawed.index
    rows[:, ix("log(r_s)")] = 2.85
    rows[n, ix("P_0")] = -0.5
    rows[n + 1, ix("log(r_c)")], rows[n + 1, ix("log(r_s)")] = 3.0, 2.0
    rows[n + 2, [ix("b"), ix("a"), ix("r_p"), ix(r"\beta")]] = (
        14.0, 5.0, 150.0, 0.2)
    return rows.astype(np.float32)


def kernel_rows(params):
    """veto_rows plus one hot row (T_X above the table's grid) and one
    cold row (T_X below it)."""
    rows = veto_rows(params, n=28, seed=4)
    ix = params.thawed.index
    hot = rows[4].copy()
    hot[ix("log(T_X/T_{SZ})")], hot[ix("P_0")] = 0.98, 1.5
    cold = rows[5].copy()
    cold[ix("P_0")] = 2e-4
    return np.concatenate([np.stack([hot, cold]), rows])


def test_rows_leave_the_temperature_grid(sessions):
    sess, _, _ = sessions
    m = sess.model
    rows = torch.tensor(kernel_rows(sess.params)[:2])
    T = m.temperature.t_x(sess.params.unpack(rows), m.xray_data.midpt_kpc)
    tlog = m.xray_data.table.Tlog
    assert float(torch.log(T[0]).max()) > float(tlog[-1])
    assert float(torch.log(T[1]).min()) < float(tlog[0])


def test_plain_matches_interpret_kernel(sessions):
    sess, c, js32 = sessions
    rows = kernel_rows(sess.params).astype(np.float32)
    core = make_joint_core(js32, block_b=8, interpret=True)
    assert core is not None
    b = np.asarray(core(jnp.asarray(rows)))
    a = joint_ll_plain(torch.tensor(rows), c).numpy()
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert fin.sum() == rows.shape[0] - 4
    assert np.isfinite(a[:2]).all()
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)


def test_wide_map_matches_interpret_kernel(wide):
    """More map radii than one pass of pp @ L^T and more pressure radii:
    the same rule as on the small dataset."""
    sess, c, js32 = wide
    assert (c.ints["n_pix"], c.ints["n_press"]) == (107, 130)
    rows = truth_rows(sess.params)
    core = make_joint_core(js32, block_b=8, interpret=True)
    assert core is not None
    b = np.asarray(core(jnp.asarray(rows)))
    a = joint_ll_plain(torch.tensor(rows), c).numpy()
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert fin[:-3].all() and not fin[-3:].any()
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)


def test_plain_matches_float64_model(sessions):
    sess, c, _ = sessions
    rows = kernel_rows(sess.params)
    a = joint_ll_plain(torch.tensor(rows, dtype=torch.float32), c).numpy()
    b = sess.model.log_like_batch(torch.tensor(rows)).numpy()
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)


def test_wrapper_runs_plain_version_on_cpu(sessions):
    sess, c, _ = sessions
    rows = torch.tensor(kernel_rows(sess.params), dtype=torch.float32)
    before = joint_ll.launches
    out = joint_ll(rows, c)
    assert joint_ll.launches == before
    assert torch.equal(out, joint_ll_plain(rows, c))
    assert out.dtype == torch.float32 and out.shape == (rows.shape[0],)


def test_wrapper_checks_its_inputs(sessions):
    sess, c, _ = sessions
    with pytest.raises(ValueError, match="theta must be"):
        joint_ll(torch.zeros(4, c.ints["D"] + 1), c)
    with pytest.raises(ValueError, match="theta must be"):
        joint_ll(torch.zeros(c.ints["D"]), c)


def test_consts_layout(sessions):
    """Host-side packing: every array sits at a 16-byte-aligned offset of
    one float32 buffer and reads back as the session's values."""
    sess, c, _ = sessions
    assert isinstance(c, JointConsts) and c.buf.dtype == torch.float32
    assert all(off % 4 == 0 for off in c.offsets.values())
    sz = sess.model.sz_data
    np.testing.assert_allclose(c.arrays["LT"].numpy(),
                               sz.L.T.numpy().astype(np.float32))
    assert c.ints["n_pix"] == c.ints["sep"] + 1 == sz.L.shape[0]
    assert c.ints["n_band"] == 10 and c.ints["D"] == 13
    assert sorted(c.cix) == list(range(13))


def _header_defines(name: str = "joint_ll.cuh") -> dict:
    """The integer #defines of csrc/<name> (after joint_ll.cuh's, which
    it includes), evaluated in order."""
    import pathlib
    import re

    csrc = pathlib.Path(consts_layout.__file__).resolve().parents[1] / "csrc"
    src = (csrc / "joint_ll.cuh").read_text()
    if name != "joint_ll.cuh":
        src += (csrc / name).read_text()
    env: dict = {}
    for name, expr in re.findall(r"^#define (\w+) (.+?)\s*(?://.*)?$", src,
                                 re.M):
        try:
            env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
        except (NameError, SyntaxError):
            pass
    return env


@pytest.mark.parametrize("name, value", [
    ("N_INTS", len(consts_layout.INTS)),
    ("N_FLOATS", len(consts_layout.FLOATS)),
    ("N_ROLES", len(consts_layout.ROLES)),
    ("N_ARRAYS", len(consts_layout.ARRAYS)),
    ("MAX_D", MAX_D),
    ("KSPLIT", KSPLIT),
    ("TILE_WALKERS", consts_layout.TILE_WALKERS),
    ("PIX_PASS", consts_layout.PIX_PASS),
    ("SC_STRIDE", consts_layout.SC_STRIDE),
    ("XS_N", consts_layout.XS_N),
    ("PAIR_CAP", consts_layout.PAIR_CAP),
    ("KX_COLS", consts_layout.KX_COLS),
])
def test_header_matches_the_packers(name, value):
    """The launch vectors, the plain mirror's sum order and the host's
    launch-plan mirror have the sizes the CUDA header reads them with."""
    assert _header_defines()[name] == value


def test_half_extra_matches_the_plan_mirror():
    """The step kernels' own shared memory (csrc/stretch_step.cu), which
    consts_layout.launch_plan adds to the tile's scratch."""
    assert (_header_defines("stretch_step.cu")["HALF_EXTRA"]
            == consts_layout.HALF_EXTRA)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(sessions):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sess, _, _ = sessions
    c = pack_consts(sess, device="cuda")
    rows = torch.tensor(kernel_rows(sess.params), dtype=torch.float32,
                        device="cuda")
    a = joint_ll(rows, c).cpu().numpy()
    b = joint_ll_plain(rows, c).cpu().numpy()
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)



def test_chi2_terms_added_in_order():
    """The plain version adds the squared SZ residuals in order, as one
    thread of the tile does, bit for bit."""
    from joxsz_torch.ops.sz_core import seq_sum

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 40)) ** 2 * 10.0 ** rng.uniform(
        -2, 4, (3, 40))).astype(np.float32)
    want = np.zeros(3, np.float32)
    for i in range(x.shape[1]):
        want = (want + x[:, i]).astype(np.float32)
    assert np.array_equal(seq_sum(torch.tensor(x)).numpy(), want)


def test_bright_corner_row_within_the_kernels_value(tmp_path):
    """The nT96 corner (24 annuli x 12 bands, 40 SZ points, seed 52): on
    its hot row, an SZ chi^2 of 1.8e5, kernel 1 on an H100 80GB HBM3 gave
    -62150.328125 and the plain version 0.0547 from it while its chi^2
    terms were summed in torch's order; added in order, as the tile adds
    them, it stays within the card's 0.05 bar of the kernel."""
    from joxsz_torch.synth import CORNERS, write_corner

    cfg, _ = write_corner(str(tmp_path), 52, CORNERS["nT96_many_annuli"])
    sess = build_session(cfg, device="cpu")
    row = torch.tensor([[-1.8599205017089844, 0.7741472721099854,
                         1.9451695680618286, 2.990454912185669,
                         2.9178848266601562, 0.9800000190734863,
                         0.30642983317375183, 1.5, 1.324729323387146,
                         4.2608256340026855, 429.7474365234375,
                         1.0206856727600098, 1.0087056159973145]])
    plain = float(joint_ll_plain(row, pack_consts(sess))[0])
    f64 = float(sess.model.log_like_batch(row.double())[0])
    assert abs(plain - -62150.328125) < 0.05
    assert abs(plain - f64) < RTOL * abs(f64)
