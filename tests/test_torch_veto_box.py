"""Port: the float32 mass veto over the whole production prior box.

At the corners of the production box n_e^2 leaves float32's normal range
at the outer pressure radii (n_e below ~1.1e-19 cm^-3) and the hydrostatic
mass passes 3.4e38, so the JAX kernels' float32 form of the likelihood
(``ll_body``) vetoes there rows its float64 model keeps.  The port's
kernel arithmetic (``joint_ll_plain``, which kernel 1 follows step for
step) forms 1/n_e from ln n_e^2 where n_e^2 is not a normal float and
compares the mass scaled by n_0 / |P_0|, as a signed logarithm where the
product would leave float32's range (``csrc/joint_ll.cuh``), and decides
the pairs it cannot order for sure as float64 does (``ops/mass_veto.py``).

Here production-box prior draws (``sample_prior``, ``np.random.
default_rng(2)``) on a small dataset whose pressure grid runs from 16 to
5008 kpc go through ``joint_ll_plain`` and the port's float64 model, for
the flagship and the families whose density, temperature or mass veto
differ: no row float64 keeps above ``NEGLIGIBLE_LP`` is -inf in float32,
near-ties included (no exemption for rows whose float64 margin, min
(gradient M) / max|gradient M|, is small), the float32 mass veto's
verdict is the float64 model's on every draw, and the draws reach the
densities that underflowed.  On the
first VERDICT_ROWS draws the port's float64 verdict is the JAX package's
float64 ``log_like``'s.  ``chip_smoke.py`` phase 26 runs 4096 such draws
through kernel 1 on the card.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.sampling.priors import model_log_prior, sample_prior
from joxsz_torch.sampling.sbc import NEGLIGIBLE_LP, veto_margins
from joxsz_torch.synth import write_synthetic_dataset

from test_torch_build import jax_session, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

# tag -> (config fields, prior draws, sample_prior's batch): the knots'
# support is ~0.1% of their box, so they take fewer draws from larger
# batches
FAMILIES = {
    "flagship": ({}, 2048, None),
    "double": ({"density_mode": "double"}, 1024, None),
    "vikhlinin": ({"temperature_model": "vikhlinin"}, 1024, None),
    "knots": ({"pressure_model": "knots"}, 128, 16384),
}
VERDICT_ROWS = 256
# n_e (cm^-3) below which n_e^2 is not a normal float32
NE_UNDERFLOW = 1.1e-19


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(
        str(tmp_path_factory.mktemp("torch_veto_box")), 3, n_annuli=6,
        n_sz=6, max_radius_arcsec=30.0)


_BOX = {}


def box_draws(dataset, tag):
    """(config, session, draws, float64 lp) of family ``tag``, once."""
    if tag not in _BOX:
        fields, n, batch = FAMILIES[tag]
        cfg = copy.deepcopy(dataset)
        for k, v in fields.items():
            setattr(cfg, k, v)
        sess = build_session(cfg, device="cpu")
        m = sess.model
        th = sample_prior(model_log_prior(m), m.params, n,
                          np.random.default_rng(2), batch=batch,
                          max_tries=64 if batch is None else 200)
        with torch.no_grad():
            l64 = m.log_like_batch(torch.tensor(th)).numpy()
        _BOX[tag] = (cfg, sess, th, l64)
    return _BOX[tag]


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_no_float32_loss_over_the_box(dataset, tag):
    _, sess, th, l64 = box_draws(dataset, tag)
    m = sess.model
    l32 = joint_ll_plain(torch.tensor(th, dtype=torch.float32),
                         pack_consts(sess)).numpy()
    live = l64 > NEGLIGIBLE_LP
    assert live.sum() >= 0.3 * len(th), (tag, live.sum())
    lost = np.flatnonzero(live & ~np.isfinite(l32))
    assert lost.size == 0, (tag, lost.tolist(),
                            veto_margins(m, th[lost]).tolist())
    # the mass veto alone: float32's verdict is float64's on every draw
    det = {}
    joint_ll_plain(torch.tensor(th, dtype=torch.float32), pack_consts(sess),
                   det)
    with torch.no_grad():
        pars = m.params.unpack(torch.tensor(th))
        v64 = m._mass_veto_ok(pars, m.sz_data.r_press_kpc).numpy()
    mono = det["mono"].numpy()[:, 0]
    assert np.array_equal(mono, v64), (tag,
                                       np.flatnonzero(mono != v64).tolist())
    # the draws reach the densities whose square underflows float32
    with torch.no_grad():
        ne = m.density(m.params.unpack(torch.tensor(th[live])),
                       m.sz_data.r_press_kpc[-1:]).numpy()
    assert (ne < NE_UNDERFLOW).sum() >= 0.1 * live.sum(), tag


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_float64_verdict_is_the_jax_one(dataset, tag):
    cfg, _, th, l64 = box_draws(dataset, tag)
    rows = th[:VERDICT_ROWS]
    js64 = jax_session(cfg)
    lj = np.asarray(jax.jit(jax.vmap(js64.log_like))(
        jnp.asarray(rows, jnp.float64)))
    keep = l64[:VERDICT_ROWS] > NEGLIGIBLE_LP
    assert 0 < keep.sum() < len(rows) or tag == "vikhlinin", keep.sum()
    assert np.array_equal(keep, lj > NEGLIGIBLE_LP), (
        tag, np.flatnonzero(keep != (lj > NEGLIGIBLE_LP)).tolist())
