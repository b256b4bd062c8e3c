"""Port parity: emcee's differential-evolution moves
(``joxsz_torch.sampling.stretch``) against ``joxsz_tpu.sampling.stretch``.

The same uniforms (``u3``/``u4``, laid out (k, H) in the JAX package and
(H, k) in the port) and normals feed ``de_half_update`` and
``snooker_half_update`` of both packages on a float64 Gaussian
log-probability: positions, log-probs and decisions agree to 1e-12.
The plain sampler runs each move (``make_step`` / ``run_ensemble``), and
``run_fit`` refuses a non-stretch move on the step kernels, the mesh and
the tempered paths, as the JAX driver does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.sampling import stretch as ts
from joxsz_torch.sampling.driver import run_fit
from joxsz_tpu.sampling import stretch as js

TOL = 1e-12
D, H = 5, 12
MU = np.linspace(-1.0, 1.0, D)


def lp_torch(x):
    return -0.5 * ((x - torch.tensor(MU)) ** 2).sum(-1) * 4.0


def lp_jax(x):
    return -0.5 * jnp.sum((x - MU) ** 2, axis=-1) * 4.0


@pytest.fixture
def block():
    rng = np.random.default_rng(9)
    x_move = MU + 0.5 * rng.standard_normal((H, D))
    x_fixed = MU + 0.5 * rng.standard_normal((H + 2, D))
    return rng, x_move, x_fixed, lp_jax(x_move)


def _agree(port, jax_out):
    for a, b in zip(port, jax_out):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("beta", [None, 0.4])
def test_de_half_update_matches_jax(block, beta):
    rng, x_move, x_fixed, lp0 = block
    u3 = rng.random((3, H))
    g1 = rng.standard_normal(H)
    g0 = ts.de_gamma0(D)
    assert g0 == js.de_gamma0(D)
    want = js.de_half_update(lp_jax, jnp.asarray(u3), jnp.asarray(g1),
                             jnp.asarray(x_move), lp0, jnp.asarray(x_fixed),
                             g0, 0.1, beta=beta)
    got = ts.de_half_update(lp_torch, torch.tensor(u3.T), torch.tensor(g1),
                            torch.tensor(x_move),
                            torch.tensor(np.asarray(lp0)),
                            torch.tensor(x_fixed), g0, 0.1, beta=beta)
    _agree(got, want)
    assert 0 < int(got[2].sum()) < H


@pytest.mark.parametrize("beta", [None, 0.4])
def test_snooker_half_update_matches_jax(block, beta):
    rng, x_move, x_fixed, lp0 = block
    u4 = rng.random((4, H))
    # a walker coincident with its anchor: the measure-zero case rejects
    iz = np.minimum((u4[0] * (H + 2)).astype(int), H + 1)
    x_move[0] = x_fixed[iz[0]]
    lp0 = lp_jax(x_move)
    want = js.snooker_half_update(lp_jax, jnp.asarray(u4),
                                  jnp.asarray(x_move), lp0,
                                  jnp.asarray(x_fixed), D, beta=beta)
    got = ts.snooker_half_update(lp_torch, torch.tensor(u4.T),
                                 torch.tensor(x_move),
                                 torch.tensor(np.asarray(lp0)),
                                 torch.tensor(x_fixed), D, beta=beta)
    _agree(got, want)
    assert not bool(got[2][0])


def test_distinct3_matches_jax():
    rng = np.random.default_rng(2)
    u = rng.random((3, 4000))
    for hf in (3, 4, 17):
        want = js._distinct3(jnp.asarray(u), hf)
        got = ts._distinct3(torch.tensor(u.T), hf)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        i0, i1, i2 = (a.numpy() for a in got)
        assert np.all((i0 != i1) & (i0 != i2) & (i1 != i2))
        assert max(i0.max(), i1.max(), i2.max()) == hf - 1


@pytest.mark.parametrize("move", ["stretch", "de", "snooker"])
def test_run_ensemble_each_move(move):
    """Each move samples the Gaussian: the walkers' mean near MU, a sane
    acceptance, and the stretch stream unchanged by the move switch."""
    gen = torch.Generator().manual_seed(5)
    p0 = torch.tensor(MU + 0.3 * np.random.default_rng(1).standard_normal(
        (32, D)))
    r = ts.run_ensemble(lp_torch, p0, 600, gen, thin=3, move=move)
    assert r.chain.shape == (200, 32, D)
    assert 0.1 < float(np.mean(r.acceptance_fraction)) < 0.9
    np.testing.assert_allclose(r.chain[100:].mean(axis=(0, 1)), MU, atol=0.1)
    if move == "stretch":
        gen2 = torch.Generator().manual_seed(5)
        r2 = ts.run_ensemble(lp_torch, p0, 600, gen2, thin=3)
        np.testing.assert_array_equal(r.chain, r2.chain)


@pytest.mark.parametrize("move,w", [("de", 2), ("snooker", 4)])
def test_moves_need_enough_walkers(move, w):
    step = ts.make_step(lp_torch, D, move=move)
    x = torch.zeros((w, D), dtype=torch.float64)
    with pytest.raises(ValueError, match="walkers"):
        step(x, lp_torch(x), torch.zeros(w), torch.Generator())
    with pytest.raises(ValueError, match="unknown move"):
        ts.make_step(lp_torch, D, move="walk")


class _Sampler:
    device = torch.device("cpu")


@pytest.mark.parametrize("where", ["step_kernel", "mesh", "tempered"])
def test_run_fit_refuses_a_move_off_the_plain_sampler(where):
    kw = {"step_kernel": dict(step_sampler=_Sampler()),
          "mesh": dict(step_sampler=None, mesh=object()),
          "tempered": dict(step_sampler=None, n_temper_rungs=3)}[where]
    sampler = kw.pop("step_sampler")
    with pytest.raises(ValueError, match="stretch only"):
        run_fit(None, sampler, MU, MU - 5, MU + 5, list("abcde"),
                move="de", **kw)
