"""Posterior parity of the port's device samplers (``tests/torch_parity.py``).

On the card (marked ``gpu`` and ``slow``): the three arms of the step
kernel -- K=1 one-hot, K=4 cold rung, K=1 roll -- each agree with the
independent numpy stretch sampler within the calibrated bands, and the
broken-move control ((d-1) -> (d+1)) fails them through its width.
``chip_smoke.py`` phase 25 runs the same check.

On the CPU: the harness's numpy sampler is the JAX test's, draw for draw;
running it in lockstep changes no chain; ``parity_stats`` is the JAX test's;
and the harness runs end to end on the kernels' plain versions at a tiny
size.
"""

import numpy as np
import pytest
import torch

import test_posterior_parity as jax_parity
import torch_parity as tp

D_TOY, W_TOY, STEPS_TOY = 3, 16, 20


def _toy_log_prob():
    """A fixed correlated Gaussian log-density; takes numpy or jax
    arrays and returns numpy."""
    a = np.random.default_rng(0).standard_normal((D_TOY, D_TOY))
    prec = np.linalg.inv(a @ a.T + np.eye(D_TOY))

    def log_prob(x):
        x = np.asarray(x)
        return -0.5 * np.einsum("ij,jk,ik->i", x, prec, x)

    return log_prob


@pytest.mark.parametrize("offset", [0, 2])
def test_numpy_sampler_is_the_jax_tests(offset):
    """Bit for bit the chain of ``tests/test_posterior_parity.py::
    numpy_stretch_sampler`` from the same generator state."""
    log_prob = _toy_log_prob()
    p0 = np.random.default_rng(1).standard_normal((W_TOY, D_TOY))
    ours = tp.numpy_stretch_sampler(log_prob, p0, STEPS_TOY,
                                    np.random.default_rng(7),
                                    z_exponent_offset=offset)
    theirs = jax_parity.numpy_stretch_sampler(log_prob, p0, STEPS_TOY,
                                              np.random.default_rng(7),
                                              z_exponent_offset=offset)
    assert ours.shape == (STEPS_TOY, W_TOY, D_TOY)
    np.testing.assert_array_equal(ours, theirs)


def test_lockstep_changes_no_chain():
    """Replicates driven together (one likelihood call for all) give the
    chains each gives alone; ``thin`` keeps every thin-th of them."""
    log_prob = _toy_log_prob()
    starts = [np.random.default_rng(r).standard_normal((W_TOY, D_TOY))
              for r in range(3)]
    alone = [tp.numpy_stretch_sampler(log_prob, p0, STEPS_TOY,
                                      np.random.default_rng(50 + r),
                                      z_exponent_offset=2 * (r == 2))
             for r, p0 in enumerate(starts)]
    together = tp.run_lockstep(log_prob, [
        tp.stretch_moves(p0, STEPS_TOY, np.random.default_rng(50 + r),
                         z_exponent_offset=2 * (r == 2), thin=4)
        for r, p0 in enumerate(starts)])
    for a, b in zip(alone, together):
        np.testing.assert_array_equal(a[3::4], b)


def test_parity_stats_is_the_jax_tests():
    rng = np.random.default_rng(3)
    ma, mb = rng.standard_normal((2, 3, 13))
    sa, sb = rng.uniform(0.5, 2.0, (2, 3, 13))
    assert tp.parity_stats(ma, sa, mb, sb) == jax_parity._parity_stats(
        ma, sa, mb, sb)


TINY = tp.Schedule(w=32, burn=10, steps=10, k_ref=2, k_dev=2, k_ctrl=1)


@pytest.fixture(scope="module")
def tiny_referee(tmp_path_factory):
    """The harness on the CPU (the kernels' plain versions) at a tiny
    size: a small synthetic dataset, W=32, 10 + 10 steps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sess, consts, theta_c = tp.session(
            tmp_path_factory.mktemp("referee"), "cpu", n_annuli=6, n_sz=6,
            max_radius_arcsec=30.0, extent_kpc=800.0)
        out = tp.run_referee(consts, theta_c, second_reference=True,
                             sched=TINY)
    finally:
        torch.set_num_threads(n)
    return sess, consts, theta_c, out


@pytest.mark.parametrize("tag", ["np", "np2", "ctrl"] + list(tp.ARMS))
def test_harness_runs_on_the_cpu(tiny_referee, tag):
    _, _, theta_c, out = tiny_referee
    k = {"np": TINY.k_ref, "np2": TINY.k_ref, "ctrl": TINY.k_ctrl}.get(
        tag, TINY.k_dev)
    for key in ("medians", "widths"):
        v = out[tag][key]
        assert v.shape == (k, theta_c.size) and np.all(np.isfinite(v))
    assert np.all(out[tag]["widths"] > 0)
    dmed, dwidth = tp.stats(out, tag, "np")
    assert np.isfinite(dmed) and np.isfinite(dwidth)


def test_k4_arm_is_the_cold_rung(tiny_referee):
    """The k4 arm's chain is rung 0 of ``run_tempered_kernel`` on the
    default 4-rung ladder: its last frame is the cold rung's final
    state."""
    from joxsz_torch.sampling.kernel import KernelSampler, run_tempered_kernel
    from joxsz_torch.sampling.tempered import default_betas

    _, consts, theta_c, _ = tiny_referee
    p0 = tp.init(theta_c, np.random.default_rng(5), TINY.w)
    chain = tp.arm_chain("k4", consts, p0, np.random.default_rng(1),
                         np.random.default_rng(2), TINY)
    sampler = KernelSampler(consts, partner="onehot")
    betas = default_betas(tp.N_RUNGS)
    res = run_tempered_kernel(sampler, torch.tensor(p0, dtype=torch.float32),
                              betas, TINY.burn, np.random.default_rng(1),
                              store_chain=False)
    assert res.chain.shape[0] == 0
    res = run_tempered_kernel(sampler, res.final_state[0], betas,
                              TINY.steps, np.random.default_rng(2))
    assert chain.shape == (TINY.steps, TINY.w, theta_c.size)
    np.testing.assert_array_equal(chain, res.chain)
    np.testing.assert_array_equal(chain[-1],
                                  res.final_state[0][0].numpy())


@pytest.fixture(scope="module")
def card_referee(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    _, consts, theta_c = tp.session(tmp_path_factory.mktemp("card"), "cuda")
    return tp.run_referee(consts, theta_c)


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("arm", tp.ARMS)
def test_arm_agrees_with_the_referee_on_the_card(card_referee, arm):
    dmed, dwidth = tp.stats(card_referee, arm, "np")
    assert dmed < tp.MED_BAND, f"{arm}: median disagreement {dmed:.3f}"
    assert dwidth < tp.WIDTH_BAND, f"{arm}: width disagreement {dwidth:.3f}"


@pytest.mark.gpu
@pytest.mark.slow
def test_broken_move_fails_the_referee_on_the_card(card_referee):
    dmed, dwidth = tp.stats(card_referee, "ctrl", "k1")
    assert not (dmed < tp.MED_BAND and dwidth < tp.WIDTH_BAND)
    assert dwidth >= tp.WIDTH_BAND, f"control width {dwidth:.3f}"
