"""Port parity: the stretch and swap steps against the Pallas step kernels.

The CUDA kernels draw Philox bits; the Pallas kernels in interpret mode
draw from an integer hash (``pallas_joint.py::_make_random_bits``).  The
port's plain step takes its bits from a callable, so here it is fed a
copy of that hash and must then follow ``make_step_kernel`` (K = 1) and
``make_tempered_step_kernel`` (K = 2) step for step: positions to 1e-5,
accept counts and swap counts equal, log-probs to the joint kernel's
tolerance.  The Philox generator itself is pinned to the published
known-answer vectors of Philox-4x32-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import (philox4x32_10, philox_stream,
                                         stretch_half, swap,
                                         tempered_step_plain)
from joxsz_torch.sampling.kernel import (KernelSampler, chain_chunk_schedule,
                                         run_tempered_kernel)
from joxsz_torch.sampling.stretch import uniforms
from joxsz_torch.sampling.tempered import rotation_shift
from joxsz_tpu.ops.pallas_joint import (make_joint_core, make_step_kernel,
                                        make_tempered_step_kernel)

from test_torch_build import jax_session, small_config, truth_rows

W, STEPS, SEED = 16, 4, 5
RTOL, ATOL = 2e-4, 0.5


def hash_stream(seed: int):
    """The interpret-mode bit source of the Pallas step kernels
    (``_make_random_bits``), as ``bits(step, which, n_rows, n_words)``."""
    def bits(step, which, n_rows, n_words):
        idx = (np.arange(n_rows, dtype=np.uint32)[:, None]
               * np.uint32(n_words)
               + np.arange(n_words, dtype=np.uint32)[None, :])
        # the scalar part of the sum, wrapped to uint32 as the kernel's is
        off = (seed * 2654435761 + step * 40503 + which * 10007) % 2 ** 32
        v = idx + np.uint32(off)
        v = v ^ (v >> np.uint32(15))
        v = v * np.uint32(2246822519)
        v = v ^ (v >> np.uint32(13))
        v = v * np.uint32(3266489917)
        v = v ^ (v >> np.uint32(16))
        return torch.from_numpy(v.astype(np.int64))

    return bits


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_step"))
    sess = build_session(cfg, device="cpu")
    return sess, pack_consts(sess), jax_session(cfg, "float32")


def _start(sess, js32, K: int):
    rows = truth_rows(sess.params, K * W, seed=21, spread=0.02)
    x0 = rows.astype(np.float32).reshape(K, W, -1)
    core = make_joint_core(js32, block_b=8, interpret=True)
    lp0 = np.asarray(core(jnp.asarray(x0.reshape(K * W, -1)))).reshape(K, W)
    assert np.all(np.isfinite(lp0))
    return x0, lp0


def _port_steps(c, x0, lp0, betas, n_steps):
    """The port's plain tempered step on the hash stream; returns the
    cold rung after each step, final state, and swap counts."""
    K = len(betas)
    x = torch.tensor(x0)
    lp = torch.tensor(lp0)
    acc = torch.zeros(lp.shape)
    beta = torch.tensor(betas, dtype=torch.float32)
    db = [float(np.float32(betas[k] - betas[k + 1])) for k in range(K - 1)]
    frames, frames_lp, sacc = [], [], np.zeros(max(K - 1, 1))
    for step in range(n_steps):
        x, lp, acc, swaps = tempered_step_plain(
            x, lp, acc, beta, SEED, step, hash_stream(SEED),
            lambda th: joint_ll_plain(th, c), db)
        sacc[:K - 1] += swaps
        frames.append(x[0].numpy())
        frames_lp.append(lp[0].numpy())
    return np.stack(frames), np.stack(frames_lp), x, lp, acc, sacc[:K - 1]


def test_plain_step_matches_interpret_kernel(sessions):
    sess, c, js32 = sessions
    x0, lp0 = _start(sess, js32, 1)
    step = make_step_kernel(js32, n_inner=STEPS, n_walkers=W,
                            interpret=True, thin=1, partner="onehot")
    xk, lpk, acck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0[0]), jnp.asarray(lp0[0]), jnp.zeros(W), SEED))
    frames, frames_lp, x, lp, acc, _ = _port_steps(c, x0, lp0, [1.0], STEPS)
    assert chain.shape == frames.shape == (STEPS, W, x0.shape[-1])
    np.testing.assert_allclose(frames, chain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(frames_lp, chain_lp, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(acc[0].numpy(), acck)
    assert 0 < acck.sum() < STEPS * W
    np.testing.assert_allclose(x[0].numpy(), xk, rtol=1e-5, atol=0)


def test_tempered_step_matches_interpret_kernel(sessions):
    sess, c, js32 = sessions
    betas = [1.0, 0.6]
    x0, lp0 = _start(sess, js32, 2)
    step = make_tempered_step_kernel(js32, betas, n_inner=STEPS,
                                     n_walkers=W, interpret=True, thin=1,
                                     partner="onehot")
    xk, lpk, acck, sacck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.zeros((2, W)), SEED))
    frames, frames_lp, x, lp, acc, sacc = _port_steps(c, x0, lp0, betas,
                                                      STEPS)
    np.testing.assert_allclose(frames, chain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(frames_lp, chain_lp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.numpy(), xk, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lp.numpy(), lpk, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(acc.numpy(), acck)
    np.testing.assert_array_equal(sacc, sacck)
    assert sacck.sum() > 0


# Philox-4x32-10 known-answer vectors (Salmon et al. 2011, Random123
# kat_vectors): counter, key -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    out = philox4x32_10(*[torch.tensor([v], dtype=torch.int64)
                          for v in counter], *key)
    assert tuple(int(o) for o in out) == want


def test_philox_stream_counters():
    """Row r of ``bits(step, which, ...)`` is Philox at counter
    (r, step, which, 0) under key (seed, 0)."""
    seed, step, which = 123456789, 77, 17
    got = philox_stream(seed, "cpu")(step, which, 9, 4)
    for r in (0, 4, 8):
        one = philox4x32_10(*[torch.tensor([v]) for v in
                              (r, step, which, 0)], seed, 0)
        assert [int(o) for o in one] == got[r].tolist()
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


def test_uniforms_use_the_top_24_bits():
    bits = torch.tensor([0, 0xFF, 0x100, 0x80000000, 0xFFFFFFFF])
    u = uniforms(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24]


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1, 987654321])
def test_rotation_shift_is_the_kernel_expression(seed):
    """The swap pairing's shift against the literal JAX int32 expression
    (wrapping multiply, arithmetic >> 8, floor-mod)."""
    H = 24
    for i in (0, 1, 999, 40000):
        for kk in (0, 2):
            want = int(jnp.remainder(
                (jnp.int32(seed) * 1103515245 + jnp.int32(i) * 40503
                 + kk * 10007) >> 8, H))
            assert rotation_shift(seed, i, kk, H) == want


def test_cpu_wrappers_update_in_place_without_launches(sessions):
    sess, c, js32 = sessions
    x0, _ = _start(sess, js32, 2)
    lp0 = joint_ll_plain(torch.tensor(x0).reshape(2 * W, -1), c).reshape(
        2, W).numpy()
    x, lp = torch.tensor(x0), torch.tensor(lp0)
    acc = torch.zeros_like(lp)
    beta = torch.tensor([1.0, 0.6])
    sacc = torch.zeros(1, dtype=torch.int32)
    n_half, n_swap = stretch_half.launches, swap.launches
    stretch_half(x, lp, acc, beta, 0, SEED, 0, c)
    stretch_half(x, lp, acc, beta, 1, SEED, 0, c)
    swap(x, lp, sacc, 0, SEED, 0, float(np.float32(0.4)))
    assert (stretch_half.launches, swap.launches) == (n_half, n_swap)
    want = tempered_step_plain(
        torch.tensor(x0), torch.tensor(lp0), torch.zeros_like(lp), beta,
        SEED, 0, philox_stream(SEED, "cpu"),
        lambda th: joint_ll_plain(th, c), [float(np.float32(0.4))])
    assert torch.equal(x, want[0]) and torch.equal(lp, want[1])
    assert torch.equal(acc, want[2]) and int(sacc[0]) == want[3][0]
    fresh = joint_ll_plain(x.reshape(2 * W, -1), c).reshape(2, W)
    assert torch.equal(fresh, lp)


def test_chain_chunk_schedule():
    assert chain_chunk_schedule(250, 25) == [100, 100, 50]
    assert chain_chunk_schedule(75, 25) == [75]
    assert sum(chain_chunk_schedule(8000, 25)) == 8000
    with pytest.raises(ValueError):
        chain_chunk_schedule(30, 25)


def test_kernel_sampler_on_cpu(sessions):
    """The sampler loop on the plain versions: chain shapes, thinning,
    stored log-probs equal to fresh evaluations."""
    sess, c, _ = sessions
    sampler = KernelSampler(c)
    rng = np.random.default_rng(0)
    p0 = torch.tensor(truth_rows(sess.params, W, seed=3, spread=0.02),
                      dtype=torch.float32)
    res = sampler.run(p0, 10, rng, thin=5)
    assert res.chain.shape == (2, W, 13) and res.log_prob.shape == (2, W)
    x, lp = res.final_state
    assert torch.equal(joint_ll_plain(x, c), lp)
    np.testing.assert_array_equal(res.chain[-1], x.numpy())
    t = run_tempered_kernel(sampler, x, [1.0, 0.6], 10, rng, thin=5)
    assert t.chain.shape == (2, W, 13)
    assert t.acceptance_fraction.shape == (2, W)
    assert t.swap_acceptance.shape == (1,)
    assert 0 < float(t.swap_acceptance[0]) <= 1
