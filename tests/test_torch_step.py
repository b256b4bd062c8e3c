"""Port parity: the step kernel's plain path against the Pallas step kernels.

The CUDA step kernel draws Philox bits; the Pallas kernels in interpret
mode draw from an integer hash (``pallas_joint.py::_make_random_bits``).
The plain version of one launch (``steps_plain``) takes its bits from a
callable, so here it is fed a copy of that hash and must then follow
``make_step_kernel`` (K = 1) and ``make_tempered_step_kernel`` (K = 2)
under both partner laws (one-hot, and the hashed roll)
over a whole chunk of n_inner = 4 steps at thin 1 and 2: frames shaped
(n_inner // thin, W, D) as the JAX chains are, positions to 1e-5, accept
counts and swap counts equal, log-probs to the joint kernel's tolerance.
The Philox generator itself is pinned to the published known-answer
vectors of Philox-4x32-10, and the wrapper's argument checks and its
CPU path (in place, no launch, one call == one call per step) are held
here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import (philox4x32_10, philox_stream,
                                         steps_plain, stretch_steps,
                                         tempered_step_plain)
from joxsz_torch.sampling.kernel import (KernelSampler, chain_chunk_schedule,
                                         run_tempered_kernel, rung_tensors)
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


def _port_steps(c, x0, lp0, betas, n_steps, thin, partner="onehot"):
    """The plain path of one step-kernel launch on the hash stream;
    returns its frames, final state and swap counts."""
    beta, db = rung_tensors(betas, "cpu")
    x, lp, acc, swaps, chain, chain_lp = steps_plain(
        torch.tensor(x0), torch.tensor(lp0), torch.zeros(lp0.shape), beta,
        db.tolist(), SEED, n_steps, hash_stream(SEED),
        lambda th: joint_ll_plain(th, c), thin, partner=partner)
    return chain.numpy(), chain_lp.numpy(), x, lp, acc, np.array(swaps)


# (thin, partner law): the one-hot cases keep their ids
LAWS = [pytest.param(t, law, id=str(t) + ("" if law == "onehot" else
                                           f"-{law}"))
        for law in ("onehot", "roll") for t in (1, 2)]


@pytest.mark.parametrize("thin,partner", LAWS)
def test_plain_step_matches_interpret_kernel(sessions, thin, partner):
    sess, c, js32 = sessions
    x0, lp0 = _start(sess, js32, 1)
    step = make_step_kernel(js32, n_inner=STEPS, n_walkers=W,
                            interpret=True, thin=thin, partner=partner)
    xk, lpk, acck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0[0]), jnp.asarray(lp0[0]), jnp.zeros(W), SEED))
    frames, frames_lp, x, lp, acc, _ = _port_steps(c, x0, lp0, [1.0], STEPS,
                                                   thin, partner)
    assert chain.shape == frames.shape == (STEPS // thin, W, x0.shape[-1])
    np.testing.assert_allclose(frames, chain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(frames_lp, chain_lp, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(acc[0].numpy(), acck)
    assert 0 < acck.sum() < STEPS * W
    np.testing.assert_allclose(x[0].numpy(), xk, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lp[0].numpy(), lpk, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("thin,partner", LAWS)
def test_tempered_step_matches_interpret_kernel(sessions, thin, partner):
    sess, c, js32 = sessions
    betas = [1.0, 0.6]
    x0, lp0 = _start(sess, js32, 2)
    step = make_tempered_step_kernel(js32, betas, n_inner=STEPS,
                                     n_walkers=W, interpret=True, thin=thin,
                                     partner=partner)
    xk, lpk, acck, sacck, chain, chain_lp = (np.asarray(v) for v in step(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.zeros((2, W)), SEED))
    frames, frames_lp, x, lp, acc, sacc = _port_steps(c, x0, lp0, betas,
                                                      STEPS, thin, partner)
    assert chain.shape == frames.shape == (STEPS // thin, W, x0.shape[-1])
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


def _state(sess, c, K):
    x = torch.tensor(truth_rows(sess.params, K * W, seed=4, spread=0.02),
                     dtype=torch.float32).reshape(K, W, -1).contiguous()
    lp = joint_ll_plain(x.reshape(K * W, -1), c).reshape(K, W)
    return x, lp, torch.zeros_like(lp)


def test_cpu_wrappers_update_in_place_without_launches(sessions):
    """On CPU tensors ``stretch_steps`` runs its plain version on the
    Philox bits, in place, and counts no launch."""
    sess, c, _ = sessions
    x0, lp0, acc0 = _state(sess, c, 2)
    x, lp, acc = x0.clone(), lp0.clone(), acc0.clone()
    beta, db = rung_tensors([1.0, 0.6], "cpu")
    sacc = torch.zeros(1, dtype=torch.int32)
    n0 = (stretch_steps.launches, stretch_steps.launches_tempered)
    chain, chain_lp = stretch_steps(x, lp, acc, sacc, beta, db, SEED, 4, c,
                                    thin=2)
    assert (stretch_steps.launches, stretch_steps.launches_tempered) == n0
    want = steps_plain(x0, lp0, acc0, beta, db.tolist(), SEED, 4,
                       philox_stream(SEED, "cpu"),
                       lambda th: joint_ll_plain(th, c), 2)
    assert torch.equal(x, want[0]) and torch.equal(lp, want[1])
    assert torch.equal(acc, want[2]) and int(sacc[0]) == want[3][0]
    assert torch.equal(chain, want[4]) and torch.equal(chain_lp, want[5])
    assert chain.shape == (2, W, 13) and torch.equal(chain[-1], x[0])
    fresh = joint_ll_plain(x.reshape(2 * W, -1), c).reshape(2, W)
    assert torch.equal(fresh, lp)


@pytest.mark.parametrize("K", [1, 2])
def test_chunk_equals_one_call_per_step(sessions, K):
    """Steps are numbered within the chunk: one call of n steps equals n
    calls of one step at step0 = 0 .. n-1 (the per-step entry the card's
    identity checks use), frames included."""
    sess, c, _ = sessions
    x0, lp0, acc0 = _state(sess, c, K)
    beta, db = rung_tensors([1.0, 0.6][:K], "cpu")
    sa, sb = (torch.zeros(1, dtype=torch.int32) for _ in range(2))
    xa, la, aa = x0.clone(), lp0.clone(), acc0.clone()
    chain, chain_lp = stretch_steps(xa, la, aa, sa, beta, db, SEED, 3, c,
                                    thin=1)
    xb, lb, ab = x0.clone(), lp0.clone(), acc0.clone()
    for i in range(3):
        stretch_steps(xb, lb, ab, sb, beta, db, SEED, 1, c, step0=i)
        assert torch.equal(chain[i], xb[0])
        assert torch.equal(chain_lp[i], lb[0])
    assert torch.equal(xa, xb) and torch.equal(la, lb)
    assert torch.equal(aa, ab) and torch.equal(sa, sb)
    assert float(aa.sum()) > 0


def _bad_calls():
    return {
        "odd W": dict(shape=(2, W - 1)),
        "thin": dict(n_steps=5, thin=2),
        "dtype": dict(dtype=torch.float64),
        "device": dict(device="meta"),
        "betas": dict(betas=[1.0, 0.6, 0.36]),
        "sacc": dict(sacc_dtype=torch.int64),
    }


@pytest.mark.parametrize("what", sorted(_bad_calls()))
def test_stretch_steps_argument_checks(sessions, what):
    sess, c, _ = sessions
    kw = _bad_calls()[what]
    K, w = kw.get("shape", (2, W))
    x = torch.zeros((K, w, 13), dtype=kw.get("dtype", torch.float32),
                    device=kw.get("device", "cpu"))
    lp = torch.zeros((K, w), dtype=x.dtype, device=x.device)
    beta, db = rung_tensors(kw.get("betas", [1.0, 0.6]), "cpu")
    sacc = torch.zeros(1, dtype=kw.get("sacc_dtype", torch.int32))
    n0 = stretch_steps.launches
    with pytest.raises(ValueError):
        stretch_steps(x, lp, lp.clone(), sacc, beta, db, SEED,
                      kw.get("n_steps", 4), c, thin=kw.get("thin", 2))
    assert stretch_steps.launches == n0


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
