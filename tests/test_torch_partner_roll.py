"""Port parity: the hashed-roll partner law of the step kernels.

Above 4096 walkers (per rung) the JAX package's step kernels pair moving
row i with fixed row (i - s) mod H, one hashed shift s per half-step
(``pallas_joint.py::_hash_shift`` with ``jnp.roll``); kernel 6 takes the
same law at its rows' global places.  Held here on the CPU:

* ``sampling.tempered.hash_shift`` equals ``_hash_shift`` exactly over a
  grid of seeds (0, 2^31 - 1, seeds whose products wrap negative), steps
  0-199, both halves, rungs 0-3 and four half sizes; the partner rows are
  ``jnp.roll``'s;
* the mechanics of the JAX roll tests (``tests/test_pallas_joint.py``):
  stored lp equal to a fresh evaluation, walkers that move, counters in
  range, at K = 1 and K = 3;
* ``partner="auto"`` takes one-hot at 4096 walkers per rung and roll at
  4098, as ``make_step_kernel`` and ``make_tempered_step_kernel`` do;
* kernel 6's plain version under roll over 1, 2 and 4 shards is, bit for
  bit, the K = 1 roll step.

The plain step against the JAX interpret-mode kernels under both laws is
``tests/test_torch_step.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops import step_kernel
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import (PARTNER_AUTO_THRESHOLD,
                                         resolve_partner, stretch_steps)
from joxsz_torch.parallel import make_mesh
from joxsz_torch.parallel.kernel_sharded import run_coupled_sharded_ensemble
from joxsz_torch.sampling.kernel import KernelSampler, rung_tensors
from joxsz_torch.sampling.stretch import roll_partners
from joxsz_torch.sampling.tempered import hash_shift
from joxsz_tpu.ops.pallas_joint import _PARTNER_AUTO_THRESHOLD, _hash_shift

from test_torch_build import (single_thread, small_config,  # noqa: F401
                              truth_rows)

# 0, the int32 extremes, and seeds whose product with 1103515245 wraps
SEEDS = [0, 1, 5, 3141592, 987654321, 2 ** 31 - 1]
STEPS = np.arange(200, dtype=np.int32)


@pytest.mark.parametrize("H", [8, 2048, 4097, 32768])
def test_hash_shift_is_the_jax_expression(H):
    assert any(np.int64(s) * 1103515245 % 2 ** 32 >= 2 ** 31 for s in SEEDS)
    for seed in SEEDS:
        for which in (0, 1):
            for extra in (None, 0, 1, 2, 3):
                want = np.asarray(_hash_shift(jnp.int32(seed),
                                              jnp.asarray(STEPS), which, H,
                                              extra))
                got = [hash_shift(seed, int(i), which, H, extra or 0)
                       for i in STEPS]
                assert got == want.tolist(), (seed, which, extra)
                assert 0 <= min(got) and max(got) < H


@pytest.mark.parametrize("H,row_off,n", [(8, 0, 8), (24, 0, 24),
                                         (24, 6, 6), (24, 18, 6)])
def test_roll_partners_are_jnp_roll(H, row_off, n):
    """Moving row i pairs with fixed row (i - s) mod H: the rows
    ``jnp.roll(x_fixed, s)`` puts in place i, also for a block of rows."""
    x = np.random.default_rng(H + row_off).standard_normal((H, 3))
    for s in (0, 1, 5, H - 1):
        rolled = np.asarray(jnp.roll(jnp.asarray(x), s, axis=0))
        idx = roll_partners([s], n, H, row_off)[0]
        np.testing.assert_array_equal(x[idx.numpy()],
                                      rolled[row_off:row_off + n])


@pytest.fixture(scope="module")
def consts(tmp_path_factory, single_thread):
    cfg = small_config(tmp_path_factory.mktemp("torch_roll"))
    sess = build_session(cfg, device="cpu")
    return sess, pack_consts(sess)


def _state(sess, c, K, W, seed):
    x = torch.tensor(truth_rows(sess.params, K * W, seed=seed, spread=0.02),
                     dtype=torch.float32).reshape(K, W, -1).contiguous()
    lp = joint_ll_plain(x.reshape(K * W, -1), c).reshape(K, W)
    return x, lp, torch.zeros_like(lp)


def test_step_kernel_roll_mechanics(consts):
    """As ``test_step_kernel_roll_partner_mechanics``: W=16, 8 steps."""
    sess, c = consts
    x, lp, acc = _state(sess, c, 1, 16, seed=4)
    x0 = x.clone()
    beta, db = rung_tensors([1.0], "cpu")
    stretch_steps(x, lp, acc, torch.zeros(1, dtype=torch.int32), beta, db,
                  13, 8, c, partner="roll")
    assert torch.equal(joint_ll_plain(x[0], c), lp[0])
    assert float(acc.sum()) > 0 and float(acc.max()) <= 8
    assert not torch.equal(x, x0)


def test_tempered_kernel_roll_mechanics(consts):
    """As ``test_tempered_kernel_roll_partner_mechanics``: K=3, W=16, 6
    steps at thin 3: stored lp the untempered log-posterior on every
    rung, walkers move, swap counters in range."""
    sess, c = consts
    K, W = 3, 16
    x, lp, acc = _state(sess, c, K, W, seed=14)
    x0 = x.clone()
    beta, db = rung_tensors([1.0, 0.6, 0.36], "cpu")
    sacc = torch.zeros(K - 1, dtype=torch.int32)
    chain, chain_lp = stretch_steps(x, lp, acc, sacc, beta, db, 31, 6, c,
                                    thin=3, partner="roll")
    for k in range(K):
        assert torch.equal(joint_ll_plain(x[k], c), lp[k])
    assert chain.shape == (2, W, x.shape[-1])
    assert torch.equal(chain[-1], x[0]) and torch.equal(chain_lp[-1], lp[0])
    assert bool((x != x0).any()) and float(acc.mean()) > 0
    assert int(sacc.min()) >= 0 and int(sacc.max()) <= 6 * W


def test_roll_and_onehot_are_different_kernels(consts):
    """The same bits under the two laws give other chains (the roll law
    is not the one-hot one in disguise)."""
    sess, c = consts
    beta, db = rung_tensors([1.0], "cpu")
    out = {}
    for law in ("onehot", "roll"):
        x, lp, acc = _state(sess, c, 1, 16, seed=4)
        stretch_steps(x, lp, acc, torch.zeros(1, dtype=torch.int32), beta,
                      db, 13, 4, c, partner=law)
        out[law] = x
    assert not torch.equal(out["onehot"], out["roll"])


def test_auto_takes_roll_above_4096_walkers_per_rung(consts, monkeypatch):
    sess, c = consts
    assert PARTNER_AUTO_THRESHOLD == _PARTNER_AUTO_THRESHOLD == 4096
    assert resolve_partner("auto", 4096) == "onehot"
    assert resolve_partner("auto", 4098) == "roll"
    assert resolve_partner("onehot", 8192) == "onehot"
    assert resolve_partner("roll", 16) == "roll"
    with pytest.raises(ValueError, match="partner"):
        resolve_partner("other", 16)
    seen = []
    real = step_kernel.steps_plain

    def spy(*a, partner="onehot", **kw):
        seen.append(partner)
        return real(*a, partner=partner, **kw)

    monkeypatch.setattr(step_kernel, "steps_plain", spy)
    D = c.ints["D"]
    for K in (1, 2):
        beta, db = rung_tensors([1.0, 0.6][:K], "cpu")
        for W in (4096, 4098):
            x = torch.zeros((K, W, D))
            lp = torch.zeros((K, W))
            stretch_steps(x, lp, lp.clone(),
                          torch.zeros(1, dtype=torch.int32), beta, db, 1, 0,
                          c)
    assert seen == ["onehot", "roll", "onehot", "roll"]
    # the sampler hands its law to every launch
    seen.clear()
    sampler = KernelSampler(c, partner="roll")
    sampler.run(torch.tensor(truth_rows(sess.params, 16, seed=3,
                                        spread=0.02), dtype=torch.float32),
                2, np.random.default_rng(0))
    assert seen == ["roll"]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_coupled_roll_is_the_k1_roll_step(consts, n_shards):
    """Kernel 6's plain version under roll, its rows pairing with (row_off
    + i - s) mod H, over any number of shards: bit for bit the K = 1 roll
    step on the whole ensemble, step for step."""
    sess, c = consts
    W, n_steps, seed = 32, 4, 9
    x, lp, acc = _state(sess, c, 1, W, seed=6)
    beta, db = rung_tensors([1.0], "cpu")
    res = run_coupled_sharded_ensemble(
        c, x[0].clone(), n_steps, seed,
        make_mesh(n_shards, devices=["cpu"] * n_shards), partner="roll")
    chain, chain_lp = stretch_steps(x, lp, acc,
                                    torch.zeros(1, dtype=torch.int32), beta,
                                    db, seed, n_steps, c, thin=1,
                                    partner="roll")
    np.testing.assert_array_equal(res.chain, chain.numpy())
    np.testing.assert_array_equal(res.log_prob, chain_lp.numpy())
    np.testing.assert_array_equal(res.acceptance_fraction,
                                  (acc[0] / n_steps).numpy())
    assert res.acceptance_fraction.mean() > 0
