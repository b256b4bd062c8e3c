"""Port parity: the coupled half-step against ``make_coupled_half_kernel``.

The CUDA kernel draws Philox bits; the Pallas kernel in interpret mode
draws the whole (H, 4) block of its integer hash for (seed, step, half)
and keeps the shard's rows (``pallas_joint.py:1738-1752``).  The port's
plain version takes the whole half's bits from a callable, so here it is
fed that hash and must follow the interpret-mode kernel step for step at
1, 2 and 4 shards: positions to 1e-5, accept counts equal, log-probs to
the joint kernel's tolerance (rtol 2e-4, atol 0.5: float32 roundoff of
~1e4-magnitude sums in two arithmetic orders).  On Philox bits the CPU
wrapper must be, bit for bit, the K = 1 half-step of ``ops.step_kernel``
on the whole ensemble, whatever the number of shards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.coupled_kernel import coupled_half, coupled_half_plain
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import stretch_steps
from joxsz_torch.sampling.kernel import rung_tensors
from joxsz_tpu.ops.pallas_joint import (make_coupled_half_kernel,
                                        make_joint_core)

from test_torch_build import jax_session, small_config, truth_rows
from test_torch_step import hash_stream

W, STEPS, SEED = 32, 3, 5
H = W // 2
RTOL, ATOL = 2e-4, 0.5


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_coupled"))
    sess = build_session(cfg, device="cpu")
    js32 = jax_session(cfg, "float32")
    x0 = truth_rows(sess.params, W, seed=21, spread=0.02).astype(np.float32)
    core = make_joint_core(js32, block_b=8, interpret=True)
    lp0 = np.asarray(core(jnp.asarray(x0)))
    assert np.all(np.isfinite(lp0))
    return sess, pack_consts(sess), js32, x0, lp0


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plain_half_matches_interpret_kernel(sessions, n_shards):
    sess, c, js32, x0, lp0 = sessions
    half = make_coupled_half_kernel(js32, W, n_shards, interpret=True)
    D, Dp, H_loc = half.D, half.Dp, half.H_loc
    assert (half.H, H_loc) == (H, H // n_shards)
    # JAX: packed halves (lp in lane Dp-2, accept count in lane Dp-1)
    packed = np.zeros((W, Dp), np.float32)
    packed[:, :D], packed[:, Dp - 2] = x0, lp0
    jh = [packed[:H], packed[H:]]
    # port: unpacked halves
    ph = [[torch.tensor(x0[h * H:(h + 1) * H]),
           torch.tensor(lp0[h * H:(h + 1) * H]), torch.zeros(H)]
          for h in (0, 1)]
    bits = hash_stream(SEED)
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    for step in range(STEPS):
        for which in (0, 1):
            fixed_j = jnp.asarray(jh[1 - which])
            jh[which] = np.concatenate([np.asarray(half(
                jnp.asarray(jh[which][s * H_loc:(s + 1) * H_loc]), fixed_j,
                SEED, step, which, s * H_loc)) for s in range(n_shards)])
            b = bits(step, which, H, 4)
            xm, lm, am = ph[which]
            out = [coupled_half_plain(
                xm[s * H_loc:(s + 1) * H_loc], lm[s * H_loc:(s + 1) * H_loc],
                am[s * H_loc:(s + 1) * H_loc], ph[1 - which][0], s * H_loc,
                b, lp_fn) for s in range(n_shards)]
            ph[which] = [torch.cat([o[k] for o in out]) for k in range(3)]
            np.testing.assert_allclose(ph[which][0].numpy(),
                                       jh[which][:, :D], rtol=1e-5, atol=0)
            np.testing.assert_allclose(ph[which][1].numpy(),
                                       jh[which][:, Dp - 2], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_array_equal(ph[which][2].numpy(),
                                          jh[which][:, Dp - 1])
    n_acc = sum(float(h[2].sum()) for h in ph)
    assert 0 < n_acc < STEPS * W


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_cpu_wrapper_is_the_k1_half_step(sessions, n_shards):
    """Any split of the moving half gives the bits of the step kernel's
    plain path (``stretch_steps``) at K = 1 on the whole ensemble (same
    seed, same step) after every full step, without a launch; stored lp
    equals a fresh evaluation."""
    sess, c, _, x0, _ = sessions
    x = torch.tensor(x0)[None].clone()
    lp = joint_ll_plain(x[0], c)[None]
    acc = torch.zeros_like(lp)
    beta, db = rung_tensors([1.0], "cpu")
    sacc = torch.zeros(1, dtype=torch.int32)
    xa, la, aa = x[0, :H].clone(), lp[0, :H].clone(), acc[0, :H].clone()
    xb, lb, ab = x[0, H:].clone(), lp[0, H:].clone(), acc[0, H:].clone()
    H_loc = H // n_shards
    n0 = coupled_half.launches

    def blocks(t):
        return [t[s * H_loc:(s + 1) * H_loc].clone() for s in range(n_shards)]

    for step in range(2):
        for which, (xm, lm, am), fixed in ((0, (xa, la, aa), xb),
                                           (1, (xb, lb, ab), xa)):
            parts = [blocks(t) for t in (xm, lm, am)]
            for s in range(n_shards):
                coupled_half(parts[0][s], parts[1][s], parts[2][s], fixed,
                             which, SEED, step, s * H_loc, c)
            for t, p in zip((xm, lm, am), parts):
                t.copy_(torch.cat(p))
        stretch_steps(x, lp, acc, sacc, beta, db, SEED, 1, c, step0=step)
        assert torch.equal(torch.cat([xa, xb]), x[0])
        assert torch.equal(torch.cat([la, lb]), lp[0])
        assert torch.equal(torch.cat([aa, ab]), acc[0])
    assert coupled_half.launches == n0
    assert float(acc.sum()) > 0
    assert torch.equal(joint_ll_plain(x[0], c), lp[0])


def test_wrong_row_offset_changes_the_result(sessions):
    """The draws are addressed by the row's place in the whole half."""
    sess, c, _, x0, lp0 = sessions
    fixed = torch.tensor(x0[H:])
    outs = []
    for off in (0, 4):
        xm = torch.tensor(x0[:4])
        lm, am = torch.tensor(lp0[:4]), torch.zeros(4)
        for step in range(4):
            coupled_half(xm, lm, am, fixed, 0, SEED, step, off, c)
        outs.append((xm, am))
    assert not torch.equal(outs[0][0], outs[1][0])


def test_coupled_half_argument_checks(sessions):
    sess, c, _, x0, lp0 = sessions
    xm, lm, am = torch.tensor(x0[:4]), torch.tensor(lp0[:4]), torch.zeros(4)
    fixed = torch.tensor(x0[H:])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        coupled_half(xm, lm, am, fixed, 0, SEED, 0, 0, c, partner="roll")
    with pytest.raises(ValueError, match="partner"):
        coupled_half(xm, lm, am, fixed, 0, SEED, 0, 0, c, partner="other")
    with pytest.raises(ValueError, match="outside"):
        coupled_half(xm, lm, am, fixed, 0, SEED, 0, H - 2, c)
    with pytest.raises(ValueError, match="float32"):
        coupled_half(xm.double(), lm, am, fixed, 0, SEED, 0, 0, c)
    with pytest.raises(ValueError, match="H_loc"):
        coupled_half(xm, lm[:3], am, fixed, 0, SEED, 0, 0, c)
    with pytest.raises(ValueError, match="rows"):
        coupled_half(xm[:, :5].contiguous(), lm, am, fixed, 0, SEED, 0, 0, c)


@pytest.mark.gpu
def test_coupled_kernel_is_the_k1_kernel_on_the_card(sessions, tmp_path):
    """On the card: kernel 6 over 1, 2 and 4 shards equals the step
    kernel at K = 1 bit for bit after a full step (a full-width repeat is
    in ``chip_smoke.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sess, _, _, x0, _ = sessions
    from joxsz_torch.ops.joint_kernel import joint_ll

    c = pack_consts(sess, device="cuda")
    x = torch.tensor(x0, device="cuda")[None].contiguous()
    lp = joint_ll(x[0], c)[None]
    acc = torch.zeros_like(lp)
    beta, db = rung_tensors([1.0], "cuda")
    sacc = torch.zeros(1, dtype=torch.int32, device="cuda")
    xr, lr, ar = x.clone(), lp.clone(), acc.clone()
    stretch_steps(xr, lr, ar, sacc, beta, db, SEED, 1, c)
    for n_shards in (1, 2, 4):
        H_loc = H // n_shards
        halves = [[t[0, h * H:(h + 1) * H].clone() for t in (x, lp, acc)]
                  for h in (0, 1)]
        for which in (0, 1):
            fixed = halves[1 - which][0].clone()
            for s in range(n_shards):
                sl = slice(s * H_loc, (s + 1) * H_loc)
                xm, lm, am = (t[sl].clone() for t in halves[which])
                coupled_half(xm, lm, am, fixed, which, SEED, 0, s * H_loc, c)
                for t, v in zip(halves[which], (xm, lm, am)):
                    t[sl] = v
        for k, ref in enumerate((xr, lr, ar)):
            assert torch.equal(torch.cat([h[k] for h in halves]), ref[0])
