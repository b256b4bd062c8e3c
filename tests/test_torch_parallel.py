"""Port parity: mesh sampling (``joxsz_torch.parallel``) on CPU shards.

A mesh whose devices all are the CPU spans several shards in one process,
as the JAX tests span eight virtual CPU devices.  At a small size (the
small synthetic dataset, 16-56 walkers, a few steps):

* the coupled sampler over 1, 2 and 4 shards is, bit for bit, the
  single-device ``KernelSampler.run`` at the same seed; fed the
  interpret-mode hash bits in place of Philox it follows the JAX
  package's ``run_coupled_sharded_ensemble`` (``interpret=True``) frame
  for frame, and the hybrid follows ``run_hybrid_coupled_ensemble``:
  positions to 1e-5, acceptance equal, lp at rtol 2e-4 / atol 0.5
  (float32 roundoff of ~1e4-magnitude sums in two arithmetic orders);
* the tests of ``tests/test_parallel.py`` that need the CL J1226 files,
  here on synthetic data: the runners' argument checks, the hybrid's
  mechanics, the per-device walker guard, the sub-64 routing, per-shard
  ensembles equal to per-device runs (plain, tempered, cluster blocks),
  and ``run_fit(mesh=...)``;
* the plain mesh samplers against the single-device ones.

``run --mesh`` and ``survey --mesh`` end to end are in
``test_torch_mesh_cli.py``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops import coupled_kernel, step_kernel
from joxsz_torch.ops.joint_kernel import (joint_ll_plain, pack_consts,
                                          pack_consts_stack)
from joxsz_torch.ops.multicluster_kernel import multicluster_ll
from joxsz_torch.ops.step_kernel import stretch_steps
from joxsz_torch.parallel import (kernel_sharded, make_mesh, all_gather,
                                  gather, run_multi_cluster,
                                  run_sharded_ensemble, scatter)
from joxsz_torch.parallel.kernel_sharded import (
    make_sharded_multicluster_step, run_coupled_sharded_ensemble,
    run_hybrid_coupled_ensemble, run_sharded_kernel_ensembles,
    run_sharded_tempered_ensembles)
from joxsz_torch.sampling.batched import run_batched_ensembles
from joxsz_torch.sampling.driver import run_fit
from joxsz_torch.sampling.kernel import (KernelSampler, _seeds,
                                         min_walkers_per_device,
                                         rung_tensors,
                                         run_multicluster_steps)
from joxsz_torch.sampling.stretch import run_ensemble
from joxsz_torch.simulate import simulate_survey
from joxsz_torch.synth import config_json
from joxsz_tpu.parallel import make_mesh as jax_make_mesh
from joxsz_tpu.parallel import kernel_sharded as jax_kernel_sharded

from test_torch_build import jax_session, small_config, truth_rows
from test_torch_step import hash_stream

CPU = torch.device("cpu")
RTOL, ATOL = 2e-4, 0.5
D = 13


def cpu_mesh(n: int, axis: str = "walker"):
    return make_mesh(n, axis_names=(axis,), devices=[CPU] * n)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel")
    cfg = small_config(root / "data")
    sess = build_session(cfg, device="cpu")
    return dict(cfg=cfg, root=root, sess=sess, c=pack_consts(sess),
                path=config_json(cfg, root / "cfg.json"))


@pytest.fixture(scope="module")
def js32(base):
    return jax_session(base["cfg"], "float32")


def start(sess, W: int, seed: int = 21, K: int | None = None):
    rows = truth_rows(sess.params, W * (K or 1), seed=seed, spread=0.02)
    x = torch.tensor(rows, dtype=torch.float32)
    return x if K is None else x.reshape(K, W, D)


@pytest.fixture
def hash_bits(monkeypatch):
    """Feed the CPU wrappers the interpret-mode hash in place of Philox."""
    for mod in (step_kernel, coupled_kernel):
        monkeypatch.setattr(mod, "philox_stream",
                            lambda seed, device: hash_stream(seed))


# -- the mesh and its collectives -------------------------------------------

def test_make_mesh_shapes_and_device_count():
    m = cpu_mesh(4)
    assert m.shape == {"walker": 4} and m.axis_names == ("walker",)
    assert m.devices == [CPU] * 4 and m.axis_devices("walker") == [CPU] * 4
    m2 = make_mesh(8, axis_names=("cluster", "walker"), shape=(2, 4),
                   devices=[CPU] * 8)
    assert m2.shape == {"cluster": 2, "walker": 4}
    assert len(m2.sub("cluster", 1)) == 4
    assert len(m2.axis_devices("cluster")) == 2
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(8, axis_names=("cluster", "walker"), shape=(3, 2),
                  devices=[CPU] * 8)
    # the default devices are the visible cards: none here
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="4 devices requested but only "
                           "0 available"):
            make_mesh(4)


def test_collectives_cut_and_join():
    t = torch.arange(24.0).reshape(2, 6, 2)
    blocks = scatter(t, [CPU] * 3, dim=1)
    assert [tuple(b.shape) for b in blocks] == [(2, 2, 2)] * 3
    assert all(b.is_contiguous() for b in blocks)
    blocks[0][0, 0, 0] = -1.0                  # a copy, not a view
    assert t[0, 0, 0] == 0.0
    blocks[0][0, 0, 0] = 0.0
    assert torch.equal(gather(blocks, CPU, dim=1), t)
    full = all_gather(blocks, dim=1)
    assert len(full) == 3 and all(torch.equal(f, t) for f in full)
    with pytest.raises(ValueError, match="does not divide"):
        scatter(t, [CPU] * 4, dim=1)


def test_constants_placement(base):
    c = base["c"]
    assert c.to("cpu") is c
    sess = base["sess"]
    truths = np.tile(sess.params.thawed_values(), (4, 1))
    sv = simulate_survey(sess.model, truths, np.random.default_rng(1))
    stack = pack_consts_stack(sess, sv.sz_stack, sv.xray_stack)
    blk = stack.block(2, 4)
    assert blk.n_clusters == 2 and blk.stride == stack.stride
    x = start(sess, 8)
    for i in range(2):
        assert torch.equal(joint_ll_plain(x, blk.clusters[i]),
                           joint_ll_plain(x, stack.clusters[2 + i]))


# -- the coupled sampler -------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_coupled_sharded_is_the_single_device_sampler(base, n_dev):
    """Chains, lp and acceptance of the coupled sampler over any number of
    shards are, bit for bit, ``KernelSampler.run``'s at the same seed (and
    so equal across shard counts)."""
    sess, c = base["sess"], base["c"]
    W, n_steps, thin = 32, 6, 2
    p0 = start(sess, W)
    ref = KernelSampler(c).run(p0, n_steps, np.random.default_rng(9),
                               thin=thin)
    seed = _seeds(np.random.default_rng(9), 1)[0]
    res = run_coupled_sharded_ensemble(c, p0, n_steps, seed,
                                       cpu_mesh(n_dev), thin=thin)
    assert res.chain.shape == (n_steps // thin, W, D)
    np.testing.assert_array_equal(res.chain, ref.chain)
    np.testing.assert_array_equal(res.log_prob, ref.log_prob)
    np.testing.assert_array_equal(res.acceptance_fraction,
                                  ref.acceptance_fraction)
    assert torch.equal(res.final_state[0], ref.final_state[0])
    assert torch.equal(res.final_state[1], ref.final_state[1])
    assert 0 < res.acceptance_fraction.sum() < W
    assert res.frame_spacing is None


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_coupled_sharded_follows_the_jax_sampler(base, js32, hash_bits,
                                                 n_dev):
    sess, c = base["sess"], base["c"]
    W, n_steps, thin, seed = 32, 6, 2, 123
    p0 = start(sess, W)
    want = jax_kernel_sharded.run_coupled_sharded_ensemble(
        js32, jnp.asarray(p0.numpy()), n_steps, seed,
        jax_make_mesh(n_dev, axis_names=("walker",)), thin=thin,
        interpret=True)
    got = run_coupled_sharded_ensemble(c, p0, n_steps, seed, cpu_mesh(n_dev),
                                       thin=thin)
    np.testing.assert_allclose(got.chain, np.asarray(want.chain), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got.log_prob, np.asarray(want.log_prob),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.acceptance_fraction,
                                  np.asarray(want.acceptance_fraction))
    assert got.acceptance_fraction.sum() > 0


def test_coupled_sharded_validations(base):
    c = base["c"]
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="divide"):
        run_coupled_sharded_ensemble(c, torch.zeros((10, D)), 4, 0, mesh,
                                     thin=2)
    with pytest.raises(ValueError, match="multiple"):
        run_coupled_sharded_ensemble(c, torch.zeros((16, D)), 5, 0, mesh,
                                     thin=2)
    with pytest.raises(ValueError, match="even number"):
        run_coupled_sharded_ensemble(c, torch.zeros((15, D)), 4, 0, mesh)


# -- the hybrid sampler ----------------------------------------------------------

def test_hybrid_coupled_mechanics(base):
    """Windows of local steps plus one coupled step per window: chain
    shapes follow the window-only recording rule, the spacing is declared,
    lp is consistent with a fresh evaluation, walkers move, and the
    acceptance counts include the coupled steps."""
    sess, c = base["sess"], base["c"]
    W, n_windows, sync_every, thin = 32, 3, 5, 2
    res = run_hybrid_coupled_ensemble(c, start(sess, W, seed=33), n_windows,
                                      sync_every, 7, cpu_mesh(4), thin=thin,
                                      allow_small=True)
    n_keep = n_windows * (sync_every - 1) // thin
    assert res.chain.shape == (n_keep, W, D)
    assert res.log_prob.shape == (n_keep, W)
    assert res.frame_spacing == pytest.approx(
        thin * sync_every / (sync_every - 1))
    assert res.frame_spacing * n_keep == pytest.approx(
        n_windows * sync_every)
    assert np.all(np.isfinite(res.log_prob))
    lp_re = joint_ll_plain(torch.tensor(res.chain[-1]), c).numpy()
    np.testing.assert_array_equal(res.log_prob[-1], lp_re)
    assert np.any(res.chain[0] != res.chain[-1])
    assert res.acceptance_fraction.mean() > 0.05
    xf, lpf = res.final_state
    assert torch.equal(joint_ll_plain(xf, c), lpf)
    # the coupled step after the last window moved walkers the last frame
    # does not show
    assert np.any(xf.numpy() != res.chain[-1])


def test_hybrid_follows_the_jax_sampler(base, js32, hash_bits):
    """Same seed, same window and coupled-step seeds (both draw them from
    ``numpy.random.default_rng(seed)``), the interpret-mode hash bits."""
    sess, c = base["sess"], base["c"]
    W, n_windows, sync_every, thin, seed = 32, 2, 5, 2, 7
    p0 = start(sess, W, seed=33)
    want = jax_kernel_sharded.run_hybrid_coupled_ensemble(
        js32, p0.numpy(), n_windows, sync_every, seed,
        jax_make_mesh(4, axis_names=("walker",)), thin=thin, interpret=True,
        allow_small=True)
    got = run_hybrid_coupled_ensemble(c, p0, n_windows, sync_every, seed,
                                      cpu_mesh(4), thin=thin,
                                      allow_small=True)
    assert got.frame_spacing == want.frame_spacing
    np.testing.assert_allclose(got.chain, np.asarray(want.chain), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got.log_prob, np.asarray(want.log_prob),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.final_state[0].numpy(),
                               np.asarray(want.final_state[0]), rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(got.acceptance_fraction,
                                  np.asarray(want.acceptance_fraction))


def test_hybrid_coupled_validations(base):
    c = base["c"]
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="sync_every"):
        run_hybrid_coupled_ensemble(c, torch.zeros((32, D)), 2, 1, 0, mesh)
    with pytest.raises(ValueError, match="n_windows"):
        run_hybrid_coupled_ensemble(c, torch.zeros((32, D)), 0, 5, 0, mesh)
    with pytest.raises(ValueError, match="even per-device"):
        run_hybrid_coupled_ensemble(c, torch.zeros((20, D)), 2, 5, 0, mesh)
    with pytest.raises(ValueError, match="multiple"):
        run_hybrid_coupled_ensemble(c, torch.zeros((32, D)), 2, 6, 0, mesh,
                                    thin=2, allow_small=True)
    # 8 walkers per device at ndim = 13 is below 2*ndim+2
    with pytest.raises(ValueError, match="walkers per device"):
        run_hybrid_coupled_ensemble(c, torch.zeros((32, D)), 2, 5, 0, mesh)


# -- the guard and the routing ------------------------------------------------

def test_small_per_device_ensemble_guard(base):
    """The runner errors below 2*ndim+2 walkers per device (unless
    ``allow_small``) and warns below 64; ``KernelSampler.run_sharded``
    declines (None and a warning) so ``run_fit`` can take the coupled
    sampler."""
    sess, c = base["sess"], base["c"]
    mesh = cpu_mesh(8)
    assert min_walkers_per_device(D) == 28
    x0 = start(sess, 32)                         # 4 walkers per device
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="2\\*ndim\\+2"):
        run_sharded_kernel_ensembles(c, x0, 2, rng, mesh, thin=2)
    with pytest.warns(UserWarning, match="prefer >= 64"):
        run_sharded_kernel_ensembles(c, start(sess, 56), 2, rng,
                                     cpu_mesh(2), thin=2)
    ks = KernelSampler(c)
    with pytest.warns(UserWarning, match="falling back"):
        assert ks.run_sharded(x0, 2, rng, mesh, thin=2) is None
    with pytest.warns(UserWarning, match="falling back"):
        assert ks.run_tempered_sharded(x0, [1.0, 0.5], 2, rng, mesh,
                                       thin=2) is None


def test_run_sharded_routes_small_ensembles_to_hybrid(base, monkeypatch,
                                                      capsys):
    """Below 64 walkers per device a long first call goes to the hybrid
    with sync_every = 1 (mod thin) near 100; at 64 and above, or after a
    short first call, to the independent ensembles; the decision is sticky
    until ``new_run``; below the floor the sampler declines."""
    c = base["c"]
    calls = {}

    def fake_hybrid(cc, p0, n_windows, sync_every, seed, mesh, **kw):
        calls["hybrid"] = (p0.shape, n_windows, sync_every, seed, kw)
        return "HYBRID"

    def fake_indep(cc, p0, n_steps, rng, mesh, **kw):
        calls["indep"] = (p0.shape, n_steps)
        return "INDEP"

    monkeypatch.setattr(kernel_sharded, "run_hybrid_coupled_ensemble",
                        fake_hybrid)
    monkeypatch.setattr(kernel_sharded, "run_sharded_kernel_ensembles",
                        fake_indep)
    sampler = KernelSampler(c)
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(3)

    p0 = torch.zeros((128, D))                  # 32 per device: 28 <= 32 < 64
    assert sampler.run_sharded(p0, 8000, rng, mesh, thin=25) == "HYBRID"
    shape, n_windows, sync_every, seed, kw = calls.pop("hybrid")
    assert shape == (128, D)
    assert sync_every == 101 and (sync_every - 1) % 25 == 0
    assert n_windows == round(8000 / 101)
    assert isinstance(seed, int) and kw["thin"] == 25
    assert kw["allow_small"] is True

    assert sampler.run_sharded(p0, 2000, rng, mesh, thin=1) == "HYBRID"
    _, n_windows, sync_every, _, _ = calls.pop("hybrid")
    assert sync_every == 100 and n_windows == 20

    # sticky: a short remainder chunk of the same run stays on the hybrid
    assert sampler.run_sharded(p0, 200, rng, mesh, thin=25) == "HYBRID"
    _, n_windows, sync_every, _, _ = calls.pop("hybrid")
    assert sync_every == 101 and n_windows == 2

    p_big = torch.zeros((256, D))
    assert sampler.run_sharded(p_big, 8000, rng, mesh, thin=25) == "INDEP"
    calls.pop("indep")

    # a first call too short for four windows: independent, and sticky
    fresh = KernelSampler(c)
    assert fresh.run_sharded(p0, 200, rng, mesh, thin=25) == "INDEP"
    calls.pop("indep")
    assert fresh.run_sharded(p0, 8000, rng, mesh, thin=25) == "INDEP"
    calls.pop("indep")
    assert "hybrid" not in calls
    fresh.new_run()
    assert fresh.run_sharded(p0, 8000, rng, mesh, thin=25) == "HYBRID"
    calls.pop("hybrid")

    # the routing note is printed only when asked for
    capsys.readouterr()
    fresh.new_run()
    assert fresh.run_sharded(p0, 8000, rng, mesh, thin=25) == "HYBRID"
    assert "hybrid coupled sampler" not in capsys.readouterr().out
    fresh.new_run()
    assert fresh.run_sharded(p0, 8000, rng, mesh, thin=25,
                             verbose=True) == "HYBRID"
    assert "hybrid coupled sampler" in capsys.readouterr().out

    p_tiny = torch.zeros((64, D))                # 16 per device < 28
    with pytest.warns(UserWarning, match="below 2\\*ndim\\+2"):
        assert sampler.run_sharded(p_tiny, 8000, rng, mesh, thin=25) is None
    # a walker count that does not divide declines without a warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sampler.run_sharded(torch.zeros((130, D)), 8000, rng, mesh,
                                   thin=25) is None


# -- independent per-shard ensembles ----------------------------------------------

def test_kernel_sharded_matches_per_device_runs(base):
    """Each shard's walker block is the single-device loop on that block
    with the shard's seed: sharding is orchestration only."""
    sess, c = base["sess"], base["c"]
    n_dev, w_loc, n_steps, thin = 4, 8, 6, 2
    W = n_dev * w_loc
    x0 = start(sess, W, seed=11)
    res = run_sharded_kernel_ensembles(c, x0, n_steps,
                                       np.random.default_rng(3),
                                       cpu_mesh(n_dev), thin=thin,
                                       allow_small=True)
    assert res.chain.shape == (3, W, D) and res.log_prob.shape == (3, W)
    seeds = np.random.default_rng(3).integers(0, 2 ** 31 - 1,
                                              size=(1, n_dev))[0]
    beta, db = rung_tensors([1.0], "cpu")
    for d in range(n_dev):
        s = slice(d * w_loc, (d + 1) * w_loc)
        x = x0[None, s].clone()
        lp = joint_ll_plain(x[0], c)[None]
        acc = torch.zeros_like(lp)
        sacc = torch.zeros(1, dtype=torch.int32)
        for i in range(n_steps):
            stretch_steps(x, lp, acc, sacc, beta, db, int(seeds[d]), 1, c,
                          step0=i)
            if (i + 1) % thin == 0:
                k = (i + 1) // thin - 1
                np.testing.assert_array_equal(res.chain[k, s], x[0].numpy())
                np.testing.assert_array_equal(res.log_prob[k, s],
                                              lp[0].numpy())
        assert torch.equal(res.final_state[0][s], x[0])
        np.testing.assert_array_equal(res.acceptance_fraction[s],
                                      (acc[0] / n_steps).numpy())
    assert np.all((res.acceptance_fraction >= 0)
                  & (res.acceptance_fraction <= 1))
    # the caller's start state is not touched
    assert torch.equal(x0, start(sess, W, seed=11))
    with pytest.raises(ValueError, match="must divide"):
        run_sharded_kernel_ensembles(c, x0[:30], 2, np.random.default_rng(0),
                                     cpu_mesh(4))
    with pytest.raises(ValueError, match="must be even"):
        run_sharded_kernel_ensembles(c, x0[:28], 2, np.random.default_rng(0),
                                     cpu_mesh(4), allow_small=True)
    empty = run_sharded_kernel_ensembles(c, x0, 0, np.random.default_rng(0),
                                         cpu_mesh(4), allow_small=True)
    assert empty.chain.shape == (0, W, D)


def test_tempered_kernel_sharded_matches_per_device(base):
    sess, c = base["sess"], base["c"]
    K, n_dev, w_loc, n_steps, thin = 3, 2, 8, 4, 2
    W = n_dev * w_loc
    betas = [1.0, 0.6, 0.36]
    p0 = start(sess, W, seed=21, K=K)
    res = run_sharded_tempered_ensembles(c, p0, betas, n_steps,
                                         np.random.default_rng(4),
                                         cpu_mesh(n_dev), thin=thin,
                                         allow_small=True)
    assert res.chain.shape == (2, W, D)
    assert res.swap_acceptance.shape == (K - 1,)
    assert res.acceptance_fraction.shape == (K, W)
    seeds = np.random.default_rng(4).integers(0, 2 ** 31 - 1,
                                              size=(1, n_dev))[0]
    beta, db = rung_tensors(betas, "cpu")
    sacc_tot = np.zeros(K - 1)
    for d in range(n_dev):
        s = slice(d * w_loc, (d + 1) * w_loc)
        x = p0[:, s].clone()
        lp = joint_ll_plain(x.reshape(-1, D), c).reshape(K, w_loc)
        acc = torch.zeros_like(lp)
        sacc = torch.zeros(K - 1, dtype=torch.int32)
        for i in range(n_steps):
            stretch_steps(x, lp, acc, sacc, beta, db, int(seeds[d]), 1, c,
                          step0=i)
        assert torch.equal(res.final_state[0][:, s], x)
        np.testing.assert_array_equal(res.chain[-1, s], x[0].numpy())
        sacc_tot += sacc.numpy()
    assert sacc_tot.sum() > 0
    np.testing.assert_allclose(res.swap_acceptance,
                               sacc_tot / float(n_steps * W))
    with pytest.raises(ValueError, match="rungs"):
        run_sharded_tempered_ensembles(c, p0[:2], betas, n_steps,
                                       np.random.default_rng(4),
                                       cpu_mesh(n_dev), allow_small=True)


def test_sharded_multicluster_matches_per_device(base):
    """Cluster blocks over a mesh equal ``run_multicluster_steps`` on each
    block alone with the block's seed."""
    sess = base["sess"]
    C, W, n_dev, n_inner, thin = 4, 16, 2, 4, 2
    truths = np.tile(sess.params.thawed_values(), (C, 1))
    truths[:, sess.params.thawed.index("P_0")] *= np.linspace(0.8, 1.2, C)
    sv = simulate_survey(sess.model, truths, np.random.default_rng(17))
    stack = pack_consts_stack(sess, sv.sz_stack, sv.xray_stack)
    rng = np.random.default_rng(17)
    x0 = torch.tensor(truths[:, None] * (1 + 0.02 * rng.standard_normal(
        (C, W, D))), dtype=torch.float32)
    lp0 = multicluster_ll(x0, stack)
    assert bool(torch.isfinite(lp0).all())
    acc0 = torch.zeros((C, W))
    seeds = [7, 19]
    fn = make_sharded_multicluster_step(stack, cpu_mesh(n_dev, "cluster"),
                                        n_inner, thin=thin)
    x, lp, acc, chain, chain_lp = fn(x0, lp0, acc0, seeds)
    assert chain.shape == (C, 2, W, D) and chain_lp.shape == (C, 2, W)
    c_loc = C // n_dev
    for d in range(n_dev):
        s = slice(d * c_loc, (d + 1) * c_loc)
        xd, lpd, accd = x0[s].clone(), lp0[s].clone(), acc0[s].clone()
        chd, chlpd = run_multicluster_steps(
            stack.block(d * c_loc, (d + 1) * c_loc), xd, lpd, accd, n_inner,
            seeds[d], thin=thin)
        assert torch.equal(x[s], xd) and torch.equal(lp[s], lpd)
        assert torch.equal(acc[s], accd)
        assert torch.equal(chain[s], chd) and torch.equal(chain_lp[s], chlpd)
    assert float(acc.sum()) > 0
    assert torch.equal(x0, x0) and not torch.equal(x, x0)
    # without thin: the state only
    assert len(make_sharded_multicluster_step(
        stack, cpu_mesh(n_dev, "cluster"), 2)(x0, lp0, acc0, seeds)) == 3
    with pytest.raises(ValueError, match="divide"):
        make_sharded_multicluster_step(stack, cpu_mesh(3, "cluster"), 4)


# -- the plain mesh samplers ----------------------------------------------------

def _gauss(x):
    return -0.5 * (x * x).sum(dim=-1)


def test_sharded_ensemble_equals_the_single_device_sampler():
    """Sharding does not change the algorithm: same generator seed, same
    start, the chain of ``run_ensemble``."""
    W = 32
    p0 = torch.tensor(np.random.default_rng(5).standard_normal((W, 2)))
    out = run_sharded_ensemble(_gauss, p0, 50,
                               torch.Generator().manual_seed(6), cpu_mesh(8),
                               thin=5)
    ref = run_ensemble(_gauss, p0, 50, torch.Generator().manual_seed(6),
                       thin=5)
    np.testing.assert_allclose(out.chain, ref.chain, atol=1e-12)
    np.testing.assert_allclose(out.log_prob, ref.log_prob, atol=1e-12)
    np.testing.assert_array_equal(out.acceptance_fraction,
                                  ref.acceptance_fraction)
    # one likelihood per shard
    per = run_sharded_ensemble([_gauss] * 8, p0, 50,
                               torch.Generator().manual_seed(6), cpu_mesh(8),
                               thin=5)
    np.testing.assert_array_equal(per.chain, out.chain)
    with pytest.raises(ValueError, match="likelihoods"):
        run_sharded_ensemble([_gauss] * 3, p0, 50,
                             torch.Generator().manual_seed(6), cpu_mesh(8))


def test_sharded_ensemble_matches_moments():
    W = 64
    p0 = torch.tensor(np.random.default_rng(0).standard_normal((W, 4)))
    out = run_sharded_ensemble(_gauss, p0, 800,
                               torch.Generator().manual_seed(1), cpu_mesh(8),
                               thin=4)
    flat = out.chain.reshape(-1, 4)
    assert 0.1 < out.acceptance_fraction.mean() < 0.9
    assert np.all(np.abs(flat.mean(axis=0)) < 0.15)
    assert np.allclose(flat.std(axis=0), 1.0, atol=0.15)


def test_multi_cluster_runs_and_equals_the_batched_sampler():
    mesh = make_mesh(8, axis_names=("cluster", "walker"), shape=(2, 4),
                     devices=[CPU] * 8)
    C, W = 4, 16
    p0 = torch.tensor(np.random.default_rng(2).standard_normal((C, W, 3))
                      * 3.0)
    out = run_multi_cluster([_gauss, _gauss], p0, 200,
                            torch.Generator().manual_seed(3), mesh)
    assert out["positions"].shape == (C, W, 3)
    assert out["acceptance_fraction"].mean() > 0.2
    assert out["positions"].std() < 2.0
    ref = run_batched_ensembles(_gauss, p0, 0, 200,
                                torch.Generator().manual_seed(3))
    np.testing.assert_allclose(out["positions"], ref[3].numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="one likelihood per"):
        run_multi_cluster(_gauss, p0, 10, torch.Generator().manual_seed(3),
                          mesh)
    walker_only = run_multi_cluster(_gauss, p0, 200,
                                    torch.Generator().manual_seed(3),
                                    cpu_mesh(4))
    np.testing.assert_allclose(walker_only["positions"], out["positions"],
                               atol=1e-12)


# -- run_fit and the entry points --------------------------------------------------

def _fit(base, ks, mesh, **kw):
    sess = base["sess"]
    p = sess.params
    args = dict(nwalkers=56, nburn=4, nsteps=8, nthin=2, seed=0,
                initspread=0.02, prelim_iterations=2, max_prelim_rounds=1,
                do_mle=False, mesh=mesh, verbose=False)
    args.update(kw)
    theta0 = truth_rows(p, 1, seed=0, spread=0.0)[0]
    return run_fit(sess.model, ks, theta0, p.lo, p.hi, p.thawed, **args)


def test_run_fit_routes_mesh_through_sharded_kernel(base, monkeypatch):
    """With a mesh and a step sampler the sampling phase goes through the
    per-shard kernel ensembles (28 walkers per device: the smallest the
    guard admits), prelim and burn-in stay on the single-device sampler."""
    ks = KernelSampler(base["c"])
    calls = []
    real = kernel_sharded.run_sharded_kernel_ensembles
    monkeypatch.setattr(
        kernel_sharded, "run_sharded_kernel_ensembles",
        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    res = _fit(base, ks, cpu_mesh(2))
    assert calls == [8]
    assert res.chain.shape == (4, 56, D)
    lp_re = ks.log_prob_batch(torch.tensor(res.chain[-1])).numpy()
    np.testing.assert_array_equal(res.log_prob[-1], lp_re)
    assert res.timings["frame_spacing"] == 2.0
    assert np.isfinite(res.mle_loglike)


def test_run_fit_mesh_takes_the_hybrid_and_its_spacing(base):
    """A run long enough for four windows at 28 walkers per device goes to
    the hybrid; the stopping rule reads the declared spacing."""
    ks = KernelSampler(base["c"])
    n0 = (step_kernel.stretch_steps.launches,
          coupled_kernel.coupled_half.launches)
    res = _fit(base, ks, cpu_mesh(2), nsteps=404, auto_extend=1,
               target_rhat=1e9)
    # thin 2 -> sync_every 101: 4 windows of 50 frames per sampling call
    rounds = 1 + res.timings["auto_extend_rounds"]
    assert res.chain.shape == (200 * rounds, 56, D)
    assert res.timings["frame_spacing"] == pytest.approx(2 * 101 / 100)
    assert np.all(np.isfinite(res.log_prob))
    assert 0.05 < float(np.mean(res.acceptance_fraction)) < 0.9
    assert res.timings["tau_steps"] > 0
    assert n0 == (step_kernel.stretch_steps.launches,
                  coupled_kernel.coupled_half.launches)   # CPU: no launches


def test_run_fit_mesh_declined_layout_takes_the_coupled_sampler(
        base, capsys, monkeypatch):
    """A layout the kernel sampler declines (10 walkers per shard, below
    the floor) is sampled as one ensemble coupled across the mesh, through
    kernel 6's wrapper and never the plain mesh sampler, with the note
    once; a half-ensemble that does not divide raises; without a step
    sampler the mesh runs the plain sampler."""
    from joxsz_torch.parallel import sharded

    ks = KernelSampler(base["c"])
    real = kernel_sharded.run_coupled_sharded_ensemble
    calls = []
    monkeypatch.setattr(
        kernel_sharded, "run_coupled_sharded_ensemble",
        lambda *a, **k: calls.append((a[2], k["thin"])) or real(*a, **k))
    plain = []
    real_plain = sharded.run_sharded_ensemble
    monkeypatch.setattr(
        sharded, "run_sharded_ensemble",
        lambda *a, **k: plain.append(a[2]) or real_plain(*a, **k))
    with pytest.warns(UserWarning, match="falling back"):
        res = _fit(base, ks, cpu_mesh(4), nwalkers=40, verbose=True,
                   auto_extend=1, target_rhat=0.0)
    assert calls == [(8, 2), (8, 2)] and plain == []
    assert res.chain.shape == (8, 40, D)
    lp_re = ks.log_prob_batch(torch.tensor(res.chain[-1])).numpy()
    np.testing.assert_array_equal(res.log_prob[-1], lp_re)
    assert res.timings["frame_spacing"] == 2.0
    out = capsys.readouterr().out
    assert out.count("sharded kernel sampler declined") == 1
    assert "coupled across the mesh" in out
    # 42 walkers: the half of 21 does not divide over 4 shards
    with pytest.raises(ValueError, match="half-ensemble"):
        _fit(base, ks, cpu_mesh(4), nwalkers=42)
    # and without a step sampler at all
    res = _fit(base, None, cpu_mesh(4), nwalkers=40)
    assert plain == [8]
    assert res.chain.shape == (4, 40, D) and res.chain.dtype == np.float64


def test_run_fit_mesh_tempered(base):
    ks = KernelSampler(base["c"])
    res = _fit(base, ks, cpu_mesh(2), n_temper_rungs=2)
    assert res.chain.shape == (4, 56, D)
    assert len(res.timings["swap_acceptance"]) == 1
    assert res.final_state[0].shape == (2, 56, D)
