"""``run_fit``'s persistence: resume, the chunked chain flushes and the
outputs, on the small synthetic session through the kernels' plain
versions (``KernelSampler`` on CPU tensors; each chunk of steps draws a
Philox seed from the run's numpy generator).

  * a resume skips the MLE, init, prelim and burn-in, continues the whole
    replica ladder when the rung count matches (restarting it from the
    cold rung with a note when not), counts no burn-in in its
    likelihood evaluations, and draws its seeds from the state's
    unconsumed draw folded once: its first Philox seed is none of the
    original run's, and two resumes from one file agree;
  * with ``chain_path`` the plain path samples in chunks of
    ``checkpoint_every`` frames, flushing chain and state after each, and
    every auto-extend round flushes again; the final file carries the
    burn-in and equals the result.
"""

import numpy as np
import pytest

from joxsz_torch.build import build_session
from joxsz_torch.io.checkpoint import load_chain, load_state
from joxsz_torch.sampling import driver, kernel
from joxsz_torch.sampling.kernel import make_kernel_sampler
from joxsz_torch.synth import truth_theta

from test_torch_build import small_config

W, NSTEPS, NTHIN, NBURN = 16, 40, 2, 20


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_resume"))
    sess = build_session(cfg, device="cpu")
    return sess, make_kernel_sampler(sess)


@pytest.fixture
def seeds(monkeypatch):
    """Every Philox chunk seed the kernel sampler draws, in order."""
    drawn = []
    real = kernel._seeds

    def spy(rng, n):
        out = real(rng, n)
        drawn.extend(out)
        return out

    monkeypatch.setattr(kernel, "_seeds", spy)
    return drawn


def fit(session, tmp, **kw):
    sess, sampler = session
    p = sess.params
    args = dict(nwalkers=W, nburn=NBURN, nsteps=NSTEPS, nthin=NTHIN, seed=4,
                prelim_iterations=20, max_prelim_rounds=1, do_mle=False,
                n_temper_rungs=2, state_path=str(tmp / "state.npz"),
                verbose=True)
    args.update(kw)
    return driver.run_fit(sess.model, sampler, truth_theta(sess), p.lo,
                          p.hi, p.thawed, **args)


def test_resume_continues_the_ladder_on_a_fresh_stream(session, tmp_path,
                                                       seeds, capsys,
                                                       monkeypatch):
    first = fit(session, tmp_path, chain_path=str(tmp_path / "c.hdf5"),
                best_path=str(tmp_path / "fit.dat"))
    original = list(seeds)
    saved = load_state(str(tmp_path / "state.npz"))
    assert saved["temper_state"].shape == (2, W, first.chain.shape[2])
    np.testing.assert_array_equal(saved["positions"],
                                  saved["temper_state"][0])
    assert int(saved["key"][0]) not in original

    sess, sampler = session
    starts = []
    real = sampler.run_tempered

    def spy(p0, *a, **k):
        starts.append(p0.detach().cpu().numpy().copy())
        return real(p0, *a, **k)

    monkeypatch.setattr(sampler, "run_tempered", spy)
    seeds.clear()
    capsys.readouterr()
    res = fit(session, tmp_path / "b", resume_from=str(tmp_path /
                                                        "state.npz"))
    out = capsys.readouterr().out
    assert "resuming the full 2-rung replica ladder" in out
    np.testing.assert_array_equal(starts[0], saved["temper_state"])
    assert seeds[0] not in original and not set(seeds) & set(original)
    t = res.timings
    assert t["prelim_rounds"] == 0 and t["mle_device"] == "none"
    assert t["likelihood_evals"] == NSTEPS * 2 * W
    assert res.chain.shape[0] == NSTEPS // NTHIN

    resumed = list(seeds)
    seeds.clear()
    fit(session, tmp_path / "c", resume_from=str(tmp_path / "state.npz"))
    assert seeds == resumed


def test_resume_with_another_rung_count_restarts_the_ladder(
        session, tmp_path, capsys):
    fit(session, tmp_path)
    capsys.readouterr()
    res = fit(session, tmp_path / "b", n_temper_rungs=3,
              resume_from=str(tmp_path / "state.npz"))
    assert "restarting the ladder from a replicated cold rung" in \
        capsys.readouterr().out
    assert res.chain.shape == (NSTEPS // NTHIN, W, res.chain.shape[2])


def test_chunked_flushes_and_final_file(session, tmp_path, monkeypatch):
    flushes = []
    real = driver.save_chain

    def spy(path, chain, *a, **k):
        flushes.append((chain.shape[0], a[3]))      # frames, burn
        return real(path, chain, *a, **k)

    monkeypatch.setattr(driver, "save_chain", spy)
    states = []
    real_state = driver.save_state

    def spy_state(path, x, lp, key, meta, **k):
        states.append(meta.get("steps_done"))
        return real_state(path, x, lp, key, meta, **k)

    monkeypatch.setattr(driver, "save_state", spy_state)
    chain = tmp_path / "c.npz"
    res = fit(session, tmp_path, n_temper_rungs=0, chain_path=str(chain),
              checkpoint_every=5)
    # 20 frames in chunks of 5, then the final write
    assert flushes == [(5, NBURN), (10, NBURN), (15, NBURN), (20, NBURN),
                       (20, NBURN)]
    assert states == [10, 20, 30, 40, None]
    saved = load_chain(str(chain))
    np.testing.assert_array_equal(saved["chain"], res.chain)
    assert saved["burn"] == NBURN and saved["thin"] == NTHIN
    assert res.timings["likelihood_evals"] == (20 + NBURN + NSTEPS) * W


def test_auto_extend_flushes_every_round(session, tmp_path, monkeypatch):
    flushes = []
    real = driver.save_chain

    def spy(path, chain, *a, **k):
        flushes.append(chain.shape[0])
        return real(path, chain, *a, **k)

    monkeypatch.setattr(driver, "save_chain", spy)
    res = fit(session, tmp_path, chain_path=str(tmp_path / "c.hdf5"),
              auto_extend=2, target_rhat=0.5)
    rounds = res.timings["auto_extend_rounds"]
    assert rounds == 2
    frames = NSTEPS // NTHIN
    assert flushes == [2 * frames, 3 * frames, 3 * frames]
    saved = load_chain(str(tmp_path / "c.hdf5"))
    assert saved["burn"] == NBURN + res.timings["extra_burn_steps"]
