"""Port: the program's spans and counters (``joxsz_torch/utils/timing.py``).

On the synthetic CL J1226 dataset (seed 11) at a tiny size, with every
walker of a fit on one near-tie row of ``tests/test_torch_veto_ties.py``'s
0.1 cloud (``mass_veto.near_tie_rows``): each proposal is then that row,
whose mass veto sends a known number of pairs past tier 1.

* With no profiler recording, the survey's kernel route
  (``fit_survey(step_kernel=True)``, the plain versions here), a tempered
  phase and a plain run enter no ``record_function``, read no veto
  counter and count nothing.
* Under ``profile_to`` the Chrome trace holds every span, each inside
  its parent; the survey's ``timings`` are its spans' seconds; the
  phase counters add up to the whole fit's pairs; the kernel route
  counts its summary taken on the device, between the sampling and the
  fetch, and the plain route counts none.
* The plain mirror's ``T2_PAIRS`` counts the pairs ``joint_ll_plain``'s
  details send past tier 1.
* On a card (``gpu``): kernel 1's and the step kernel's tier-2 counters
  equal the plain versions' counts on the same rows, tiles whose pair
  list overflows included.

The card's test imports no JAX: ``python -m pytest --noconftest
tests/test_torch_tracing.py -m gpu`` runs it where JAX is missing.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from joxsz_torch import survey
from joxsz_torch.build import build_session
from joxsz_torch.models.multicluster import stack_sz_data, stack_xray_data
from joxsz_torch.ops import joint_kernel, mass_veto, step_kernel
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.sampling import kernel
from joxsz_torch.sampling.kernel import (KernelSampler, make_kernel_sampler,
                                         multicluster_start,
                                         run_tempered_kernel)
from joxsz_torch.sampling.sbc import veto_margins
from joxsz_torch.synth import truth_theta, write_synthetic_dataset
from joxsz_torch.utils import timing

C, W, BURN, STEPS, THIN = 2, 28, 2, 2, 2
# the pairs a tile of 16 walkers lists (csrc/joint_ll.cuh); the most
# pairs a near-tie row may send past tier 1 for its collapsed ensemble to
# fit the list (16 x 4), and a row's pairs that overflow it (16 x 6)
PAIR_CAP = 64
ROW_PAIRS, OVER_PAIRS = 4, 6
# float32 ulps of a mass within which the card's tier 1 and the plain
# version's may decide a pair apart (twice the 8.0 seen on the card)
NEAR_ULPS = 16
# (span, a span or the test's region that holds it)
NESTING = [("survey.start", "survey.fit"), ("survey.pack", "survey.start"),
           ("survey.init", "survey.start"), ("survey.burn", "survey.fit"),
           ("survey.sample", "survey.fit"), ("sampler.fetch", "survey.fit"),
           ("survey.summary", "survey.fit"), ("sampler.lp0", "test.phase"),
           ("sampler.steps", "test.phase"), ("sampler.fetch", "test.phase")]
PARENTS = {}
for _child, _parent in NESTING:
    PARENTS.setdefault(_child, []).append(_parent)


def near_tie_setting(root):
    """(session, constants, near-tie rows, their pairs past tier 1, their
    log-posteriors, the cloud's rows) of the dataset written under
    ``root``."""
    cfg = write_synthetic_dataset(str(root), 11)
    sess = build_session(cfg, device="cpu")
    c = pack_consts(sess)
    m = sess.model
    th0 = truth_theta(sess)
    rows = (th0[None] * (1 + 0.1 * np.random.default_rng(7).standard_normal(
        (512, th0.size)))).astype(np.float32)
    margins = veto_margins(m, rows.astype(np.float64))
    with torch.no_grad():
        keep = np.isfinite(m.log_like_batch(torch.tensor(
            rows, dtype=torch.float64)).numpy())
        box = np.isfinite(m.params.log_prior(torch.tensor(
            rows, dtype=torch.float64)).numpy())
    kept = np.flatnonzero(keep & (margins > 0))[:2]
    vetoed = np.flatnonzero(box & (margins < 0))[:2]
    ties = np.concatenate([mass_veto.near_tie_rows(m, rows[i], rows[j])[0]
                           for i, j in zip(kept, vetoed)])
    det = {}
    lp = joint_ll_plain(torch.tensor(ties), c, det).numpy()
    pairs = det["cand"].sum(dim=1).numpy()
    return sess, c, ties, pairs, lp, rows


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """``near_tie_setting`` on one torch thread, as the samplers' tests
    take."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield near_tie_setting(tmp_path_factory.mktemp("trace"))
    torch.set_num_threads(n)


def _tie_row(setting, n_pairs=ROW_PAIRS, keep=None):
    """A near-tie row with a finite log-posterior and ``n_pairs`` pairs
    past tier 1 (of the rows ``keep`` allows)."""
    _, _, ties, pairs, lp, _ = setting
    ok = np.isfinite(lp) & (pairs == n_pairs)
    i = np.flatnonzero(ok if keep is None else ok & keep)
    assert i.size, pairs.tolist()
    return ties[i[0]]


def _fit(sess, row):
    m = sess.model
    return survey.fit_survey(
        sess, stack_sz_data([m.sz_data] * C),
        stack_xray_data([m.xray_data] * C),
        np.tile(row.astype(np.float64), (C, 1)), n_walkers=W, n_burn=BURN,
        n_steps=STEPS, thin=THIN, seed=2, init_spread=0.0,
        step_kernel=True)


def _phases(sess, row):
    """A tempered phase (K = 2) and a plain run, every walker on row."""
    s = make_kernel_sampler(sess)
    x = torch.tensor(np.tile(row, (2, W, 1)))
    run_tempered_kernel(s, x, [1.0, 0.6], STEPS, np.random.default_rng(1),
                        thin=THIN)
    s.run(x[0], STEPS, np.random.default_rng(1), thin=THIN)


def test_untraced_routes_enter_no_record_function(setting, monkeypatch):
    sess = setting[0]
    row = _tie_row(setting)

    def refuse(*a, **k):
        raise AssertionError("a span entered record_function untraced")

    def no_read(*a, **k):
        raise AssertionError("a veto counter was read untraced")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(kernel, "_veto_counts", no_read)
    timing.reset_counters()
    res = _fit(sess, row)
    _phases(sess, row)
    assert timing.counters() == {}
    assert set(res.timings) == {"setup_s", "pack_s", "init_s", "sampling_s",
                                "summary_s"}
    assert all(v > 0 for v in res.timings.values()), res.timings


@pytest.fixture(scope="module")
def traced(setting, tmp_path_factory):
    """A fit and the phases under ``profile_to``: (trace events by name,
    the fit's timings, the counters after the fit, the plain mirror's
    pairs over the fit and over its start alone, the fit's spans by
    name)."""
    sess = setting[0]
    row = _tie_row(setting)
    m = sess.model
    szs = stack_sz_data([m.sz_data] * C)
    xrs = stack_xray_data([m.xray_data] * C)
    cen = np.tile(row.astype(np.float64), (C, 1))
    t2, f64 = mass_veto.T2_PAIRS[0], mass_veto.F64_PAIRS[0]
    multicluster_start(sess, szs, xrs, cen, W, 2, 0.0)
    start = (mass_veto.T2_PAIRS[0] - t2, mass_veto.F64_PAIRS[0] - f64)
    out = tmp_path_factory.mktemp("prof")
    made = {}
    span = timing.trace_annotation

    def kept(name, timed=False):
        made[name] = span(name, timed)
        return made[name]

    timing.reset_counters()
    with timing.profile_to(str(out)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(timing, "trace_annotation", kept)
            mp.setattr(kernel, "trace_annotation", kept)
            t2, f64 = mass_veto.T2_PAIRS[0], mass_veto.F64_PAIRS[0]
            res = _fit(sess, row)
            whole = (mass_veto.T2_PAIRS[0] - t2,
                     mass_veto.F64_PAIRS[0] - f64)
        counts = timing.counters()
        with torch.profiler.record_function("test.phase"):
            _phases(sess, row)
    timing.reset_counters()
    spans = {}
    for e in json.loads((out / "trace.json").read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and "dur" in e:
            a = float(e["ts"]) * 1e-6
            spans.setdefault(e["name"], []).append((a, a + e["dur"] * 1e-6))
    return spans, res.timings, counts, whole, start, made


@pytest.mark.parametrize("child,parent", NESTING)
def test_spans_nest_in_the_chrome_trace(traced, child, parent):
    spans = traced[0]
    assert child in spans and parent in spans, sorted(spans)
    # every span of the parent's name holds one of the child's, and each
    # of the child's lies inside a span of one of its parents' names
    for a, b in spans[parent]:
        assert any(a <= c0 and c1 <= b for c0, c1 in spans[child])
    for c0, c1 in spans[child]:
        assert any(a <= c0 and c1 <= b for p in PARENTS[child]
                   for a, b in spans[p]), (child, c0, c1)


def test_timings_are_the_spans(traced):
    """The fit's timings are its spans' own ``perf_counter`` seconds, and
    each of those intervals lies inside the span the profiler recorded."""
    spans, timings, made = traced[0], traced[1], traced[5]
    sec = {n: made[n].seconds for n in ("survey.start", "survey.pack",
                                        "survey.init", "survey.burn",
                                        "survey.sample", "sampler.fetch",
                                        "survey.summary")}
    assert timings == {
        "setup_s": sec["survey.start"], "pack_s": sec["survey.pack"],
        "init_s": sec["survey.init"], "summary_s": sec["survey.summary"],
        "sampling_s": sec["survey.burn"] + sec["survey.sample"]
        + sec["sampler.fetch"]}
    for name, t in sec.items():
        (a, b), = [s for s in spans[name]
                   if any(f0 <= s[0] and s[1] <= f1
                          for f0, f1 in spans["survey.fit"])]
        # the profiler's clock in whole microseconds
        assert 0 < t <= b - a + 2e-6, (name, t, b - a)


def test_phase_counters_sum_to_the_fit(traced):
    _, _, counts, whole, start, _ = traced
    assert counts["steps.burn"] == BURN and counts["steps.sample"] == STEPS
    steps_t2 = whole[0] - start[0]
    assert counts["tier2_pairs.burn"] + counts["tier2_pairs.sample"] \
        == steps_t2
    assert counts["f64_pairs.burn"] + counts["f64_pairs.sample"] \
        == whole[1] - start[1]
    # every proposal is the near-tie row
    assert steps_t2 == ROW_PAIRS * C * W * (BURN + STEPS)
    assert counts["tier2_pairs.burn"] == ROW_PAIRS * C * W * BURN


def test_summary_is_taken_on_the_device_between_sampling_and_fetch(traced):
    """The kernel route counts one summary taken on the sampler's device;
    its span ``survey.summary`` (``summary_s``) opens after
    ``survey.sample`` and closes before ``sampler.fetch``, outside the
    spans whose seconds make ``sampling_s``."""
    spans, timings, counts, made = traced[0], traced[1], traced[2], traced[5]
    assert counts["survey.summary_on_device"] == 1
    (f0, f1), = spans["survey.fit"]

    def inside(name):
        (a, b), = [s for s in spans[name] if f0 <= s[0] and s[1] <= f1]
        return a, b

    s0, s1 = inside("survey.summary")
    assert inside("survey.sample")[1] <= s0 and s1 <= inside(
        "sampler.fetch")[0]
    assert timings["summary_s"] == made["survey.summary"].seconds > 0
    assert timings["sampling_s"] == (made["survey.burn"].seconds
                                     + made["survey.sample"].seconds
                                     + made["sampler.fetch"].seconds)


@pytest.mark.parametrize("traced_fit", [False, True])
def test_plain_route_counts_no_summary_on_device(setting, tmp_path,
                                                 traced_fit):
    """The plain batched ensembles summarise the fetched host chain: no
    count, with or without a profiler recording."""
    sess = setting[0]
    m = sess.model
    timing.reset_counters()
    with (timing.profile_to(str(tmp_path)) if traced_fit
          else contextlib.nullcontext()):
        res = survey.fit_survey(
            sess, stack_sz_data([m.sz_data] * C),
            stack_xray_data([m.xray_data] * C),
            np.tile(truth_theta(sess), (C, 1)), n_walkers=W, n_burn=BURN,
            n_steps=STEPS, thin=THIN, seed=2, step_kernel=False)
    counts = timing.counters()
    timing.reset_counters()
    assert res.timings is None
    assert res.medians.shape == (C, res.chain.shape[-1])
    assert "survey.summary_on_device" not in counts


def test_plain_mirror_counts_tier2_pairs(setting):
    """``T2_PAIRS`` adds the pairs past tier 1 of the walkers that no
    sure pair vetoes and the prior box keeps (the details' ``cand``), on
    the near-tie rows and the cloud they come from."""
    _, c, ties, pairs, _, rows = setting
    for r in (ties, rows):
        det = {}
        before = mass_veto.T2_PAIRS[0]
        joint_ll_plain(torch.tensor(r), c, det)
        assert mass_veto.T2_PAIRS[0] - before == int(det["cand"].sum())
        before = joint_kernel.tier2_pairs()
        joint_ll_plain(torch.tensor(r), c)
        assert joint_kernel.tier2_pairs() - before == int(det["cand"].sum())
    assert pairs.sum() > 0 and (pairs <= 6).all()


def _near_bound(det, ulps: float) -> np.ndarray:
    """(B, n) bool: product-form pairs whose upper mass lies within
    ``ulps`` float32 ulps of either tier-1 bound, m_lo (1 +- T), in the
    plain version's masses (``joint_ll_plain``'s details)."""
    assert not det["wide"].any()
    m, wb = det["m"].double(), det["wb"]
    n = m.shape[1]
    outer = torch.arange(n) >= mass_veto.outer_start(n)
    sT = (wb["sgn"] * torch.where(outer, wb["t0o"], wb["t0"])).double()
    lo, hi = m[:, det["lo"]], m[:, det["hi"]]
    ulp = torch.tensor(np.spacing(hi.abs().float().numpy()),
                       dtype=torch.float64)
    return (torch.minimum((hi - lo * (1 + sT)).abs(),
                          (hi - lo * (1 - sT)).abs()) < ulps * ulp).numpy()


@pytest.mark.gpu
def test_tier2_counters_on_card(setting):
    """Kernel 1 on tiles of a near-tie row and 15 cloud rows (16 rows a
    tile: none padded, and each tile's pair list holds its pairs) and on
    tiles of 16 copies of a near-tie row whose pairs overflow the list,
    and the step kernel at K = 1 and K = 4 with every walker on a
    near-tie row of ROW_PAIRS or of OVER_PAIRS pairs (16 walkers a tile:
    the list whole, or overflowed), count the plain versions' pairs.
    Tier 1 compares float32 masses that the tile and the plain version
    round apart by a few ulps (8.0 seen on the card): a tile holding a
    pair within NEAR_ULPS of a tier-1 bound is held to the plain count
    only up to its rows' pairs that could move, those near a bound and,
    as a veto of the walker may move too, the unsure."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from joxsz_torch.ops.joint_kernel import joint_ll

    sess, c, ties, pairs, _, rows = setting
    tiles = np.concatenate([
        np.concatenate([t[None], rows[15 * k:15 * k + 15]])
        for k, t in enumerate(ties)]
        + [np.repeat(ties[pairs > PAIR_CAP // 16], 16, axis=0)])
    c_card = pack_consts(sess, device="cuda")
    det = {}
    joint_ll_plain(torch.tensor(tiles), c, det)
    plain = det["cand"].sum(dim=1).numpy().reshape(-1, 16).sum(axis=1)
    near = _near_bound(det, NEAR_ULPS)
    room = (near.sum(axis=1) + np.where(near.any(axis=1), det["unsure"]
                                        .sum(dim=1).numpy(), 0))
    room = room.reshape(-1, 16).sum(axis=1)
    card = []
    for t in range(len(plain)):
        before = joint_kernel.tier2_pairs()
        joint_ll(torch.tensor(tiles[16 * t:16 * t + 16], device="cuda"),
                 c_card)
        card.append(joint_kernel.tier2_pairs() - before)
    card = np.array(card)
    exact = room == 0
    assert exact[:len(ties)].sum() >= 10 and plain[exact].sum() > 0
    assert (exact & (plain > PAIR_CAP)).sum() >= 3, (plain, room)
    np.testing.assert_array_equal(card[exact], plain[exact])
    assert (np.abs(card - plain) <= room).all(), (card - plain, room)

    # the phase counters (stream-ordered snapshots) against the plain
    # version's, and against the library's synchronous reader, on rows
    # with no pair near a tier-1 bound
    det = {}
    joint_ll_plain(torch.tensor(ties), c, det)
    calm = ~_near_bound(det, NEAR_ULPS).any(axis=1)
    for n_pairs, K in ((ROW_PAIRS, 1), (ROW_PAIRS, 4), (OVER_PAIRS, 1),
                       (OVER_PAIRS, 4)):
        row = _tie_row(setting, n_pairs, calm)
        got = []
        for s in (KernelSampler(c), KernelSampler(c_card)):
            x = torch.tensor(np.tile(row, (K, 32, 1)), device=s.device)
            timing.reset_counters()
            before = step_kernel.tier2_pairs()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                if K == 1:
                    s.run(x[0], 20, np.random.default_rng(3), thin=10)
                else:
                    run_tempered_kernel(s, x, 0.6 ** np.arange(K), 20,
                                        np.random.default_rng(3), thin=10)
            got.append(timing.counters()["tier2_pairs.sample"])
        timing.reset_counters()
        assert got[0] == got[1] == step_kernel.tier2_pairs() - before \
            == n_pairs * K * 32 * 20, (n_pairs, K, got)
