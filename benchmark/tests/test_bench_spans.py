"""The readers of the program's spans and counters (``harness/spans.py``
and the metrics that use it) on a trace built from synthetic Chrome
events: kernels, the benchmark's ``job`` span and nested program spans;
an idle gap under a program span counts as named, one under ``job``
alone as unnamed; a program without spans or counters reads None."""

import types

import pytest

from benchmark.harness import manifest, spans
from benchmark.harness.trace import Trace


def _ev(cat, name, t0_ms, t1_ms, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": 1e3 * t0_ms,
            "dur": 1e3 * (t1_ms - t0_ms), "args": args}


def _trace(program=True, cards=1):
    """A 10 ms job: kernels over 0.1-0.3, 2-4 and 6-8.5 ms on each card;
    program spans survey.fit 0.5-9.8 holding survey.pack 0.6-1.6,
    sampler.fetch 8.5-9.6 (a copy 8.7-9.5 under it) and survey.summary
    9.6-9.8, and a sampler.fetch outside the job."""
    ev = [_ev("user_annotation", "job", 0, 10)]
    for d in range(cards):
        ev += [_ev("kernel", "joint_ll_kernel", 0.1, 0.3, device=d),
               _ev("kernel", "stretch_steps_kernel", 2, 4, device=d),
               _ev("kernel", "stretch_steps_kernel", 6, 8.5, device=d)]
    if program:
        ev += [_ev("user_annotation", "survey.fit", 0.5, 9.8),
               _ev("user_annotation", "survey.pack", 0.6, 1.6),
               _ev("user_annotation", "sampler.fetch", 8.5, 9.6),
               _ev("cpu_op", "aten::copy_", 8.7, 9.5),
               _ev("user_annotation", "survey.summary", 9.6, 9.8),
               _ev("user_annotation", "sampler.fetch", 12, 13)]
    return Trace(ev, "job", cards)


def _run(tr, timings=None):
    return types.SimpleNamespace(
        traced=tr, jobs=types.SimpleNamespace(timings=timings or []))


def test_span_shares_clip_to_the_job():
    tr = _trace()
    assert spans.span_pct(tr, "survey.pack") == pytest.approx(10.0)
    assert spans.span_pct(tr, "survey.summary") == pytest.approx(2.0)
    # the fetch outside the job is not counted
    assert spans.span_pct(tr, "sampler.fetch") == pytest.approx(11.0)
    assert spans.span_pct(tr, "survey.init") is None
    assert spans.span_pct(None, "survey.pack") is None


@pytest.mark.parametrize("cards", [1, 2])
def test_idle_outside_spans_counts_only_unnamed_gaps(cards):
    tr = _trace(cards=cards)
    # idle 0-0.1, 0.3-2, 4-6 and 8.5-10 ms (5.3 of 10); program spans
    # over 0.5-9.8: unnamed 0-0.1, 0.3-0.5 and 9.8-10 ms, 0.5 ms of 10
    assert 100 * tr.idle_share(0) == pytest.approx(53.0)
    assert spans.idle_outside_spans_pct(tr) == pytest.approx(5.0)
    read = manifest.reader("survey.idle_outside_spans_pct")
    assert read(_run(tr)) == pytest.approx(5.0)


def test_program_spans_name_the_idle_gaps():
    """The harness names each gap after the host at its middle: the
    program's innermost span, or the benchmark's ``job`` alone."""
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({
        "job": 0.1e-3, "survey.pack": 1.7e-3, "survey.fit": 2e-3,
        "sampler.fetch > aten::copy_": 1.5e-3})
    assert dict(_trace(program=False).idle_gaps()).keys() == {"job"}


def test_a_program_without_spans_reads_none():
    tr = _trace(program=False)
    # an older program's survey timings: the sampling and the start alone
    old = [{"setup_s": 1.0, "sampling_s": 3.0, "wall_s": 5.0}]
    for name in ("survey_pack_pct", "survey_init_pct", "survey_summary_pct",
                 "fetch_pct", "survey.fetch_pct", "idle_outside_spans_pct"):
        assert manifest.reader(name)(_run(tr, old)) is None, name


def test_host_span_shares_read_the_jobs_timings():
    """The survey's host spans are read over the window's jobs, from the
    seconds the program's timings keep, against the jobs' wall time: the
    same jobs ``survey_host_pct`` reads, so their sum stays under it."""
    t = [{"setup_s": 0.4, "pack_s": 0.2, "init_s": 0.05, "sampling_s": 3.6,
          "summary_s": 0.8, "wall_s": 5.0},
         {"setup_s": 0.6, "pack_s": 0.4, "init_s": 0.05, "sampling_s": 3.6,
          "summary_s": 0.6, "wall_s": 5.0}]
    run = _run(None, t)
    got = {n: manifest.reader(n)(run) for n in (
        "survey_pack_pct", "survey_init_pct", "survey_summary_pct",
        "survey_host_pct")}
    assert got == pytest.approx({"survey_pack_pct": 6.0,
                                 "survey_init_pct": 1.0,
                                 "survey_summary_pct": 14.0,
                                 "survey_host_pct": 28.0})
    # a job without the span's seconds reads nothing
    assert spans.timings_pct(_run(None, t + [{"wall_s": 5.0}]),
                             "pack_s") is None


def test_counter_ratios(monkeypatch):
    import joxsz_torch.utils.timing as timing

    c = {"steps.burn": 4000, "steps.sample": 8000,
         "tier2_pairs.burn": 600, "tier2_pairs.sample": 600,
         "f64_pairs.burn": 30, "f64_pairs.sample": 10}
    monkeypatch.setattr(timing, "counters", lambda: dict(c))
    run = _run(None)
    assert manifest.reader("tier2_pairs_per_kstep")(run) == \
        pytest.approx(100.0)
    assert manifest.reader("survey.tier2_pairs_per_kstep")(run) == \
        pytest.approx(100.0)
    assert manifest.reader("survey_burn_f64_pct")(run) == pytest.approx(75.0)
    # a tempered phase counts as sample only
    c = {"steps.sample": 8000, "tier2_pairs.sample": 40,
         "f64_pairs.sample": 0}
    assert manifest.reader("tier2_pairs_per_kstep")(run) == \
        pytest.approx(5.0)
    assert manifest.reader("survey_burn_f64_pct")(run) is None
    c = {}
    assert manifest.reader("tier2_pairs_per_kstep")(run) is None


def test_a_program_without_counters_reads_none(monkeypatch):
    import joxsz_torch.utils.timing as timing

    monkeypatch.delattr(timing, "counters")
    for name in ("tier2_pairs_per_kstep", "survey_burn_f64_pct"):
        assert manifest.reader(name)(_run(None)) is None
