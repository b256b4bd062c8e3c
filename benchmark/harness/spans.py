"""The program's own spans and counters in a traced run.

``joxsz_torch`` names its work with gated spans (``joxsz_torch.utils.
timing.trace_annotation``: a ``record_function`` only while a profiler
records), so they land in the traced job's Chrome trace as
``user_annotation`` events beside the benchmark's ``job`` span; while a
profiler records it also counts, by phase, its sampler steps and the mass
veto's pairs (``counters()``).  The survey's spans of host work also
leave their seconds in its ``timings`` in every job (``timings_pct``),
so their shares are read over the window's jobs, as ``survey_host_pct``
reads ``sampling_s``, and not from the traced job, where the profiler's
cost on each small op weighs on them.  A program without them (an older
checkout) leaves these readers nothing: they return None."""

from __future__ import annotations

from .trace import _union

# the prefixes of the program's span names
PROGRAM = ("survey.", "sampler.")


def _clipped(tr, intervals) -> list:
    a0, b0 = tr.span
    return [(max(a, a0), min(b, b0)) for a, b in intervals
            if min(b, b0) > max(a, a0)]


def program_spans(tr, name: str | None = None) -> list:
    """(start, end) of the program's spans in the traced job (those
    called ``name``, or all of them), clipped to the job's span."""
    return _clipped(tr, [(a, b) for cat, n, a, b in tr.host
                         if cat == "user_annotation" and n.startswith(PROGRAM)
                         and (name is None or n == name)])


def span_pct(tr, name: str) -> float | None:
    """Share of the traced job's span under the program's span ``name``,
    in %; None where the trace holds no such span."""
    if tr is None:
        return None
    s = program_spans(tr, name)
    return 100.0 * _union(s) / tr.window_s if s else None


def idle_outside_spans_pct(tr) -> float | None:
    """Share of the traced job's span with the card idle and no program
    span open, in % (the mean over the cards): the idle time no program
    span names.  None where the trace holds no program span."""
    if tr is None:
        return None
    spans = program_spans(tr)
    if not spans:
        return None
    out = []
    for d, ks in tr.kernels.items():
        busy = _union(_clipped(tr, [(a, b) for _, a, b in ks]) + spans)
        out.append(1.0 - busy / tr.window_s)
    return 100.0 * sum(out) / len(out)


def timings_pct(run, key: str) -> float | None:
    """Share of the window's survey jobs' wall time (the benchmark's
    clock) under the program's span whose seconds its ``timings`` keep
    as ``key``, in %; None where a job's timings lack it."""
    t = getattr(run.jobs, "timings", None)
    if not t or any(key not in j for j in t):
        return None
    return 100.0 * sum(j[key] for j in t) / sum(j["wall_s"] for j in t)


def counters() -> dict | None:
    """The program's counters over every traced session of the run (each
    a whole job: ratios of them do not depend on how many sessions the
    trace took), or None where the program keeps none."""
    try:
        from joxsz_torch.utils.timing import counters as read
    except ImportError:
        return None
    c = read()
    return c or None


def per_phase(c: dict, what: str) -> dict:
    """{phase: count} of the counters ``<what>.<phase>``."""
    return {k.split(".", 1)[1]: v for k, v in c.items()
            if k.startswith(what + ".")}
