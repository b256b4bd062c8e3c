"""Share of the window's survey jobs' wall time under the program's span
``survey.summary`` (``fit_survey``'s transpose of the chain, its medians
and standard deviations; the timings' ``summary_s``), in %."""

from benchmark.harness.spans import timings_pct


def read(run):
    return timings_pct(run, "summary_s")
