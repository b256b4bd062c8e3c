"""Share of the window's survey jobs' wall time under the program's span
``survey.init`` (``batched_init``: the walkers' start, their first
log-posteriors and the synchronise; the timings' ``init_s``), in %."""

from benchmark.harness.spans import timings_pct


def read(run):
    return timings_pct(run, "init_s")
