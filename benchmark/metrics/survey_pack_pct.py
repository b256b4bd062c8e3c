"""Share of the window's survey jobs' wall time under the program's span
``survey.pack`` (``pack_consts_stack``: every cluster's kernel
constants; its seconds are the timings' ``pack_s``), in %."""

from benchmark.harness.spans import timings_pct


def read(run):
    return timings_pct(run, "pack_s")
