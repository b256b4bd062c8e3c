"""Share of the traced job with the card idle and no program span open
(the mean over the cards), in %: the device's idle time that the
program's spans do not name."""

from benchmark.harness.spans import idle_outside_spans_pct


def read(run):
    return idle_outside_spans_pct(run.traced)
