"""Share of the traced job under the program's span ``sampler.fetch``
(the chain, its log-posteriors and the acceptance copied to the host),
in %."""

from benchmark.harness.spans import span_pct


def read(run):
    return span_pct(run.traced, "sampler.fetch")
