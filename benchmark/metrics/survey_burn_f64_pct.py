"""Share of the traced survey jobs' float64-tier mass-veto pairs that
the burn decided, in %: the program's counters ``f64_pairs.burn`` over
``f64_pairs.burn`` + ``f64_pairs.sample``."""

from benchmark.harness.spans import counters, per_phase


def read(run):
    c = counters()
    if c is None:
        return None
    f64 = per_phase(c, "f64_pairs")
    total = sum(f64.values())
    return 100.0 * f64.get("burn", 0) / total if total else None
