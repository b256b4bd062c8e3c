"""Mass-veto pairs that reached tier 2 (tier 1 not sure of them) per
1000 sampler steps, over the traced jobs: the program's counters
``tier2_pairs.<phase>`` over ``steps.<phase>``, every phase."""

from benchmark.harness.spans import counters, per_phase


def read(run):
    c = counters()
    if c is None:
        return None
    steps = sum(per_phase(c, "steps").values())
    pairs = per_phase(c, "tier2_pairs")
    return 1000.0 * sum(pairs.values()) / steps if steps and pairs else None
