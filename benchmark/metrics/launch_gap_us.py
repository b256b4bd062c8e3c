"""Median idle gap between consecutive step-kernel launches on the
device timeline of the traced job (every card)."""

from benchmark.harness.trace import median


def read(run):
    tr = run.traced
    if tr is None:
        return None
    m = median(tr.launch_gaps())
    return None if m is None else 1e6 * m
