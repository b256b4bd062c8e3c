"""Utilities: wall-clock spans, throughput meters and profiler hooks
(``timing``)."""
