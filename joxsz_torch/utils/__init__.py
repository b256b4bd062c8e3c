"""Utilities: wall-clock spans, throughput meters and profiler hooks
(``timing``)."""

from .timing import Timer, Throughput, trace_annotation, profile_to

__all__ = ["Timer", "Throughput", "trace_annotation", "profile_to"]
