"""Utilities: the program's spans and counters and the profiler hook
(``timing``)."""

from .timing import (count, counters, profile_to, recording,
                     reset_counters, trace_annotation)

__all__ = ["trace_annotation", "count", "counters", "reset_counters",
           "recording", "profile_to"]
