"""Timing / profiling utilities (the reference has none).

Torch counterpart of ``joxsz_tpu/utils/timing.py``:

* ``Timer`` — wall-clock context manager accumulating named spans;
* ``Throughput`` — likelihood-evaluations-per-second meter;
* ``trace_annotation`` — ``torch.profiler.record_function``, so hot
  regions show up named in a profile;
* ``profile_to`` — context manager around ``torch.profiler.profile`` (the
  CPU, and the card where one is visible) writing a Chrome trace
  (``trace.json``, open in chrome://tracing or Perfetto) into a
  directory.  The JAX package's writes a TensorBoard / xprof profile.

Host clocks do not wait for the card: synchronise inside a span that
times device work.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict


class Timer:
    def __init__(self):
        self.spans: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": v, "calls": self.counts[k]}
                for k, v in sorted(self.spans.items())}


class Throughput:
    """Accumulates (evals, seconds) pairs; reports evals/sec."""

    def __init__(self):
        self.evals = 0
        self.seconds = 0.0

    def add(self, n_evals: int, seconds: float):
        self.evals += n_evals
        self.seconds += seconds

    @property
    def evals_per_s(self) -> float:
        return self.evals / self.seconds if self.seconds > 0 else float("nan")


def trace_annotation(name: str):
    """Named region for profiles (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the block (CPU, and CUDA where a card is visible) and
    write its Chrome trace to ``<logdir>/trace.json``; yields the
    ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
