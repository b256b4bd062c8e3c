"""The program's spans and counters, and its profiler hook.

* ``trace_annotation(name, timed=False)`` — the program's one span.  With
  no torch profiler recording it reads one attribute (the profiler's
  flag) and enters a shared null context; asked for the time
  (``timed=True``) it also reads ``time.perf_counter`` twice and leaves
  the seconds in the span's ``seconds``.  While a profiler records, it
  opens ``torch.profiler.record_function(name)``, so the span lands in
  the profiler's trace on the kernels' timeline, nested in the spans
  that contain it.
* ``count(name, n)`` adds ``n`` to a process-wide counter, only while a
  profiler records; ``counters()`` reads them, ``reset_counters()``
  clears them.  ``recording()`` says whether a profiler records, for
  callers whose counts cost a device read.
* ``profile_to(logdir)`` — context manager around
  ``torch.profiler.profile`` (the CPU, and the card where one is
  visible) writing a Chrome trace (``trace.json``, open in
  chrome://tracing or Perfetto) into a directory; the program's spans
  appear in it.  The JAX package's writes a TensorBoard / xprof profile.

Host clocks do not wait for the card: a span's seconds cover device work
only where the span ends in a synchronise (a copy to the host does).

Spans (``PERF.md`` §3 names the metric that reads each): ``survey.fit``
(``survey.fit_survey``) holds ``survey.start`` (``survey.pack``, the
clusters' constants, and ``survey.init``, the walkers' start and their
log-posteriors), ``survey.burn``, ``survey.sample``, ``survey.summary``
(the medians and sds) and ``sampler.fetch``; the kernel sampler's
phases (``sampling.kernel``) ``sampler.lp0``, ``sampler.steps`` and
``sampler.fetch``.  Counters, by phase (``burn`` or ``sample``):
``steps.<phase>``, ``f64_pairs.<phase>`` and ``tier2_pairs.<phase>``
(the mass veto's pairs past tier 1 and those that reached float64);
``survey.summary_on_device``, one a kernel-route fit
(``sampling.kernel.fit_multicluster_kernel``), whose summary is taken
from the chain on the sampler's device, before the fetch.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch
import torch.autograd.profiler as _prof


class _Null:
    """The span of an untimed region with no profiler recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """A region timed on the host clock, a ``record_function`` too while
    a profiler records (the timed interval inside it)."""

    __slots__ = ("_rf", "_timed", "_t0", "seconds")

    def __init__(self, rf, timed: bool):
        self._rf, self._timed = rf, timed
        self.seconds = 0.0

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        if self._timed:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._timed:
            self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def trace_annotation(name: str, timed: bool = False):
    """The program's span ``name`` (module docstring); ``with
    trace_annotation(name, timed=True) as s`` leaves the region's
    ``perf_counter`` seconds in ``s.seconds``."""
    if not _prof._is_profiler_enabled:
        return _Span(None, True) if timed else _NULL
    return _Span(torch.profiler.record_function(name), timed)


_COUNTS: dict[str, int] = {}


def recording() -> bool:
    """Whether a torch profiler records in this process."""
    return _prof._is_profiler_enabled


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _prof._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> dict:
    """The counters counted so far (a copy)."""
    return dict(_COUNTS)


def reset_counters():
    _COUNTS.clear()


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the block (CPU, and CUDA where a card is visible) and
    write its Chrome trace to ``<logdir>/trace.json``; yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
