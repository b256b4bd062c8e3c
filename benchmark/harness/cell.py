"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, and the result's line."""

from __future__ import annotations

import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, jobs, manifest
from .trace import Tracer

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "joxsz_tpu")


class NoDevice(SystemExit):
    pass


class Run:
    """What a metric's reader reads (``metrics/<name>.py::read(run)``)."""

    def __init__(self, cell, config, traffic, seed, seconds, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.chips = int(cell["chips"])
        self.evals = self.steps = self.n_jobs = 0
        self.setup_s = self.window_s = None
        self.f64_pairs = None
        self.tracer: Tracer | None = None
        self.jobs = None
        self.shapes = None           # the model's sizes (``roofline``)
        self._tau = None

    def count(self, evals: int, steps: int):
        self.evals += evals
        self.steps += steps
        self.n_jobs += 1

    @property
    def traced(self):
        """The recorded job's ``trace.Trace``, or None."""
        return self.tracer.result if self.tracer is not None else None

    def tau_steps(self) -> float | None:
        """The integrated autocorrelation time of the cold rung's
        ensemble mean over the window, in steps (the largest over the
        parameters); None where the traffic keeps no chain.  The mean
        over the walkers, not each slot's own series: the swap sweep
        hands a cold slot another walker's position, so a slot's series
        decorrelates at every accepted swap whether the ensemble has
        moved or not."""
        if self._tau is None and hasattr(self.jobs, "chain"):
            from .autocorr import integrated_time

            ch = torch.as_tensor(self.jobs.chain(), device=self.jobs.device)
            tau = float(integrated_time(
                ch.mean(dim=1, keepdim=True, dtype=torch.float64)).max())
            self._tau = tau * self.jobs.thin
            if ch.shape[0] < 50 * tau:
                print(f"note: {ch.shape[0]} frames hold fewer than 50 tau "
                      f"({tau:.1f} frames)", file=sys.stderr)
        return self._tau


def _devices_ok(chips: int):
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} visible")


def _sync(devs):
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _f64_pairs(devs, reset=False) -> int:
    from joxsz_torch.ops.step_kernel import f64_pairs

    total = 0
    for d in devs:
        with torch.cuda.device(d):
            total += f64_pairs(reset=reset)
    return total


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str | None = None,
             overrides: dict | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """Run cell ``name`` and return ``(result line, numbers compared)``.
    ``device`` (tests only) skips the look for cards and runs the
    program's plain versions there; ``overrides`` update the traffic's
    numbers; ``control`` (``benchmark/control.py``) also reads the
    control at the same rows: the reference in TF32 in the program's
    place (``result["control"]``, beside the program's readings in
    ``result["program"]``)."""
    man = manifest.load()
    w = manifest.cell(man, name)
    config = manifest.config(man, w)
    traffic = dict(manifest.traffic(w), **(overrides or {}))
    limits = manifest.limits(w)
    if device is None:
        _devices_ok(int(w["chips"]))
        device = "cuda"
    run = Run(w, config, traffic, seed, seconds, trace)
    workdir = tempfile.mkdtemp(prefix="joxsz_bench_")
    try:
        run.jobs = tj = jobs.make(config, traffic, seed, workdir, device)
        on_card = tj.device.type == "cuda"
        tj.setup()
        _sync(tj.devices)
        if trace:
            run.tracer = Tracer(tj.devices, len(tj.launch_steps), workdir)
        if on_card:
            _f64_pairs(tj.devices, reset=True)
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        while run.n_jobs == 0 or time.perf_counter() - t0 < seconds:
            if run.tracer is not None and run.tracer.pending \
                    and run.n_jobs >= 1 and on_card:
                run.tracer.job(lambda: tj.job(run), "job")
            else:
                tj.job(run)
        _sync(tj.devices)
        run.window_s = time.perf_counter() - t0 - (
            run.tracer.overhead_s if run.tracer is not None else 0.0)
        run.f64_pairs = _f64_pairs(tj.devices) if on_card else None
        peak = (max(torch.cuda.max_memory_allocated(d) for d in tj.devices)
                if on_card else 0)
        tj.close()
        if on_card:
            torch.cuda.empty_cache()
        run.shapes = tj.shapes
        read = check.readings(tj, device)
        correct, compared = check.verdict(read, limits)
        ctrl = check.readings(tj, device, tf32=True) if control else None
        metrics = {}
        for m in manifest.metrics_of(man, w, trace):
            v = manifest.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
               "count": len(tj.devices), "memory_peak_bytes": int(peak)}
        # the check judges the window's jobs together: all fail or none
        out = {"correct": bool(correct), "attempted": run.n_jobs,
               "failed": int(not correct) * run.n_jobs, "metrics": metrics,
               "device": dev}
        if trace and run.traced is not None:
            tr = run.traced
            dev["busy_s"] = float(np.mean([tr.busy_s(d)
                                           for d in range(len(tj.devices))]))
            dev["window_s"] = tr.window_s
            out["breakdown"] = tr.breakdown()
        if ctrl is not None:
            out["program"] = read
            out["control"] = {"correct": check.verdict(ctrl, limits)[0],
                              **ctrl}
        print(f"set-up {run.setup_s:.2f} s ({tj.setup_parts}), window "
              f"{run.window_s:.2f} s, {run.n_jobs} jobs; checked "
              f"{read['rows']} rows; accepted [program, reference, its "
              f"standard error]: "
              f"moves {read['move_acc']}, swaps {read.get('swap_acc')}",
              file=sys.stderr)
        out["compared"] = compared
        return out, compared
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
