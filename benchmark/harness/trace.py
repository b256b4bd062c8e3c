"""The traced sub-window: ``torch.profiler`` over whole jobs, reduced to
the device timeline of every card.

The profiler drops a kernel whose span it places outside its capture
window, and places the card's timestamps off the host's by a different
amount in each session (up to a few ms); some sessions record no kernel
at all, most after the card sat idle.  So a session stays open
``PAD_S`` around its job, and a session that did not record every launch
of the step kernel the job made is made again on the next job with the
window held open 4x longer, up to ``TRIES`` sessions."""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

PAD_S, TRIES = 0.02, 5
STEP_KERNEL = "stretch_steps"        # every instance of the step kernel


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """One recorded job: ``kernels[d]`` (name, start, end) in seconds on
    card d, the host events (cat, name, start, end), and the job's span."""

    def __init__(self, events: list, span: str, n_dev: int):
        self.kernels = {d: [] for d in range(n_dev)}
        self.host = []
        self.span = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat == "kernel":
                d = int(e.get("args", {}).get("device", 0))
                self.kernels.setdefault(d, []).append((e["name"], a, b))
            elif cat in ("cpu_op", "user_annotation"):
                self.host.append((cat, e["name"], a, b))
                if cat == "user_annotation" and e["name"] == span:
                    self.span = (a, b)
        for k in self.kernels.values():
            k.sort(key=lambda t: t[1])

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def busy_s(self, d: int) -> float:
        return min(_union((a, b) for _, a, b in self.kernels[d]),
                   self.window_s)

    def idle_share(self, d: int) -> float:
        return 1.0 - self.busy_s(d) / self.window_s

    def step_launches(self, d: int) -> list:
        return [k for k in self.kernels[d] if k[0].startswith(STEP_KERNEL)]

    def launch_gaps(self) -> list:
        """Idle seconds between consecutive step-kernel launches, every
        card."""
        out = []
        for d in self.kernels:
            s = self.step_launches(d)
            out += [max(b[1] - a[2], 0.0) for a, b in zip(s, s[1:])]
        return out

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost recorded host
        event over it, under the innermost benchmark span."""
        over = [h for h in self.host if h[2] <= t <= h[3]]
        if not over:
            return "host: no recorded event"
        spans = [h for h in over if h[0] == "user_annotation"]
        inner = max(over, key=lambda h: h[2])
        outer = max(spans, key=lambda h: h[2])[1] if spans else ""
        return inner[1] if inner[1] == outer or not outer \
            else f"{outer} > {inner[1]}"

    def idle_gaps(self) -> list:
        """(host activity, seconds) of every idle stretch of every card
        inside the job's span."""
        out = []
        for d, ks in self.kernels.items():
            t = self.span[0]
            for _, a, b in ks + [("end", self.span[1], self.span[1])]:
                if a > t:
                    out.append((f"card {d}: " + self._host_at(0.5 * (a + t))
                                if len(self.kernels) > 1
                                else self._host_at(0.5 * (a + t)), a - t))
                t = max(t, b)
        return out

    def breakdown(self) -> dict:
        ops = {}
        for ks in self.kernels.values():
            for name, a, b in ks:
                ops[name[:160]] = ops.get(name[:160], 0.0) + (b - a)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """Profiles whole jobs until one session records every step-kernel
    launch the job made on every card."""

    def __init__(self, devices, launches_per_job: int, workdir):
        self.devices = devices
        self.want = launches_per_job
        self.path = os.path.join(workdir, "trace.json")
        self.tries = 0
        # the wall time a traced job spends outside its own work (the
        # pads, the profiler's start and stop, the trace's export)
        self.overhead_s = 0.0
        self.result: Trace | None = None

    @property
    def pending(self) -> bool:
        return self.result is None and self.tries < TRIES

    def job(self, fn, span: str):
        from torch.profiler import ProfilerActivity, profile, record_function

        pad = PAD_S * 4 ** self.tries
        self.tries += 1
        t_call = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            with record_function(span):
                t_job = time.perf_counter()
                fn()
                for d in self.devices:
                    torch.cuda.synchronize(d)
                t_job = time.perf_counter() - t_job
            time.sleep(pad)
        prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self.overhead_s += time.perf_counter() - t_call - t_job
        tr = Trace(events, span, len(self.devices))
        if tr.span is not None and all(
                len(tr.step_launches(d)) == self.want
                for d in range(len(self.devices))):
            self.result = tr
        else:
            print(f"trace: session {self.tries} recorded "
                  f"{[len(tr.step_launches(d)) for d in tr.kernels]} of "
                  f"{self.want} step launches a card; the next job is "
                  f"traced with the window open {4 * pad:.2f} s around it",
                  file=sys.stderr)


def median(values) -> float | None:
    return statistics.median(values) if values else None
