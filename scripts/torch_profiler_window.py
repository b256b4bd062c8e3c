"""Where torch.profiler loses a kernel's device time, on the card.

One profiler session around one launch of a spinning kernel
(``torch.cuda._sleep``, ~``--ms`` milliseconds), ``torch.cuda.
synchronize()`` and a host marker, repeated: first ``--burst`` sessions
back to back, then one every ``--every`` seconds for ``--minutes``.  Each
session is made three times: with the capture window closed right after
the synchronisation (``pad`` none), held open ``--pad`` seconds longer
(``end``), and also opened ``--pad`` seconds before the launch
(``both``).  For every session it prints whether the kernel was recorded
and, where it was, on the profiler's own timeline:

  * ``lead``: the kernel's start less its launch's (host marker) start:
    a kernel cannot start before its launch, so a negative lead is the
    device clock running behind the host's;
  * ``tail``: the host marker after the synchronisation less the
    kernel's end: the synchronisation returns after the kernel ends, so a
    negative tail is the device clock running ahead of the host's.

A kernel that lies partly outside the capture window is dropped from the
trace, and the window opens and closes microseconds from the launch and
the synchronisation: a device clock ahead of the host's by more than that
gap loses the last kernel of a window, one behind it the first.

    python scripts/torch_profiler_window.py [--ms 40] [--pad 0.05]
        [--burst 40] [--every 20] [--minutes 4]
    python scripts/torch_profiler_window.py --cumulative 400 \
        [--launches 1000]

``--cumulative N`` asks instead whether the profiler stops recording
after many sessions: N sessions of ``--launches`` short spins each,
every tenth session also one ``--ms`` spin alone, printing each session
that recorded fewer kernels than it launched, with the launches profiled
before it, and a count at the end.

``--reserve GB`` asks whether it stops recording when the card's memory
is held by PyTorch's caching allocator: one ``--ms`` spin a session, ten
sessions each with nothing reserved, with GB reserved (allocated and
freed to the cache), and again after ``torch.cuda.empty_cache()``.

    python scripts/torch_profiler_window.py --reserve 78
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


def one_session(cycles: int, pad: str, pad_s: float) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad == "both":
            time.sleep(pad_s)
        with record_function("probe_launch"):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        with record_function("probe_synced"):
            pass
        if pad != "none":
            time.sleep(pad_s)
    ev = prof.events()
    # the device's events: the kernel, and the annotation that the
    # profiler puts on the device's timeline for a marker around launches
    kern = [e for e in ev if e.device_type == DeviceType.CUDA
            and not e.name.startswith("probe_")]
    mark = {e.name: e for e in ev if e.device_type == DeviceType.CPU
            and e.name.startswith("probe_")}
    out = {"pad": pad, "recorded": bool(kern)}
    if kern:
        k = max(kern, key=lambda e: e.time_range.end)
        out.update(
            kernel_us=k.time_range.end - k.time_range.start,
            lead_us=k.time_range.start
            - mark["probe_launch"].time_range.start,
            tail_us=mark["probe_synced"].time_range.start
            - k.time_range.end)
    return out


def count_session(cycles: int, n: int) -> int:
    """Kernels one session recorded of ``n`` spins of ``cycles`` each."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("probe_"))


def cumulative(n_sessions: int, n_launches: int, long_cycles: int,
               card: str) -> None:
    done, short, long_ = 0, [], []
    for i in range(n_sessions):
        got = count_session(2000, n_launches)
        if got < n_launches:
            short.append(i)
            print(json.dumps({"session": i, "launches": n_launches,
                              "recorded": got, "profiled_before": done}),
                  flush=True)
        done += n_launches
        if i % 10 == 9:
            got = count_session(long_cycles, 1)
            if got < 1:
                long_.append(i)
                print(json.dumps({"session": i, "long_spin": True,
                                  "recorded": got,
                                  "profiled_before": done}), flush=True)
            done += 1
    print(f"cumulative: {len(short)} of {n_sessions} sessions of "
          f"{n_launches} short spins recorded fewer kernels (first at "
          f"{short[0] if short else None}), {len(long_)} of "
          f"{n_sessions // 10} long spins none; {done} launches profiled "
          f"on {card}", flush=True)


def reserve(gb: float, cycles: int, card: str) -> None:
    def ten(tag):
        got = [count_session(cycles, 1) for _ in range(10)]
        print(f"reserve: {tag}: {sum(got)} of 10 sessions recorded the "
              f"kernel; {torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB "
              f"reserved, {torch.cuda.mem_get_info()[0] / 2 ** 30:.1f} GiB "
              f"free on {card}", flush=True)

    ten("nothing held")
    blocks = []
    try:
        while torch.cuda.memory_reserved() < gb * 2 ** 30:
            blocks.append(torch.empty(2 ** 28, dtype=torch.uint8,
                                      device="cuda"))
    except torch.cuda.OutOfMemoryError:
        pass
    del blocks
    ten(f"{gb} GiB asked of the caching allocator, then freed to it")
    torch.cuda.empty_cache()
    ten("after empty_cache()")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", type=float, default=40.0)
    ap.add_argument("--pad", type=float, default=0.05)
    ap.add_argument("--burst", type=int, default=40)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--minutes", type=float, default=4.0)
    ap.add_argument("--cumulative", type=int, metavar="N")
    ap.add_argument("--launches", type=int, default=1000)
    ap.add_argument("--reserve", type=float, metavar="GB")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profiler_window: no CUDA device visible",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    # the spin kernel counts SM clock cycles (~1.98 GHz at boost)
    cycles = int(args.ms * 1.98e6)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    if args.cumulative:
        cumulative(args.cumulative, args.launches, cycles, card)
        return 0
    if args.reserve:
        reserve(args.reserve, cycles, card)
        return 0
    t_start = time.perf_counter()
    rows = []

    pads = ("none", "end", "both")

    def record(phase: str, i: int):
        for pad in pads:
            r = one_session(cycles, pad, args.pad)
            r.update(phase=phase, i=i,
                     age_s=round(time.perf_counter() - t_start, 1))
            rows.append(r)
            print(json.dumps(r), flush=True)

    for i in range(args.burst):
        record("burst", i)
    i = 0
    while time.perf_counter() - t_start < 60.0 * args.minutes:
        time.sleep(args.every)
        record("spaced", i)
        i += 1
    for pad in pads:
        sel = [r for r in rows if r["pad"] == pad]
        ok = [r for r in sel if r["recorded"]]
        span = {k: (f"{min(r[k] for r in ok):.1f} .. "
                    f"{max(r[k] for r in ok):.1f} us" if ok else "n/a")
                for k in ("lead_us", "tail_us")}
        print(f"pad {pad} ({args.pad} s): {len(ok)} of {len(sel)} sessions "
              f"recorded the kernel; lead {span['lead_us']}, tail "
              f"{span['tail_us']} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
