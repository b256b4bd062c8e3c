"""The benchmark of joxsz_torch, the PyTorch and CUDA port of JoXSZ, on
the card.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run seconds> --trace <0|1>

Runs the cell of ``BENCHMARK.json``: set-up (data made from the seed by
the benchmark's own float64 model, the program's session, the kernels
built once into ``build/`` inside the checkout and warmed), then jobs
back to back for ``--seconds``, then the check of what the window
produced against the reference.  Prints the numbers compared beside
their limits on standard error and, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(end-to-end untraced, per-layer with ``--trace 1``), ``device`` and,
traced, ``breakdown``; ``compared`` last.  Exits non-zero, printing no
result, without the cards the cell asks for or when JAX or the JAX
package is loaded."""

import time

T_START = time.perf_counter()
try:
    # the process's own start: /proc/self/stat's start time against the
    # uptime, both in seconds since boot
    import os as _os

    with open("/proc/self/stat") as _f:
        _ticks = float(_f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as _f:
        _up = float(_f.read().split()[0])
    T_START -= max(_up - _ticks / _os.sysconf("SC_CLK_TCK"), 0.0)
except (OSError, ValueError, IndexError):
    pass

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the program builds its kernels into build/ in the checkout; torch's own
# extension and Triton caches, should anything use them, go there too
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.cell import NoDevice, loaded_forbidden, run_cell

    try:
        out, compared = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), T_START)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
