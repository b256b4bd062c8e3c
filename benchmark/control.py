"""The readings that set a cell's limits (``limits/<cell>.json``): for
each seed, a run of the cell with a short window (one job), the numbers
compared for the program and, at the same rows, for the control, the
reference in TF32 (float32 products with TF32 inputs) put in the
program's place.  All seeds run in one process.  The benchmark's own
runs never run the control.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 0] [--out readings.jsonl]"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, seconds: float = 0.0, device=None,
             overrides=None, trace: bool = False) -> list[dict]:
    from benchmark.harness.cell import run_cell

    out = []
    for seed in seeds:
        res, compared = run_cell(workload, seed, seconds, trace,
                                 time.perf_counter(), device=device,
                                 overrides=overrides, control=True)
        row = {"seed": seed, "correct": res["correct"],
               "program": {k: v["value"] for k, v in compared.items()},
               "accepted": {k: res["program"][k] for k in
                            ("move_acc", "swap_acc") if k in res["program"]},
               "control": res["control"], "rows": res["control"]["rows"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--override", type=json.loads, default=None)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.seconds,
                    overrides=args.override, trace=bool(args.trace))
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    prog = max(r["program"]["lp_gap"] for r in rows)
    ctrl = min(r["control"]["lp_gap"] for r in rows)
    print(f"lp_gap: program's largest {prog!r}, control's smallest "
          f"{ctrl!r} ({ctrl / prog:.2f}x) over {len(rows)} seeds")
    for k in ("move_acc_z", "swap_acc_z"):
        if k in rows[0]["program"]:
            print(f"{k}: program's largest "
                  f"{max(r['program'][k] for r in rows)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
