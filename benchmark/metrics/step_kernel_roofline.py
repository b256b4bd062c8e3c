"""The step kernel's least time (``roofline.launch_least_seconds`` of
every launch of the traced job: the evaluations' operations, the
projection at the TF32 rate) over its device time, in %."""

from benchmark import roofline


def read(run):
    tr = run.traced
    if tr is None:
        return None
    busy = sum(b - a for d in tr.kernels for _, a, b in tr.step_launches(d))
    n_dev = len(tr.kernels)
    rows = run.jobs.evals_per_step // n_dev
    least = n_dev * sum(roofline.launch_least_seconds(run.shapes, rows * n,
                                                      rows)
                        for n in run.jobs.launch_steps)
    return 100.0 * least / busy
