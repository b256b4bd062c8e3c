"""Device time of the step kernel in the traced job per sampler step
(every card's launches, summed)."""


def read(run):
    tr = run.traced
    if tr is None:
        return None
    busy = sum(b - a for d in tr.kernels for _, a, b in tr.step_launches(d))
    return 1e6 * busy / sum(run.jobs.launch_steps)
