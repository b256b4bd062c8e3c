"""Effective samples of the cold rung over the window's wall time:
W x steps / tau, tau the largest integrated autocorrelation time (in
steps) over the parameters, from all of the window's cold frames."""


def read(run):
    tau = run.tau_steps()
    if tau is None:
        return None
    return run.jobs.W * run.steps / tau / run.window_s
