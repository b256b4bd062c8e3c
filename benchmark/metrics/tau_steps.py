"""The cold rung's integrated autocorrelation time over the window, in
sampler steps: the largest over the parameters (``harness.autocorr``)."""


def read(run):
    return run.tau_steps()
