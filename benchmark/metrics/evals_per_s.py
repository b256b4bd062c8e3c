"""Log-posterior evaluations the sampler made in the window over the
window's wall time (host clock): K x W x steps a tempered phase, C x W x
(burn + steps) a survey."""


def read(run):
    return run.evals / run.window_s
