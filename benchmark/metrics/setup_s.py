"""Process start to the first timed step (host clock): imports, the
data, the session, the kernels' build where the checkout has none, the
start and the warm-up."""


def read(run):
    return run.setup_s
