"""Share of the traced job's span with no kernel on the card; on several
cards the mean over them."""


def read(run):
    tr = run.traced
    if tr is None:
        return None
    return 100.0 * sum(tr.idle_share(d) for d in tr.kernels) / len(tr.kernels)
