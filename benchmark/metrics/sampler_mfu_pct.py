"""The whole sampler's share of the cards' peak over the window: the
least time of the window's evaluations (``roofline.eval_seconds``: the
projection at the TF32 rate, the rest at the float32 rate) over the
window's wall time times the cards, in %."""

from benchmark import roofline


def read(run):
    least = run.evals * roofline.eval_seconds(run.shapes)
    return 100.0 * least / (run.window_s * run.chips)
