"""Mass-veto pairs the step kernel's float64 tier decided in the window
(the program's counter ``ops.step_kernel.f64_pairs``, every card) per
1000 sampler steps."""


def read(run):
    if run.f64_pairs is None:
        return None
    return 1000.0 * run.f64_pairs / run.steps
