"""Share of a survey job's wall time spent outside the program's own
``timings['sampling_s']`` (constants packing, the walkers' start, the
summary), over every job of the window."""


def read(run):
    t = getattr(run.jobs, "timings", None)
    if not t:
        return None
    wall = sum(j["wall_s"] for j in t)
    return 100.0 * (wall - sum(j["sampling_s"] for j in t)) / wall
