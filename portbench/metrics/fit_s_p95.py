"""End to end: the 95th percentile (nearest rank) of the wall time of every
job in the window, from the call until its answer sits on the host."""

from portbench.window import fit_s_p95


def read(window):
    return fit_s_p95(window.jobs) if window.jobs else None
