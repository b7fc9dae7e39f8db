"""End to end: all fit steps completed in the window, replicas counted apart,
over the window's seconds (host clock, first job's start to last job's end:
every job's fixed cost and every pause between jobs inside)."""

from portbench.window import steps_per_s


def read(window):
    return steps_per_s(window.jobs) if window.jobs else None
