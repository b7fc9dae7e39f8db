"""The closed-loop window's arithmetic: the rate over the whole window and
the tail over every job."""

from __future__ import annotations

import math


def steps_per_s(jobs) -> float:
    """All fit steps the window's jobs completed over the window's seconds.
    ``jobs`` are (start, end, steps) on one clock; the window runs from the
    first job's start to the last job's end, so it holds every step and
    every pause between jobs."""
    start = min(j[0] for j in jobs)
    end = max(j[1] for j in jobs)
    return sum(j[2] for j in jobs) / (end - start)


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def fit_s_p95(jobs) -> float:
    """95th percentile of the wall time of every job."""
    return percentile([j[1] - j[0] for j in jobs], 95.0)


class Window:
    """What an end-to-end reader (``metrics/<metric>.py``, ``read(window)``)
    reads: the jobs as (start, end, steps) on the host clock, and the
    seconds of set-up before the first."""

    def __init__(self, jobs, setup_s: float):
        self.jobs = list(jobs)
        self.setup_s = float(setup_s)
