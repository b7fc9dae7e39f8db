"""Fit loop: the steps the program says it issued in the window's jobs
(``recent_fits()``'s ``steps``, replicas counted apart) over the steps the
jobs asked for (``niter + 1`` a fit), in %: a fit that skips steps reads
under 100."""

from portbench.program_trace import fit_records


def read(trace):
    records = fit_records(trace)
    if records is None or not trace.steps:
        return None
    return 100.0 * sum(r.get("steps", 0) for r in records) / trace.steps
