"""Step loop: CUDA graphs captured and chunk runners built per job of the
traced window, from the program's counters (``recent_fits()``); the warm-up
fit of the cell's own shapes builds what a job needs, so a steady window
reads 0."""

from portbench.program_trace import fit_records


def read(trace):
    records = fit_records(trace)
    if records is None:
        return None
    return sum(r.get("graph_captures", 0) + r.get("runner_builds", 0)
               for r in records) / trace.jobs
