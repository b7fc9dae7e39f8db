"""Fit loop: the host's waits on the card per fit step, from the program's
counters of the window's jobs (``recent_fits()``): kernel reports read,
stiff steps replayed and resample attempts, over the steps issued."""

from portbench.program_trace import fit_records


def read(trace):
    records = fit_records(trace)
    if records is None:
        return None
    steps = sum(r.get("steps", 0) for r in records)
    if not steps:
        return None
    waits = sum(r.get(k, 0) for r in records
                for k in ("report_reads", "replays", "retries"))
    return waits / steps
