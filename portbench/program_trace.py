"""The program's own spans and counters in the traced window.

The port opens host spans named ``gsmvi.*`` while a profiler records
(``gsmvi_tpu_torch/utils/profiling.py``): ``gsmvi.fit`` once per public fit
call with ``.setup``, ``.loop`` and ``.finish`` inside, and in the loop the
block spans.  They are host records of the same profile as the device's
activity, so each idle gap between the device's merged intervals (the gaps
``trace.breakdown`` sums) is split exactly among the innermost ``gsmvi.``
spans open over it.  The port also keeps its recent fit calls' counters
(``recent_fits()``); the window's jobs are the newest ``trace.jobs`` of
them.  A program without these gives None, and a reader then leaves its
metric out.
"""

from __future__ import annotations

from portbench.trace import merged

PREFIX = "gsmvi."

# The program's layers, by the spans that belong to each.
FITTER_API = ("gsmvi.fit", "gsmvi.fit.setup", "gsmvi.fit.finish")
FIT_LOOP = ("gsmvi.fit.loop", "gsmvi.block.draw", "gsmvi.block.report",
            "gsmvi.block.replay", "gsmvi.block.retry")
STEP_LOOP = ("gsmvi.block.launch", "gsmvi.graph.capture")


def spans(trace) -> list:
    """The program's host spans, (name, start, end) in microseconds."""
    return [r for r in trace.host if r[0].startswith(PREFIX)]


def innermost(records) -> list:
    """Sorted disjoint (start, end, name): at each instant some record
    covers, the innermost of those open (records nest, as spans on one
    thread do)."""
    out, stack, t = [], [], None
    for name, s, e in sorted(records, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle_by_span(trace):
    """Seconds of the window's idle gaps under each innermost ``gsmvi.``
    span's name; the part under no such span under None.  None when the
    window holds no ``gsmvi.fit`` span."""
    program = spans(trace)
    if not any(r[0] == "gsmvi.fit" for r in program):
        return None
    busy = merged(trace.device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    segs = innermost(program)
    out = {None: 0.0}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < g1:
            lo, hi = max(g0, segs[k][0]), min(g1, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (hi - lo) * 1e-6
                covered += hi - lo
            k += 1
        out[None] += (g1 - g0 - covered) * 1e-6
    return out


def idle_pct(trace, names):
    """The idle gaps' seconds under the spans ``names`` over the window's
    seconds, in %; None without the program's spans."""
    by_span = idle_by_span(trace)
    if by_span is None or trace.window_s <= 0:
        return None
    return 100.0 * sum(by_span.get(n, 0.0) for n in names) / trace.window_s


def fit_records(trace):
    """The program's counter records of the window's jobs: the newest
    ``trace.jobs`` of ``recent_fits()``, each ``{"fitter": ..., **counts}``;
    None where the program keeps no such record, or fewer than the jobs."""
    try:
        from gsmvi_tpu_torch.utils import profiling
    except ImportError:
        return None
    recent = getattr(profiling, "recent_fits", None)
    if recent is None or trace.jobs <= 0:
        return None
    records = recent()
    if len(records) < trace.jobs:
        return None
    return records[-trace.jobs:]
