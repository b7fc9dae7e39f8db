"""Fitter API: a fit call's fixed cost, the mean over the traced window's
``gsmvi.fit`` spans of the span's wall less that of the ``gsmvi.fit.loop``
spans inside it, in ms (host clock of the profiler)."""

from portbench.program_trace import spans


def read(trace):
    program = spans(trace)
    fits = [r for r in program if r[0] == "gsmvi.fit"]
    if not fits:
        return None
    loops = [r for r in program if r[0] == "gsmvi.fit.loop"]
    fixed = 0.0
    for _, s, e in fits:
        fixed += (e - s) - sum(le - ls for _, ls, le in loops
                               if ls >= s and le <= e)
    return fixed / len(fits) * 1e-3
