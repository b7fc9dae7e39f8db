"""Fitter API: the card's idle time while the host was in the fitter's
public call outside its loop (the innermost program span ``gsmvi.fit``,
``gsmvi.fit.setup`` or ``gsmvi.fit.finish``: range gates, the score probe,
the initial state, the runner's lookup, the answer's conversion), over the
traced window's wall, in %."""

from portbench.program_trace import FITTER_API, idle_pct


def read(trace):
    return idle_pct(trace, FITTER_API)
