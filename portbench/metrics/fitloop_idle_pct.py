"""Fit loop: the card's idle time while the host was in the fit loop
outside a kernel call (the innermost program span ``gsmvi.fit.loop`` or a
block's draws, report read, stiff replay or resample attempt), over the
traced window's wall, in %."""

from portbench.program_trace import FIT_LOOP, idle_pct


def read(trace):
    return idle_pct(trace, FIT_LOOP)
