"""Step loop: the card's idle time while the host was issuing a kernel call
(the innermost program span ``gsmvi.block.launch``: copies in, the graph
replay or the eager launches, copies out; or ``gsmvi.graph.capture``), over
the traced window's wall, in %."""

from portbench.program_trace import STEP_LOOP, idle_pct


def read(trace):
    return idle_pct(trace, STEP_LOOP)
