"""Device: the share of the traced window in which nothing ran on the card,
1 - (union of the device records' intervals) / window wall, in %."""

from portbench.trace import busy_s


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace.device) / trace.window_s)
