"""End to end: seconds from the start of the process to the first job of the
window: imports, the card's context, the target, the kernel library (built
on a checkout's first run), and the warm-up fit."""


def read(window):
    return window.setup_s
