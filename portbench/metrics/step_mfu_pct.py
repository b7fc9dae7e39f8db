"""Step, whole: the configuration's FLOPs per fit step, counted from shapes
(``work/<config>.py``), times the traced window's steps, over the window's
wall and the card's float32 peak, in %."""

from portbench.peaks import FP32_FLOPS


def read(trace):
    if not trace.steps or trace.window_s <= 0 or trace.work is None:
        return None
    flops = trace.work.step_flops(trace.batch, trace.dim) * trace.steps
    return 100.0 * flops / trace.window_s / FP32_FLOPS
