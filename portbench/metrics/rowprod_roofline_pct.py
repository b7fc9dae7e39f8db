"""Kernels: the row products and the score of a step (the kernels the cell's
file names in ``rowprod_kernels``): their roofline time per step at the
cell's (B, D), counted from shapes in ``work/<config>.py``, over their device
time per step, in %."""

from portbench.peaks import roofline_s


def read(trace):
    recs = trace.kernels(trace.cell.get("rowprod_kernels", ()))
    if not recs or not trace.steps or trace.work is None:
        return None
    per_step = sum(e - s for _, s, e in recs) * 1e-6 / trace.steps
    flops, nbytes = trace.work.rowprod(trace.batch, trace.dim)
    return 100.0 * roofline_s(flops, nbytes) / per_step
