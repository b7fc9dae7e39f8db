"""Kernels: the small space's roofline time at the cell's (B, D) (the work
of one update of one fit, counted from shapes in ``work/<config>.py``) over
its device time per update, in %: the time of the kernels the cell's file
names in ``smallspace_kernels`` over the traced fit steps (one update a
step; a launch that updates K replicas counts K)."""

from portbench.peaks import roofline_s


def read(trace):
    recs = trace.kernels(trace.cell.get("smallspace_kernels", ()))
    if not recs or not trace.steps or trace.work is None:
        return None
    per_update = sum(e - s for _, s, e in recs) * 1e-6 / trace.steps
    flops, nbytes = trace.work.smallspace(trace.batch, trace.dim)
    return 100.0 * roofline_s(flops, nbytes) / per_update
