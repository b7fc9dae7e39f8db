"""Utilities of the port (counterpart of ``gsmvi_tpu/utils``): the KL
monitor, the initializers, checkpoints, timing and tracing (the port's
spans and its record of recent fits), and the
run-time audits of the fused kernels (``utils/audit.py``)."""

from .audit import make_audit_hook, make_bam_audit, make_gsm_audit
from .checkpoint import load_state, save_state
from .initializers import lbfgs_init, map_init
from .monitors import KLMonitor, forward_kl, reverse_kl
from .profiling import fit_throughput, recent_fits, span, time_fn, trace

__all__ = ["KLMonitor", "fit_throughput", "forward_kl", "lbfgs_init",
           "load_state", "make_audit_hook", "make_bam_audit",
           "make_gsm_audit", "map_init", "recent_fits", "reverse_kl",
           "save_state", "span", "time_fn", "trace"]
