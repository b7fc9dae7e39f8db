"""Utilities of the port: the run-time audits of the fused kernels
(``utils/audit.py``; counterpart of ``gsmvi_tpu/utils``)."""

from .audit import make_audit_hook, make_bam_audit, make_gsm_audit

__all__ = ["make_audit_hook", "make_bam_audit", "make_gsm_audit"]
