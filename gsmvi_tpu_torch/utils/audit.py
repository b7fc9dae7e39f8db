"""Periodic exact audits of the fused Newton-Schulz update kernels.

Counterpart of ``gsmvi_tpu/utils/audit.py``.  The kernels accept steps
through Newton-Schulz residual gates, which catch catastrophic accuracy
loss but not slow bias: an under-iterated NS chain converges to wrong
moments with zero rejections (``FactorGSM`` ``ns_iters`` notes).
``audit_every`` on the factor fitters closes that gap at run time: every
``audit_every`` iterations the driver hands the live state to an audit
built here, which draws one fresh batch, evaluates the score, and pushes the
same (eps, score) through both the fused kernel and the exact plain-torch
step, reporting the max-abs relative errors of the proposed mean and
covariance.  One audit is one extra score batch, one kernel call, one exact
step and one device-to-host read of three numbers.

The audit draw comes from a generator seeded with
``driver.audit_seed(seed, i)``, a stream disjoint from the per-step,
monitor and retry draws, and an audit writes nothing into the state: an
audited fit runs the same launches on the same data as an unaudited one and
ends in the same state, bit for bit.
"""

from __future__ import annotations

import warnings

import torch

from ..driver import audit_seed
from ..ops.bam_eps import bam_eps_update
from ..ops.fused_step import gsm_eps_update_fused, make_fused_eps_step
from ..ops.gsm_eps import apply_eps_step


def _audit_draw(state, i: int, batch_size: int, d: int):
    """The (B, D) float32 audit draw of iteration ``i`` on the state's
    device."""
    gen = torch.Generator(device=state.mean.device)
    gen.manual_seed(audit_seed(state.seed, i))
    return torch.randn((batch_size, d), generator=gen, dtype=torch.float32,
                       device=state.mean.device)


def _moment_errors(m_f, f_f, m_x, f_x):
    """Max-abs relative error of (mean, covariance) between the fused and
    exact proposals, each scaled by max(1, |exact|_max)."""
    s_f = f_f @ f_f.T
    s_x = f_x @ f_x.T
    em = torch.max(torch.abs(m_f - m_x)) / torch.clamp(
        torch.max(torch.abs(m_x)), min=1.0)
    es = torch.max(torch.abs(s_f - s_x)) / torch.clamp(
        torch.max(torch.abs(s_x)), min=1.0)
    return em, es


def _result(fused, exact, extra_valid=None):
    """(mean_err, cov_err, valid) with the errors 0 where not valid."""
    (m_f, f_f, good_f), (m_x, f_x, good_x) = fused, exact
    em, es = _moment_errors(m_f, f_f.to(torch.float32),
                            m_x.to(torch.float32), f_x.to(torch.float32))
    valid = good_f & good_x
    if extra_valid is not None:
        valid = valid & extra_valid
    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    return torch.where(valid, em, zero), torch.where(valid, es, zero), valid


def make_gsm_audit(lp_g, batch_size: int, d: int, ns_iters,
                   fused_score=None):
    """``audit(state, i, eps=None) -> (mean_err, cov_err, valid)`` (0-d
    tensors on the state's device) comparing the fused GSM kernels with the
    exact eps step (``ops/gsm_eps.apply_eps_step``) on one fresh draw from
    the live state.

    With ``fused_score`` (the fitter's ``(score_fn, params)``) the fused side
    is the whole step on K4 (``make_fused_eps_step``, ns, external draw):
    the sampling product, the score inside and the NS update, against
    ``lp_g`` and the exact step on the same draw, so it also certifies the
    fused score against ``lp_g``.  Without it the fused side is K1
    (``gsm_eps_update_fused``) on ``lp_g``'s scores.  ``valid`` is False when
    either side rejected (the errors are 0 then: nothing accepted to be
    biased).  ``eps`` replaces the audit draw (tests feed the JAX package's
    draws); ``audit.proposals(state, i, eps=None)`` returns the two
    proposals ((mean, f, good) fused, then exact) behind the errors.
    """
    step = None
    if fused_score is not None:
        score_fn, params = fused_score
        step = make_fused_eps_step(score_fn, len(params), batch_size, d,
                                   external_eps=True, iters=ns_iters)

    def proposals(state, i: int, eps=None):
        if eps is None:
            eps = _audit_draw(state, i, batch_size, d)
        mean, f = state.mean, state.factor
        vs = lp_g(mean + eps @ f.T).to(torch.float32).contiguous()
        if step is not None:
            fused = step(eps, mean, f, *params)
        else:
            fused = gsm_eps_update_fused(eps, vs, mean, f, iters=ns_iters)
        return fused, apply_eps_step(mean, f, eps, vs)

    def audit(state, i: int, eps=None):
        return _result(*proposals(state, i, eps))

    audit.proposals = proposals
    return audit


def make_bam_audit(lp_g, batch_size: int, d: int, regf, fused_update):
    """``audit(state, i, eps=None) -> (mean_err, cov_err, valid)`` comparing
    the fitter's (NS-ladder-tiered) fused BaM update with the exact thin-SVD
    step (``bam_eps_update(..., solver="svd")``) at the step's regularizer.

    ``fused_update(eps, vs, mean, f, reg, ns_stats) -> (mean, f, good,
    stiff)`` is the fitter's K7 on the tier its carried stats pick, so the
    audit runs the tier the fit runs at that step.  A step the kernel flags
    stiff is replayed exactly by the fit (same draw, SVD route), so it
    carries no fused bias: ``valid`` is False and the errors are 0.
    ``eps`` and ``audit.proposals`` as in ``make_gsm_audit``.
    """

    def proposals(state, i: int, eps=None):
        if eps is None:
            eps = _audit_draw(state, i, batch_size, d)
        mean, f = state.mean, state.factor
        vs = lp_g(mean + eps @ f.T).to(torch.float32).contiguous()
        reg = regf(state.step)
        m_f, f_f, good_f, stiff = fused_update(eps, vs, mean, f, reg,
                                               state.ns_stats)
        exact = bam_eps_update(eps, vs, mean, f, reg, solver="svd")
        return (m_f, f_f, good_f), exact, stiff

    def audit(state, i: int, eps=None):
        fused, exact, stiff = proposals(state, i, eps)
        return _result(fused, exact, ~stiff)

    audit.proposals = proposals
    return audit


def make_audit_hook(audit_fn, log: list, tol: float, label: str):
    """Driver ``state_hook``: run the audit, read its three numbers in one
    transfer, append a record to ``log`` and warn when an accepted fused
    step deviates from the exact path beyond ``tol`` (relative, either
    moment)."""

    def hook(i, state):
        em, es, valid = audit_fn(state, i)
        em, es, valid = torch.stack([em.to(torch.float32),
                                     es.to(torch.float32),
                                     valid.to(torch.float32)]).tolist()
        rec = {"i": int(i), "mean_err": em, "cov_err": es,
               "valid": bool(valid)}
        log.append(rec)
        if rec["valid"] and max(rec["mean_err"], rec["cov_err"]) > tol:
            warnings.warn(
                f"{label} fused-step audit at iteration {i}: accepted "
                f"update deviates from the exact path by "
                f"mean_err={rec['mean_err']:.2e} cov_err={rec['cov_err']:.2e}"
                f" (> tol {tol:.1e}) — the Newton-Schulz chain is biased "
                f"at this conditioning; lengthen ns_iters or disable "
                f"use_fused", stacklevel=2)

    return hook
