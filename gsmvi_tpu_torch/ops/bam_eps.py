"""Factor-coordinate BaM update (plain torch): no D x D factorization.

Counterpart of ``gsmvi_tpu/ops/bam_eps.py:53-231``.  The fitter samples
x_b = mu0 + eps_b F^T from the factor it keeps, so BaM's V is the congruence
V = F (I + Om Om^T) F^T and U = FU FU^T with

    Om = [sqrt(reg/B) (eps - epsbar)^T | -sqrt(reg/(1+reg)) epsbar^T]   (D, B+1)
    FU = [sqrt(reg/B) (v - gbar)^T     |  sqrt(reg/(1+reg)) gbar^T]

With W1 = I + Om Cu Om^T (Cu = (I + sqrt(I + Om^T Om))^{-1}) and
Y = W1^T F^T FU, the new factor is F' = F W1 (I + Yt diag(w) Yt^T) where
Yt, l are the unit-column eigenbasis and spectrum of Y^T Y and
w = sqrt(2 / (1 + sqrt(1 + 4 l))) - 1 in (-1, 0].  The spectrum comes from a
thin SVD of Y (accurate at kappa(Y)) or an ``eigh`` of the Gram (cheaper,
accurate at kappa(Y)^2); ``solver="auto"`` takes the ``eigh`` while
eps(dtype) * lmax <= 1e-3 and the SVD above.  That choice is JAX's
``lax.cond``; here it is a host ``if``, one device read per call, which
this route (off the card, and the stiff replays and retries on it) affords.
"""

from __future__ import annotations

import torch

from ..distributions import safe_eigh, safe_svd
from .gsm_factor import _update_corr


def _svd_solve(y):
    """Thin SVD of Y: unit columns, spectrum s^2, finite flag."""
    u_y, s_y = safe_svd(y)
    return u_y, s_y * s_y, torch.isfinite(s_y[0])


def _eigh_solve(y, gy):
    """Normalised ``eigh`` of the Gram with the reconstruction gate (4e-6)
    and the eps * lmax clamp of the noise eigenvalues."""
    gnorm = torch.sqrt(torch.sum(gy * gy)) + 1e-30
    lmb_n, ev = safe_eigh(gy / gnorm)
    lmb = lmb_n * gnorm
    recon = (ev * lmb_n) @ ev.T - gy / gnorm
    eigh_ok = torch.sum(recon * recon) < 4e-6
    lmax = torch.clamp(lmb[-1], min=0.0)
    eps_m = torch.finfo(gy.dtype).eps
    lc = torch.maximum(lmb, eps_m * lmax + 1e-30)
    return (y @ ev) * torch.rsqrt(lc), lmb, eigh_ok


def bam_eps_update(eps, vs, mean, f, reg, newton_iters: int = 20,
                   solver: str = "auto"):
    """One factor-coordinate BaM step: (mean_new, f_new, good).

    eps (B, D) the draws behind x = mean + eps f^T; vs (B, D) the scores at
    x; mean (D,); f (D, D); ``reg`` this iteration's regularizer.  ``good``
    is False for non-finite arithmetic, a failed trace screen
    ||F'||^2 <= 1.05 ||F W1||^2 + 1e-6, or (``eigh``) a failed
    reconstruction gate; callers select/revert on it.  ``solver`` is
    "auto", "svd" or "eigh" (see the module docstring).
    """
    if solver not in ("auto", "svd", "eigh"):
        raise ValueError(f"solver must be 'auto', 'svd' or 'eigh', got "
                         f"{solver!r}")
    b, d = eps.shape
    dtype = f.dtype
    reg = torch.as_tensor(reg, dtype=dtype)
    r1 = reg / (1.0 + reg)
    epsbar = torch.mean(eps, dim=0)
    gbar = torch.mean(vs, dim=0)
    gd = vs - gbar
    ed = eps - epsbar
    om = torch.cat([torch.sqrt(reg / b) * ed.T,
                    -torch.sqrt(r1) * epsbar[:, None]], dim=1)   # (D, B+1)
    fu = torch.cat([torch.sqrt(reg / b) * gd.T,
                    torch.sqrt(r1) * gbar[:, None]], dim=1)
    q = f.T @ fu                                                # (D, B+1)
    k1 = q.shape[-1]
    gu = om.T @ om
    cu, _ = _update_corr(gu, newton_iters)
    omq = om.T @ q
    y = q + om @ (cu @ omq)                                     # W1^T Q

    if solver == "svd" or (solver == "auto" and d < k1):
        # Below D = B+1 the thin SVD is the only shape-consistent branch.
        ytil, lmb, eigh_ok = _svd_solve(y)
    elif solver == "eigh":
        gy = y.T @ y
        ytil, lmb, eigh_ok = _eigh_solve(y, 0.5 * (gy + gy.T))
    else:
        gy = y.T @ y
        gy = 0.5 * (gy + gy.T)
        lmax_ub = torch.max(torch.sum(torch.abs(gy), dim=-1))
        thresh = 1e-3 / torch.finfo(dtype).eps
        if bool(lmax_ub > thresh):
            ytil, lmb, eigh_ok = _svd_solve(y)
        else:
            ytil, lmb, eigh_ok = _eigh_solve(y, gy)
    lmb = torch.clamp(lmb, min=0.0)
    sigma = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 * lmb))
    wdiag = torch.sqrt(sigma) - 1.0                             # in (-1, 0]
    fw1 = f + (f @ om) @ (cu @ om.T)                            # F W1
    fwy = fw1 @ ytil
    f_new = fw1 + (fwy * wdiag) @ ytil.T
    tr_new = torch.sum(f_new * f_new)
    tr_v = torch.sum(fw1 * fw1)
    good = (torch.isfinite(tr_new) & (tr_new <= 1.05 * tr_v + 1e-6)
            & eigh_ok)
    s_gbar = f_new @ (f_new.T @ gbar)
    xbar = mean + epsbar @ f.T
    mean_new = mean / (1.0 + reg) + r1 * (s_gbar + xbar)
    return mean_new, f_new, good


def apply_bam_eps_step(state_mean, state_f, eps, vs, reg,
                       newton_iters: int = 20, solver: str = "auto"):
    """Proposal + select on the device: the old (mean, F) where ``good`` is
    False.  Returns (mean, f, good)."""
    mean_new, f_new, good = bam_eps_update(eps, vs, state_mean, state_f, reg,
                                           newton_iters, solver)
    return (torch.where(good, mean_new, state_mean),
            torch.where(good, f_new, state_f), good)
