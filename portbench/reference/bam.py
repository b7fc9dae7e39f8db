"""Batch-and-Match (BaM, arXiv:2402.14758, Algorithm 1) in plain torch on
dense state, in the paper's low-rank form.

Each step draws B points x_b = mu + L eps_b, scores them (g_b), and with the
step's regularizer reg and r = reg / (1 + reg) forms

    V  = S + reg C + r (mu - xbar)(mu - xbar)'        C = batch cov of x
    U  = FU FU',  FU = [sqrt(reg / B) (g - gbar)' | sqrt(r) gbar]  (D, B+1)

and solves S' U S' + S' = V:  with A = V FU and R = I/2 + (FU'A + I/4)^(1/2),
S' = V - Z'Z, Z = chol(R R)^-1 A';  mu' = mu / (1 + reg) + r (S' gbar + xbar).
The square root is of a symmetric (B+1)^2 matrix, by ``eigh``.  A proposal
whose covariance does not factor is refused and the state kept.  The fits
run together on a leading axis; each draws its own stream.
"""

from __future__ import annotations

import math

import torch

from .common import Arith, run


def regularizer(schedule, step: int) -> float:
    """The regularizer of absolute step ``step`` (from 0) for a schedule
    ``[kind, reg0]``: "linear" reg0 / (step + 1), "constant" reg0."""
    kind, reg0 = schedule
    if kind == "linear":
        return reg0 / (step + 1.0)
    if kind == "constant":
        return float(reg0)
    raise ValueError(f"unknown regularizer schedule {kind!r}")


def _sym_sqrt(m: torch.Tensor) -> torch.Tensor:
    """Root of the symmetric positive definite ``m`` by ``eigh``."""
    lam, vec = torch.linalg.eigh(m)
    return (vec * torch.sqrt(torch.clamp(lam, min=0.0))[..., None, :]) @ vec.mT


def update(mu, cov, x, g, reg: float, arith):
    """One BaM step's proposal from the points ``x`` and their scores ``g``
    ((K, B, D) each) at the state (mu (K, D), cov (K, D, D)) under the
    regularizer ``reg``: (mu', cov')."""
    b = x.shape[-2]
    r1 = reg / (1.0 + reg)
    xbar = torch.mean(x, dim=1)
    gbar = torch.mean(g, dim=1)
    xd = x - xbar[:, None, :]
    gd = g - gbar[:, None, :]
    dm = (mu - xbar)[..., None]
    v = cov + (reg / b) * arith.mm(xd.mT, xd) + r1 * arith.mm(dm, dm.mT)
    fu = torch.cat([math.sqrt(reg / b) * gd.mT,
                    math.sqrt(r1) * gbar[..., None]], dim=-1)
    am = arith.mm(v, fu)                                       # (K, D, B+1)
    mk = arith.mm(fu.mT, am)
    eye_k = torch.eye(b + 1, dtype=x.dtype, device=x.device)
    rt = 0.5 * eye_k + _sym_sqrt(0.5 * (mk + mk.mT) + 0.25 * eye_k)
    rr = arith.mm(rt, rt)
    kc = torch.linalg.cholesky_ex(0.5 * (rr + rr.mT))[0]
    z = torch.linalg.solve_triangular(kc, am.mT, upper=False)
    cov_new = v - arith.mm(z.mT, z)
    cov_new = 0.5 * (cov_new + cov_new.mT)
    mu_new = (mu / (1.0 + reg)
              + r1 * (arith.mm(cov_new, gbar[..., None])[..., 0] + xbar))
    return mu_new, cov_new


def fit(score_of, arrays: dict, seeds, *, batch_size: int, niter: int,
        regf, precision: str = "float64", device=None, start=None,
        first_step: int = 0, **_):
    """``niter + 1`` BaM steps for each seed in ``seeds`` under the schedule
    ``regf`` (``[kind, reg0]``), from (0, I) or from ``start`` at absolute
    step ``first_step`` (``common.run``): (means (K, D), covs (K, D, D)) in
    the precision's dtype."""
    arith = Arith(precision)
    dev = arrays["mean"].device if device is None else torch.device(device)
    arrays = {k: v.to(dev) for k, v in arrays.items()}
    lp_g = score_of(arrays, arith)
    return run(lambda mu, cov, x, g, step: update(
                   mu, cov, x, g, regularizer(regf, step), arith),
               lp_g, seeds, batch=batch_size, niter=niter, arith=arith,
               device=dev, d=arrays["mean"].shape[-1], start=start,
               first_step=first_step)
