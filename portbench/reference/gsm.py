"""Gaussian score matching (GSM-VI, arXiv:2307.07849, Algorithm 1) in plain
torch on dense state.

Each step draws B points x_b = mu + L eps_b (L the Cholesky factor of the
current covariance S), scores them, and averages the per-point GSM updates:
with g = score(x), a = mu - x, Sg = S g,

    rho = (sqrt(1 + 4 (g'Sg + (a'g)^2)) - 1) / 2
    dmu = (Sg - a - a (g'(Sg - a)) / (1 + rho + a'g)) / (1 + rho)
    mu' = mu + mean_b dmu_b
    S'  = S + mean_b [a a' - (a + dmu_b)(a + dmu_b)']

that is, each point's mean moves so that the new Gaussian's score at x
matches g, and each point's covariance term is the exact rank-2 change of
the paper.  A proposal whose covariance does not factor is refused and the
state kept, as the program refuses a step that is not positive definite.
The fits run together on a leading axis; each draws its own stream.
"""

from __future__ import annotations

import torch

from .common import Arith, run


def update(mu, cov, x, g, arith):
    """One GSM step's proposal from the points ``x`` and their scores ``g``
    ((K, B, D) each) at the state (mu (K, D), cov (K, D, D)): (mu', cov')."""
    b = x.shape[-2]
    a = mu[:, None, :] - x
    sg = arith.mm(g, cov)
    vsv = torch.sum(g * sg, dim=-1)
    mv = torch.sum(a * g, dim=-1)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = sg - a
    w = torch.sum(g * eps0, dim=-1)
    den = 1.0 + rho + mv
    dmu_b = (eps0 - a * (w / den)[..., None]) / (1.0 + rho)[..., None]
    bm = a + dmu_b
    cov_new = cov + (arith.mm(a.mT, a) - arith.mm(bm.mT, bm)) / b
    return mu + torch.mean(dmu_b, dim=1), 0.5 * (cov_new + cov_new.mT)


def fit(score_of, arrays: dict, seeds, *, batch_size: int, niter: int,
        precision: str = "float64", device=None, start=None,
        first_step: int = 0, **_):
    """``niter + 1`` GSM steps for each seed in ``seeds``, from (0, I) or
    from ``start`` at absolute step ``first_step`` (``common.run``):
    (means (K, D), covs (K, D, D)) in the precision's dtype.  ``score_of``
    builds the target's score at an ``Arith`` (``reference/<target>.py``)."""
    arith = Arith(precision)
    dev = arrays["mean"].device if device is None else torch.device(device)
    arrays = {k: v.to(dev) for k, v in arrays.items()}
    lp_g = score_of(arrays, arith)
    return run(lambda mu, cov, x, g, step: update(mu, cov, x, g, arith),
               lp_g, seeds, batch=batch_size, niter=niter, arith=arith,
               device=dev, d=arrays["mean"].shape[-1], start=start,
               first_step=first_step)
