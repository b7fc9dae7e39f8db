"""Multivariate Student-t target (heavy tails: stresses score-based fits).

Counterpart of ``gsmvi_tpu/models/student_t.py``.  The scale matrix's
inverse and log-determinant are built in float64 with numpy and cast once,
as ``models/gaussian.py`` builds the Gaussian precision.  ``student_t``
draws loc and the scale factor with numpy from an integer seed (the JAX
package draws them from a JAX key, so the two packages' ``student_t`` give
different targets for the same integer; carry a JAX target over with
``student_t_from_arrays``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from .base import Target, make_target


def student_t_from_arrays(loc, sigma, df: float, prec=None,
                          device=None) -> Target:
    """Multivariate t with location ``loc`` (D,), scale matrix ``sigma``
    (D, D) and ``df`` degrees of freedom, from numpy arrays; the dtype is
    ``loc``'s (the kernel pair takes float32).  ``prec``
    (D, D), optional, is the precision the score and log-prob use (e.g. a
    JAX target's ``np.asarray(t.pallas_score[1][1])``); by default
    inv(sigma) in float64, cast once.  Analytic moments: mean = loc and
    cov = df/(df-2) sigma (df > 2).

        lp(x) = sum_b [const - (df+D)/2 log1p(maha_b/df)],
        maha_b = (x_b - loc) P (x_b - loc)
    """
    from ..ops.fused_step import student_t_score

    device = resolve_device(device)
    loc_np = np.asarray(loc)
    dt = loc_np.dtype
    d = loc_np.shape[-1]
    sigma64 = np.asarray(sigma, dtype=np.float64)
    prec_np = (np.linalg.inv(sigma64) if prec is None
               else np.asarray(prec)).astype(dt)
    logdet = float(np.linalg.slogdet(sigma64)[1])
    chol_np = np.linalg.cholesky(sigma64).astype(dt)
    df = float(df)
    const = (math.lgamma((df + d) / 2.0) - math.lgamma(df / 2.0)
             - 0.5 * d * math.log(df * math.pi) - 0.5 * logdet)

    loc_t = torch.as_tensor(loc_np, device=device)
    prec_t = torch.as_tensor(prec_np, device=device)
    chol_t = torch.as_tensor(chol_np, device=device)

    def log_prob(x):
        diff = x - loc_t
        maha = torch.sum((diff @ prec_t) * diff, dim=-1)
        return const - 0.5 * (df + d) * torch.log1p(maha / df)

    def sample(generator, n):
        gdev = generator.device
        z = torch.randn((n, d), generator=generator, device=gdev).to(device)
        # torch's Gamma sampler takes no generator: the gamma variates come
        # from a numpy generator seeded from the caller's, so a draw repeats.
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=gdev))
        g = np.random.default_rng(seed).gamma(df / 2.0, size=(n, 1)) * 2.0 / df
        g_t = torch.as_tensor(g.astype(dt), device=device)
        return loc_t + (z @ chol_t.T) / torch.sqrt(g_t)

    cov = (torch.as_tensor((df / (df - 2.0) * sigma64).astype(dt),
                           device=device) if df > 2 else None)
    params = (loc_t.reshape(1, d), prec_t,
              torch.tensor([[df, float(d)]], dtype=loc_t.dtype,
                           device=device))
    return make_target(log_prob, d, name=f"student_t_d{d}_df{df:g}",
                       mean=loc_t, cov=cov, sample=sample,
                       fused_score=(student_t_score, params))


def student_t(seed: int, d: int, df: float = 5.0, scale: float = 1.0,
              device=None) -> Target:
    """Multivariate t with ``df`` degrees of freedom: loc ~ N(0, I) and
    scale matrix L L^T + I with L = scale * N(0, 1) / sqrt(d), drawn with
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal(d)
    l = scale * rng.standard_normal((d, d)) / math.sqrt(d)
    sigma = l @ l.T + np.eye(d)
    return student_t_from_arrays(loc.astype(np.float32), sigma, df,
                                 device=device)
