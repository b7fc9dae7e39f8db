"""Gaussian targets with an analytic precision-matrix score.

Counterpart of ``gsmvi_tpu/models/gaussian.py``.  The precision is built in
float64 with numpy and cast once, exactly as the JAX module does
(``models/gaussian.py:33-40``), so a target built here from the arrays the
JAX package holds carries identical matrices.  The random targets are drawn
with numpy from an integer seed (the JAX package draws them from a JAX key,
so the two packages' ``dense_gaussian`` give different matrices for the same
integer; carry a JAX target over with ``gaussian_target_from_arrays``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from .base import Target


def gaussian_target_from_arrays(mean, cov, name: str = "gaussian",
                                device=None) -> Target:
    """Gaussian target from numpy ``mean`` (D,) and ``cov`` (D, D), e.g.
    ``np.asarray`` of a JAX target's arrays.  The dtype is ``mean``'s; the
    tensors live on ``device`` (default: the CUDA card; raises without one).

        lp(x) = sum_b [-0.5 (x_b - m)^T P (x_b - m)] + B (0.5 logdet P - D/2 log 2pi)
        score = (m - x) @ P
    """
    from ..ops.fused_step import gaussian_score

    device = resolve_device(device)
    mean_np = np.asarray(mean)
    cov_np = np.asarray(cov, dtype=mean_np.dtype)
    d = mean_np.shape[-1]
    prec64 = np.linalg.inv(cov_np.astype(np.float64))
    logdet_p = float(np.linalg.slogdet(prec64)[1])
    const = 0.5 * logdet_p - 0.5 * d * math.log(2.0 * math.pi)

    mean_t = torch.as_tensor(mean_np, device=device)
    cov_t = torch.as_tensor(cov_np, device=device)
    prec = torch.as_tensor(prec64.astype(mean_np.dtype), device=device)

    def lp(x):
        diff = x - mean_t
        maha = torch.sum((diff @ prec) * diff, dim=-1)
        return torch.sum(-0.5 * maha + const)

    def lp_g(x):
        return (mean_t - x) @ prec

    return Target(d=d, lp=lp, lp_g=lp_g, name=name, mean=mean_t, cov=cov_t,
                  fused_score=(gaussian_score, (mean_t.reshape(1, d), prec)))


def dense_gaussian(seed: int, d: int, scale: float = 1.0,
                   dtype=np.float32, device=None) -> Target:
    """Random dense-covariance MVN: uniform mean, cov = L L^T + 1e-3 I with
    normal L (the reference examples' ``setup_model``)."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = scale * rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return gaussian_target_from_arrays(mean.astype(dtype), cov.astype(dtype),
                                       f"dense_gaussian_d{d}", device)


def ill_conditioned_gaussian(seed: int, d: int, condition: float = 1e4,
                             dtype=np.float32, device=None) -> Target:
    """MVN with log-spaced eigenvalues spanning ``condition`` and a random
    rotation."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d)
    evals = np.logspace(0.0, np.log10(condition), d)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    cov = (q * evals) @ q.T
    cov = 0.5 * (cov + cov.T)
    return gaussian_target_from_arrays(
        mean.astype(dtype), cov.astype(dtype),
        f"ill_gaussian_d{d}_k{condition:g}", device)
