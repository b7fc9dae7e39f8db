"""Multivariate-normal primitives over a Cholesky factor.

Counterpart of ``gsmvi_tpu/distributions.py:30-72``.  ``jnp.linalg.cholesky``
returns NaN on a matrix that is not positive definite and the validity
checks key off that; ``torch.linalg.cholesky`` raises instead.  The port
therefore factors with ``torch.linalg.cholesky_ex``, keeps its ``info`` flag
on the device, and masks a failed factor to NaN — no host sync, no raise.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def safe_cholesky(cov: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of ``cov`` (+ ``jitter * I``); all-NaN (never
    raises) where ``cov`` is not positive definite."""
    d = cov.shape[-1]
    if jitter:
        cov = cov + jitter * torch.eye(d, dtype=cov.dtype, device=cov.device)
    chol, info = torch.linalg.cholesky_ex(cov)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def _nan_where(bad: torch.Tensor, *outs: torch.Tensor):
    nan = float("nan")
    return tuple(torch.where(bad, torch.full_like(o, nan), o) for o in outs)


def safe_eigh(mat: torch.Tensor):
    """``torch.linalg.eigh`` that gives NaN for a non-finite input, as
    ``jnp.linalg.eigh`` does, instead of raising (the input is swapped for
    the identity on the device and the outputs masked)."""
    bad = ~torch.isfinite(mat).all()
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    w, q = torch.linalg.eigh(torch.where(bad, eye, mat))
    return _nan_where(bad, w, q)


def safe_svd(mat: torch.Tensor):
    """Thin ``torch.linalg.svd`` (u, s) that gives NaN for a non-finite
    input instead of raising."""
    bad = ~torch.isfinite(mat).all()
    u, s, _ = torch.linalg.svd(torch.where(bad, torch.zeros_like(mat), mat),
                               full_matrices=False)
    return _nan_where(bad, u, s)


def mvn_sample(generator: torch.Generator, mean: torch.Tensor,
               chol: torch.Tensor, batch_size: int) -> torch.Tensor:
    """``batch_size`` draws from N(mean, chol chol^T): ``mean + eps chol^T``."""
    d = mean.shape[-1]
    eps = torch.randn((batch_size, d), generator=generator, dtype=mean.dtype,
                      device=mean.device)
    return mean + eps @ chol.T


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor,
               chol: torch.Tensor) -> torch.Tensor:
    """Log density of N(mean, chol chol^T) at ``x``; batched over leading
    axes, one triangular solve, no dense inverse."""
    d = mean.shape[-1]
    diff = x - mean
    batch_shape = diff.shape[:-1]
    y = torch.linalg.solve_triangular(chol, diff.reshape(-1, d).T,
                                      upper=False)
    maha = torch.sum(y * y, dim=0).reshape(batch_shape)
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                       dim=-1)
    return -0.5 * (d * _LOG_2PI + maha) - logdet
