"""Multivariate-normal primitives over a Cholesky factor.

Counterpart of ``gsmvi_tpu/distributions.py:30-127``.  ``jnp.linalg.cholesky``
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


def mvn_entropy(chol: torch.Tensor) -> torch.Tensor:
    """Differential entropy of N(., chol chol^T)."""
    d = chol.shape[-1]
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                       dim=-1)
    return 0.5 * d * (1.0 + _LOG_2PI) + logdet


def mvn_kl(mean0: torch.Tensor, chol0: torch.Tensor, mean1: torch.Tensor,
           chol1: torch.Tensor) -> torch.Tensor:
    """Analytic KL( N(mean0, S0) || N(mean1, S1) ) from Cholesky factors,
    by triangular solves only (``gsmvi_tpu/distributions.py:81-98``):
    0.5 (||L1^{-1} L0||_F^2 + ||L1^{-1} (m1 - m0)||^2 - D) + logdet L1
    - logdet L0."""
    d = mean0.shape[-1]
    m = torch.linalg.solve_triangular(chol1, chol0, upper=False)
    tr = torch.sum(m * m)
    diff = (mean1 - mean0).reshape(d, 1)
    y = torch.linalg.solve_triangular(chol1, diff, upper=False)
    maha = torch.sum(y * y)
    logdet0 = torch.sum(torch.log(torch.diagonal(chol0)))
    logdet1 = torch.sum(torch.log(torch.diagonal(chol1)))
    return 0.5 * (tr + maha - d) + logdet1 - logdet0


def as_generator(seed_or_generator, device) -> torch.Generator:
    """``seed_or_generator`` itself when it is a ``torch.Generator``, else
    a new generator on ``device`` seeded with the integer."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


class Gaussian:
    """Dense-covariance Gaussian with a numpyro-like surface (``log_prob``,
    ``sample``, ``covariance_matrix``), the counterpart of
    ``gsmvi_tpu/distributions.py:101-127``.  ``loc``, ``cov`` and
    ``scale_tril`` are tensors or arrays; they land on ``device`` (default:
    the CUDA card) in ``loc``'s dtype (torch's default for a non-tensor)."""

    def __init__(self, loc, cov=None, scale_tril=None, device=None):
        from .config import resolve_device

        device = (loc.device if device is None and torch.is_tensor(loc)
                  else resolve_device(device))
        dtype = loc.dtype if torch.is_tensor(loc) else None
        self.loc = torch.as_tensor(loc, dtype=dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=self.loc.dtype,
                                         device=device)
        if scale_tril is None:
            d = self.loc.shape[-1]
            cov = (torch.eye(d, dtype=self.loc.dtype, device=device)
                   if cov is None else as_t(cov))
            scale_tril = safe_cholesky(cov)
        self.scale_tril = as_t(scale_tril)

    @property
    def covariance_matrix(self) -> torch.Tensor:
        return self.scale_tril @ self.scale_tril.T

    def log_prob(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.loc.dtype, device=self.loc.device)
        return mvn_logpdf(x, self.loc, self.scale_tril)

    def sample(self, seed, sample_shape=()) -> torch.Tensor:
        """Draws of shape ``sample_shape + (D,)`` from a generator: ``seed``
        is an int (a new generator on the distribution's device) or a
        ``torch.Generator`` on that device."""
        n = int(math.prod(sample_shape)) if sample_shape else 1
        gen = as_generator(seed, self.loc.device)
        draws = mvn_sample(gen, self.loc, self.scale_tril, n)
        if sample_shape:
            return draws.reshape(*sample_shape, self.loc.shape[-1])
        return draws[0]
