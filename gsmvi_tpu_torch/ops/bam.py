"""Batch-and-Match (BaM) updates on dense state, in plain torch
(arXiv:2402.14758).

Counterpart of ``gsmvi_tpu/ops/bam.py:48-234``.  The update
S = 2 (I + sqrtm(I + 4 V U))^{-1} V is solved in its similarity form: with
L = chol(V), S = 2 L (I + sqrt(I + 4 L^T U L))^{-1} L^T, where the root is of
a symmetric matrix with eigenvalues >= 1 (``eigh``, or Newton-Schulz with an
``eigh`` fallback).  U is exactly rank <= B+1,

    U = reg G + reg/(1+reg) gbar gbar^T = FU FU^T,
    FU = [sqrt(reg/B) Gd^T | sqrt(reg/(1+reg)) gbar]          (D, B+1),

so the low-rank form solves a (B+1)-sized system instead.  The dense route
runs this off the card, and on the card with ``use_factor=False``.
"""

from __future__ import annotations

import math

import torch

from ..distributions import safe_cholesky
from .sqrtm import spd_sqrtm, spd_sqrtm_newton


def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


def bam_batch_stats(samples, vs):
    """(xbar, C, gbar, G): batch means and centred second moments (Grams)."""
    b = samples.shape[0]
    xbar = torch.mean(samples, dim=0)
    gbar = torch.mean(vs, dim=0)
    xd = samples - xbar
    gd = vs - gbar
    return xbar, (xd.T @ xd) / b, gbar, (gd.T @ gd) / b


def _bam_uv(samples, vs, mu0, S0, reg):
    xbar, c, gbar, g = bam_batch_stats(samples, vs)
    r1 = reg / (1.0 + reg)
    u = reg * g + r1 * torch.outer(gbar, gbar)
    v = S0 + reg * c + r1 * torch.outer(mu0 - xbar, mu0 - xbar)
    return xbar, gbar, u, v


def _bam_mu(mu0, xbar, gbar, s, reg):
    r1 = reg / (1.0 + reg)
    return mu0 / (1.0 + reg) + r1 * (s @ gbar + xbar)


def _robust_sqrt(m, sqrt_method: str, newton_iters: int, rtol: float = 1e-3):
    """SPD root of ``m``: ``eigh``, or with ``"newton"`` the Newton-Schulz
    root unless its relative residual reaches ``rtol``, then ``eigh`` (JAX's
    ``lax.cond`` becomes a select on the device: no host read)."""
    if sqrt_method != "newton":
        return spd_sqrtm(m)
    root = spd_sqrtm_newton(m, newton_iters)
    root = 0.5 * (root + root.T)
    res = torch.linalg.norm(root @ root - m) / torch.clamp(
        torch.linalg.norm(m), min=1e-30)
    return torch.where(res < rtol, root, spd_sqrtm(m))


def _check_rank2(samples, vs):
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")


def bam_update(samples, vs, mu0, S0, reg, jitter: float = 0.0,
               sqrt_method: str = "eigh", newton_iters: int = 20):
    """Full-rank BaM update: (mu, S) with S exactly symmetric PSD.
    ``jitter`` lands on V's diagonal before its Cholesky factor."""
    _check_rank2(samples, vs)
    eye = torch.eye(mu0.shape[-1], dtype=S0.dtype, device=S0.device)
    xbar, gbar, u, v = _bam_uv(samples, vs, mu0, S0, reg)
    if jitter:
        v = v + jitter * eye
    l = safe_cholesky(v)
    m = eye + 4.0 * (l.T @ u @ l)
    m = 0.5 * (m + m.T)
    sqrt_m = _robust_sqrt(m, sqrt_method, newton_iters)
    k = safe_cholesky(eye + sqrt_m)
    y = torch.linalg.solve_triangular(k, l.T, upper=False)
    s = y.T @ y
    s = s + s.T
    return _bam_mu(mu0, xbar, gbar, s, reg), s


def bam_lowrank_update(samples, vs, mu0, S0, reg, jitter: float = 0.0,
                       sqrt_method: str = "eigh", newton_iters: int = 20):
    """Low-rank BaM update with the exact (D, B+1) factor FU of U:
    A = V FU, R = I/2 + sqrt(FU^T A + I/4), S = V - Z^T Z with
    Z = chol(R R)^{-1} A^T."""
    _check_rank2(samples, vs)
    b = samples.shape[0]
    dtype = S0.dtype
    xbar = torch.mean(samples, dim=0)
    gbar = torch.mean(vs, dim=0)
    gd = vs - gbar
    xd = samples - xbar
    r1 = reg / (1.0 + reg)
    v = S0 + reg * ((xd.T @ xd) / b) + r1 * torch.outer(mu0 - xbar,
                                                        mu0 - xbar)
    if jitter:
        v = v + jitter * torch.eye(v.shape[-1], dtype=dtype, device=v.device)
    fu = torch.cat([_sqrt(reg / b) * gd.T, _sqrt(r1) * gbar[:, None]], dim=1)
    a = v @ fu                                           # (D, B+1)
    mk = fu.T @ a                                        # (B+1, B+1)
    eye_k = torch.eye(mk.shape[-1], dtype=dtype, device=v.device)
    inner = 0.5 * (mk + mk.T) + 0.25 * eye_k
    rt = 0.5 * eye_k + _robust_sqrt(inner, sqrt_method, newton_iters)
    bb = rt @ rt
    kc = safe_cholesky(0.5 * (bb + bb.T))
    z = torch.linalg.solve_triangular(kc, a.T, upper=False)   # (B+1, D)
    s = v - z.T @ z
    s = 0.5 * (s + s.T)
    return _bam_mu(mu0, xbar, gbar, s, reg), s


class Regularizers:
    """BaM regularizer schedules, pure functions of the iteration index.

    The reference's closures bump ``self.counter`` per call and ignore the
    index; it calls ``regf`` once per iteration from i=0, so its counter is
    ``i + 1`` and the pure equivalents are (``gsmvi_tpu/ops/bam.py:195``)

        constant(reg0): i -> reg0
        linear(reg0):   i -> reg0 / (i + 1)
        custom(func):   i -> func(i + 1)

    ``counter``/``reset`` are kept for API compatibility.
    """

    def __init__(self):
        self.counter = 0

    def reset(self):
        self.counter = 0

    def constant(self, reg0):
        def reg_iter(iteration):
            self.counter += 1
            return reg0
        return reg_iter

    def linear(self, reg0):
        def reg_iter(iteration):
            self.counter += 1
            return reg0 / (iteration + 1.0)
        return reg_iter

    def custom(self, func):
        def reg_iter(iteration):
            self.counter += 1
            return func(iteration + 1)
        return reg_iter
