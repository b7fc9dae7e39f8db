"""Symmetric PSD matrix square roots (plain torch).

Counterpart of ``gsmvi_tpu/ops/sqrtm.py:29-76``.  Every matrix BaM needs a
root of is symmetric positive (semi)definite after the similarity
reformulation of ``ops/bam.py``, so an eigendecomposition or a matmul-only
Newton-Schulz iteration serves:

- ``spd_sqrtm``         — Q diag(sqrt(max(l, eps))) Q^T from one ``eigh``;
- ``spd_sqrtm_and_inv`` — (sqrt(M), sqrt(M)^{-1}) from one ``eigh``;
- ``spd_sqrtm_newton``  — the coupled Newton-Schulz iteration on M scaled by
  its row-sum norm (a sharp bound on lambda_max for SPD M).
"""

from __future__ import annotations

import torch

from ..distributions import safe_eigh


def spd_sqrtm(mat: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric PSD square root via ``eigh``; eigenvalues clipped at
    ``eps`` so slightly indefinite round-off still gives a real root (NaN,
    not a raise, for a non-finite input, as in JAX)."""
    w, q = safe_eigh(mat)
    w = torch.clamp(w, min=eps)
    return (q * torch.sqrt(w)) @ q.T


def spd_sqrtm_and_inv(mat: torch.Tensor, eps: float = 1e-30):
    """(sqrt(M), inv(sqrt(M))) for SPD ``M`` from a single ``eigh``."""
    w, q = safe_eigh(mat)
    w = torch.clamp(w, min=eps)
    sw = torch.sqrt(w)
    return (q * sw) @ q.T, (q / sw) @ q.T


def spd_sqrtm_newton(mat: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Scaled Newton-Schulz SPD square root (matmuls only): Y <- Y T,
    Z <- T Z with T = (3I - Z Y)/2, on M over its row-sum norm."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    norm = torch.max(torch.sum(torch.abs(mat), dim=-1)) + 1e-30
    y = mat / norm
    z = eye
    for _ in range(int(num_iters)):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)
