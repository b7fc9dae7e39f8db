"""The dense Gaussian target in plain torch: its score from the mean and
covariance the benchmark made, with the precision matrix worked out here."""

from __future__ import annotations

import torch


def score(arrays: dict, arith):
    """``x (..., B, D) -> (m - x) P``, P = cov^-1 in float64 (then in the
    reference's dtype), products at the reference's precision."""
    mean = arrays["mean"].to(torch.float64)
    cov = arrays["cov"].to(torch.float64)
    prec = torch.cholesky_inverse(torch.linalg.cholesky(cov))
    prec = (0.5 * (prec + prec.T)).to(arith.dtype)
    mean = mean.to(arith.dtype)

    def lp_g(x: torch.Tensor) -> torch.Tensor:
        return arith.mm(mean - x, prec)

    return lp_g
