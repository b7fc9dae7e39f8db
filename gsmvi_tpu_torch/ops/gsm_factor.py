"""Factor-state helpers (counterpart of ``gsmvi_tpu/ops/gsm_factor.py``).

Ported: ``factor_to_cov`` and ``_update_corr`` (the PSD-update correction
that ``ops/bam_eps.py`` needs); the ``twophase`` and ``qr`` factor methods
are still to come (ROADMAP.md).
"""

from __future__ import annotations

import torch


def factor_to_cov(F: torch.Tensor) -> torch.Tensor:
    """Dense covariance S = F F^T, exactly symmetric."""
    s = F @ F.T
    return 0.5 * (s + s.T)


def _update_corr(g: torch.Tensor, newton_iters: int):
    """C = (I + (I+G)^{1/2})^{-1} for PSD ``g``, and the root (I+G)^{1/2}.

    The G-stable form of the factor equation 2C + C G C = I of I + P P^T
    (``gsmvi_tpu/ops/gsm_factor.py:142-158``): I + G has eigenvalues >= 1,
    so its Newton-Schulz root converges, and no inverse root of the possibly
    singular G appears.  ``solve_ex`` gives inf/NaN where JAX's ``solve``
    does, instead of raising.
    """
    from .sqrtm import spd_sqrtm_newton

    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    root = spd_sqrtm_newton(eye + g, newton_iters)
    root = 0.5 * (root + root.T)
    return torch.linalg.solve_ex(root + eye, eye)[0], root
