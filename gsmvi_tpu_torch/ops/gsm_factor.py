"""Factor-state helpers (counterpart of ``gsmvi_tpu/ops/gsm_factor.py``).

Only ``factor_to_cov`` is ported; the ``twophase`` and ``qr`` factor methods
are still to come (ROADMAP.md).
"""

from __future__ import annotations

import torch


def factor_to_cov(F: torch.Tensor) -> torch.Tensor:
    """Dense covariance S = F F^T, exactly symmetric."""
    s = F @ F.T
    return 0.5 * (s + s.T)
