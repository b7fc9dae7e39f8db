"""Target container: ``lp``/``lp_g`` plus the metadata tests and benches use.

Counterpart of ``gsmvi_tpu/models/base.py``.  ``Target.pallas_score`` of the
JAX package becomes ``Target.fused_score``: a ``(score_fn, params)`` pair
whose ``score_fn(x, *params)`` is a kernel wrapper of the port (for the
Gaussian family, ``ops.fused_step.gaussian_score``).  ``FactorGSM`` takes
the pair as ``fused_score=`` and runs its whole-step path through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class Target:
    """A VI target: batch-summed log-prob and score callables on tensors."""

    d: int
    lp: Callable            # (B, D) -> scalar (sum over batch)
    lp_g: Callable          # (B, D) -> (B, D)
    name: str = "target"
    mean: Optional[torch.Tensor] = None   # true mean, if analytic
    cov: Optional[torch.Tensor] = None    # true covariance, if analytic
    # Optional (score_fn, params) pair for the whole-step kernel path.
    fused_score: Optional[tuple] = None


def make_target(log_prob: Callable, d: int, name: str = "target",
                **kwargs) -> Target:
    """Target from a per-sample ``log_prob((B, D)) -> (B,)``: ``lp`` sums
    over the batch and ``lp_g = torch.func.grad(lp)``."""

    def lp(x):
        return torch.sum(log_prob(x))

    return Target(d=d, lp=lp, lp_g=torch.func.grad(lp), name=name, **kwargs)
