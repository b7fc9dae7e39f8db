"""Rosenbrock/banana-warped Gaussian target.

Counterpart of ``gsmvi_tpu/models/banana.py``: the same density, its score
by ``torch.func.grad``, an exact sampler, and the analytic score as a
kernel pair (``ops.fused_step.banana_score``).  The warp
x1 -> x1 + b (x0^2 - s^2) pushes N(0, diag(s^2, 1, ..., 1)) forward, so the
moments are analytic: mean 0 and cov diag(s^2, 1 + 2 b^2 s^4, 1, ..., 1)
(x1 = z1 + b (x0^2 - s^2) with Var(x0^2) = 2 s^4, and Cov(x0, x1) =
b E[x0^3] = 0).  The port's target carries them (the JAX target carries
none); they are what a fit's moment errors are measured against.
"""

from __future__ import annotations

import math

import torch

from ..config import resolve_device
from .base import Target, make_target


def banana(d: int, curvature: float = 0.5, scale: float = 2.0,
           device=None) -> Target:
    """Banana target: standard normal warped by x1 -> x1 + b*(x0^2 - s^2);
    ``d`` >= 2."""
    from ..ops.fused_step import banana_score

    if d < 2:
        raise ValueError(f"banana needs d >= 2, got d={d}")
    device = resolve_device(device)

    def log_prob(x):
        x0 = x[..., 0]
        x1 = x[..., 1] - curvature * (x0 ** 2 - scale ** 2)
        tail = x[..., 2:]
        lp_head = -0.5 * (x0 / scale) ** 2 \
            - 0.5 * math.log(2 * math.pi * scale ** 2) \
            - 0.5 * x1 ** 2 - 0.5 * math.log(2 * math.pi)
        lp_tail = -0.5 * torch.sum(tail ** 2, -1) \
            - 0.5 * (d - 2) * math.log(2 * math.pi)
        return lp_head + lp_tail

    def sample(generator, n):
        z = torch.randn((n, d), generator=generator, device=generator.device)
        x0 = scale * z[:, 0]
        x1 = z[:, 1] + curvature * (x0 ** 2 - scale ** 2)
        return torch.cat([x0[:, None], x1[:, None], z[:, 2:]], -1).to(device)

    var = torch.ones(d, dtype=torch.float32)
    var[0] = scale ** 2
    var[1] = 1.0 + 2.0 * curvature ** 2 * scale ** 4
    params = torch.tensor([[curvature, scale]], dtype=torch.float32,
                          device=device)
    return make_target(log_prob, d, name=f"banana_d{d}",
                       mean=torch.zeros(d, dtype=torch.float32, device=device),
                       cov=torch.diag(var).to(device), sample=sample,
                       fused_score=(banana_score, (params,)))
