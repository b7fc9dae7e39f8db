"""Neal's funnel target: x0 ~ N(0, sigma^2), x_i | x0 ~ N(0, exp(x0)).

Counterpart of ``gsmvi_tpu/models/funnel.py``: the same density, its score
by ``torch.func.grad``, an exact sampler, and the analytic score as a
kernel pair (``ops.fused_step.funnel_score``).
"""

from __future__ import annotations

import math

import torch

from ..config import resolve_device
from .base import Target, make_target


def funnel(d: int, sigma: float = 3.0, device=None) -> Target:
    """Neal's funnel in ``d`` dims (one scale coordinate + d-1 latents).
    No analytic moments: the optimal Gaussian q is well defined, but KL
    cannot reach zero."""
    from ..ops.fused_step import funnel_score

    device = resolve_device(device)

    def log_prob(x):
        x0 = x[..., 0]
        rest = x[..., 1:]
        lp0 = -0.5 * (x0 / sigma) ** 2 \
            - 0.5 * math.log(2 * math.pi * sigma ** 2)
        var = torch.exp(x0)
        lpr = -0.5 * torch.sum(rest ** 2, -1) / var \
            - 0.5 * (d - 1) * (x0 + math.log(2 * math.pi))
        return lp0 + lpr

    def sample(generator, n):
        gdev = generator.device
        x0 = sigma * torch.randn((n, 1), generator=generator, device=gdev)
        rest = torch.exp(x0 / 2) * torch.randn((n, d - 1), generator=generator,
                                               device=gdev)
        return torch.cat([x0, rest], -1).to(device)

    params = torch.tensor([[sigma, float(d)]], dtype=torch.float32,
                          device=device)
    return make_target(log_prob, d, name=f"funnel_d{d}", sample=sample,
                       fused_score=(funnel_score, (params,)))
