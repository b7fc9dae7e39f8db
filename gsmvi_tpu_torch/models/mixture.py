"""Gaussian-mixture target (multi-modal benchmark).

Counterpart of ``gsmvi_tpu/models/mixture.py``: an equal-weight mixture of
identity-covariance Gaussians, its log-prob as a logsumexp over the
components, its score by ``torch.func.grad``, the analytic moments, an exact
sampler, and the analytic score as a kernel pair
(``ops.fused_step.mixture_score``).  ``gaussian_mixture`` draws the means
with numpy from an integer seed (the JAX package draws them from a JAX key,
so the two packages' ``gaussian_mixture`` give different targets for the
same integer; carry a JAX target over with ``gaussian_mixture_from_arrays``,
which takes its padded ``pallas_score`` arrays as they are).  The port does
not pad K: the JAX package pads it to a multiple of 8 for the TPU's tiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from .base import Target, make_target

# The logmask entry of a padding component (zero weight in the softmax).
PAD_LOGMASK = -1e30


def gaussian_mixture_from_arrays(means, logmask=None, device=None) -> Target:
    """Equal-weight mixture of N(m_k, I) from numpy ``means`` (K, D); the
    dtype is ``means``'s (the kernel pair takes float32).  ``logmask``
    (1, K), optional, is 0 for a component and -1e30 for a padding row (the
    JAX target's ``pallas_score[1]`` pair, given as it is); the kernel pair
    carries both arrays unchanged, the density and moments the real
    components only.

        lp(x) = sum_b [logsumexp_k(-||x_b - m_k||^2/2) - D/2 log 2pi - log K]
        mean = mean_k m_k,  cov = I + sum_k (m_k - mean)(m_k - mean)^T / K
    """
    from ..ops.fused_step import mixture_score

    device = resolve_device(device)
    means_np = np.array(means)
    dt = means_np.dtype
    k_all, d = means_np.shape
    mask_np = (np.zeros((1, k_all), dt) if logmask is None
               else np.array(logmask, dt).reshape(1, k_all))
    real = mask_np[0] == 0
    if not np.all(real | (mask_np[0] <= PAD_LOGMASK)):
        raise ValueError("logmask: 0 (component) or -1e30 (padding) entries "
                         "required")
    comps = means_np[real]
    k = comps.shape[0]
    if k < 1:
        raise ValueError("logmask masks every component")
    const = -0.5 * d * math.log(2.0 * math.pi) - math.log(k)
    comps_t = torch.as_tensor(comps, device=device)

    def log_prob(x):
        diff = x[..., None, :] - comps_t                   # (..., K, D)
        return torch.logsumexp(-0.5 * torch.sum(diff * diff, -1), -1) + const

    def sample(generator, n):
        gdev = generator.device
        idx = torch.randint(0, k, (n,), generator=generator, device=gdev)
        z = torch.randn((n, d), generator=generator, device=gdev,
                        dtype=comps_t.dtype)
        return comps_t[idx.to(device)] + z.to(device)

    mix_mean = comps.mean(axis=0)
    dev = comps - mix_mean
    mix_cov = np.eye(d, dtype=dt) + dev.T @ dev / k
    params = (torch.as_tensor(means_np, device=device),
              torch.as_tensor(mask_np, device=device))
    return make_target(log_prob, d, name=f"gmm_d{d}_k{k}",
                       mean=torch.as_tensor(mix_mean, device=device),
                       cov=torch.as_tensor(mix_cov.astype(dt), device=device),
                       sample=sample, fused_score=(mixture_score, params))


def gaussian_mixture(seed: int, d: int, n_components: int = 3,
                     separation: float = 3.0, device=None) -> Target:
    """Equal-weight mixture of ``n_components`` N(m_k, I), the means
    ``separation * N(0, I)`` drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    means = separation * rng.standard_normal((n_components, d))
    return gaussian_mixture_from_arrays(means.astype(np.float32),
                                        device=device)
