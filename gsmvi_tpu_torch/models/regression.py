"""Bayesian logistic-regression posterior target (non-analytic,
real-world-shaped).

Counterpart of ``gsmvi_tpu/models/regression.py``: the same log-posterior,
its score by ``torch.func.grad``, and the analytic score as a kernel pair
(``ops.fused_step.logreg_score``).  No sampler and no moments, as in JAX.
``logistic_regression`` draws the data with numpy from an integer seed (the
JAX package draws them from a JAX key, so the two packages'
``logistic_regression`` give different targets for the same integer; carry
a JAX target over with ``logistic_regression_from_arrays`` on its
``pallas_score`` X and y).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .base import Target, make_target


def logistic_regression_from_arrays(x, y, prior_scale: float = 2.0,
                                    device=None) -> Target:
    """Posterior over the weights w (D,) of a logistic regression on numpy
    data ``x`` (N, D) and labels ``y`` (N,) or (1, N) in {0, 1}, prior
    N(0, prior_scale^2 I); the dtype is ``x``'s (the kernel pair takes
    float32).  Every array of the kernel pair stays on ``device``.

        lp(w) = sum_b [sum_n (y_n z_bn - softplus(z_bn)) - ||w_b||^2/(2 ps^2)],
        z = w X^T
    """
    from ..ops.fused_step import logreg_score

    device = resolve_device(device)
    x_np = np.array(x)
    dt = x_np.dtype
    n, d = x_np.shape
    x_t = torch.as_tensor(x_np, device=device)
    y_t = torch.as_tensor(np.array(y, dt).reshape(n), device=device)
    zero = torch.zeros((), dtype=x_t.dtype, device=device)

    def log_prob(w):
        z = w @ x_t.T                                      # (B, N)
        # softplus as logaddexp(z, 0), which is jax.nn.softplus
        # (F.softplus turns into the identity above its threshold).
        loglik = torch.sum(y_t * z - torch.logaddexp(z, zero), -1)
        logprior = -0.5 * torch.sum((w / prior_scale) ** 2, -1)
        return loglik + logprior

    params = (x_t, y_t.reshape(1, n),
              torch.full((1, 1), 1.0 / prior_scale ** 2, dtype=x_t.dtype,
                         device=device))
    return make_target(log_prob, d, name=f"logreg_d{d}_n{n}",
                       fused_score=(logreg_score, params))


def logistic_regression(seed: int, d: int, n_data: int = 200,
                        prior_scale: float = 2.0, device=None) -> Target:
    """Posterior on synthetic data drawn with numpy from ``seed``, in the
    JAX package's order: w_true ~ N(0, I), X ~ N(0, 1)/sqrt(d) (n_data, d),
    y_n = [u_n < sigmoid(X w_true)_n] with u ~ U(0, 1)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d)
    x = rng.standard_normal((n_data, d)) / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n_data) < p).astype(np.float32)
    return logistic_regression_from_arrays(x.astype(np.float32), y,
                                           prior_scale, device=device)
