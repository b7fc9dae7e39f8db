"""Variational state threaded through the fit loops.

Counterpart of ``gsmvi_tpu/state.py:24-70`` (``VIState``, ``init_state``,
``accept_or_revert``) plus the factor state of ``gsm_factor.py:46-67``.

JAX carries a PRNG key in the state.  The port carries two host integers in
its place: ``seed``, the base of the eps stream, and ``step``, the absolute
step and so the position in that stream (eps for step ``s`` is drawn from a
generator seeded by ``driver.step_seed(seed, s)``).  Both are known on the
host without reading the device.  The accept counters are int32 tensors on
the fit's device, so a fit loop never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import default_dtype
from .distributions import safe_cholesky


class VIState(NamedTuple):
    """Dense GSM state: q = N(mean, cov), cov = chol @ chol.T."""

    mean: torch.Tensor        # (D,)
    cov: torch.Tensor         # (D, D)
    chol: torch.Tensor        # (D, D) lower Cholesky factor of cov
    seed: int                 # eps stream base
    step: int                 # absolute step = stream position
    n_accepted: torch.Tensor  # int32 count of accepted updates
    n_rejected: torch.Tensor  # int32 count of reverted updates


# Cold-start value of the carried NS-ladder statistics: inf fails every
# benign tier's gates, so the first window runs the long profile
# (``ops/bam_fused.py``, ``NS_STATS_INIT``).
NS_STATS_INIT = (float("inf"), float("inf"))


class FactorVIState(NamedTuple):
    """Factor state: S = factor @ factor.T (no maintained inverse: the eps
    method never applies F^{-1}).  ``ns_stats`` is FactorBaM's carried
    (gu_ub, lmax_ub) pair, measured by its kernels at the last
    feedback-cadence boundary or stiff step; host floats, because the BaM
    fitter reads them from the card once per step or block anyway.  The GSM
    fitters leave it at its default."""

    mean: torch.Tensor        # (D,)
    factor: torch.Tensor      # (D, D)
    seed: int
    step: int
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    ns_stats: tuple = NS_STATS_INIT

    @property
    def cov(self) -> torch.Tensor:
        from .ops.gsm_factor import factor_to_cov

        return factor_to_cov(self.factor)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_state(seed: int, d: int, mean=None, cov=None, dtype=None,
               device="cpu") -> VIState:
    """Initial ``VIState`` (defaults mean=0, cov=I)."""
    dtype = default_dtype(dtype)
    mean = (torch.zeros(d, dtype=dtype, device=device) if mean is None
            else torch.as_tensor(mean, dtype=dtype, device=device))
    cov = (torch.eye(d, dtype=dtype, device=device) if cov is None
           else torch.as_tensor(cov, dtype=dtype, device=device))
    return VIState(mean, cov, safe_cholesky(cov), int(seed), 0,
                   _zero_count(device), _zero_count(device))


def accept_or_revert(state: VIState, mean_new: torch.Tensor,
                     cov_new: torch.Tensor) -> VIState:
    """Accept the proposal iff its Cholesky factor is finite, else keep the
    old (mean, cov, chol); the select stays on the device."""
    chol_new = safe_cholesky(cov_new)
    good = torch.isfinite(chol_new).all()
    return VIState(
        torch.where(good, mean_new, state.mean),
        torch.where(good, cov_new, state.cov),
        torch.where(good, chol_new, state.chol),
        state.seed, state.step + 1,
        state.n_accepted + good.to(torch.int32),
        state.n_rejected + (~good).to(torch.int32))


def factor_state_from_numpy(mean, factor, seed: int, step: int,
                            n_accepted: int, n_rejected: int, dtype=None,
                            device="cpu", ns_stats=None) -> FactorVIState:
    """``FactorVIState`` from numpy arrays as the JAX package hands them
    over (``np.asarray(jax_array)``), so both packages start from the same
    state.  ``dtype`` defaults to the dtype of ``mean``; ``ns_stats`` (the
    JAX state's (2,) array) defaults to ``NS_STATS_INIT``."""
    mean = np.asarray(mean)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, mean.dtype)).dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    count = lambda n: torch.tensor(int(n), dtype=torch.int32, device=device)
    stats = (NS_STATS_INIT if ns_stats is None
             else tuple(float(x) for x in np.asarray(ns_stats, np.float32)))
    return FactorVIState(as_t(mean), as_t(factor), int(seed), int(step),
                         count(n_accepted), count(n_rejected), stats)
