"""Variational state threaded through the fit loops.

Counterpart of ``gsmvi_tpu/state.py:24-70`` (``VIState``, ``init_state``,
``accept_or_revert``) plus the factor state of ``gsm_factor.py:46-67``.

JAX carries a PRNG key in the state.  The port carries two host integers in
its place: ``seed``, the base of the eps stream, and ``step``, the absolute
step and so the position in that stream (eps for step ``s`` is drawn from a
generator seeded by ``driver.step_seed(seed, s)``).  Both are known on the
host without reading the device.  The accept counters are int32 tensors on
the fit's device, so a fit loop never waits for the device.

``fit_batch`` keeps K replicas in the same states, stacked (the
counterpart of the vmapped states of ``gsmvi_tpu/gsm_factor.py:652-662``):
means (K, D), covariances, factors and Cholesky factors (K, D, D), ``seed``
a tuple of K ints, one host ``step`` (the replicas advance together),
(K,) int32 counters and, for FactorBaM, K ``ns_stats`` pairs.
``replica``/``stack_replicas`` move between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .distributions import safe_cholesky
from .parallel.large_d import is_dtensor


class VIState(NamedTuple):
    """Dense GSM state: q = N(mean, cov), cov = chol @ chol.T."""

    mean: torch.Tensor        # (D,) — (K, D) for K replicas
    cov: torch.Tensor         # (D, D)
    chol: torch.Tensor        # (D, D) lower Cholesky factor of cov
    seed: int                 # eps stream base (a K-tuple for replicas)
    step: int                 # absolute step = stream position
    n_accepted: torch.Tensor  # int32 count of accepted updates
    n_rejected: torch.Tensor  # int32 count of reverted updates


# Cold-start value of the carried NS-ladder statistics: inf fails every
# benign tier's gates, so the first window runs the long profile
# (``ops/bam_fused.py``, ``NS_STATS_INIT``).
NS_STATS_INIT = (float("inf"), float("inf"))


class FactorVIState(NamedTuple):
    """Factor state: S = factor @ factor.T.  ``ns_stats`` is FactorBaM's
    carried (gu_ub, lmax_ub) pair, measured by its kernels at the last
    feedback-cadence boundary or stiff step; host floats, because the BaM
    fitter reads them from the card once per step or block anyway.  The GSM
    fitters leave it at its default.  ``finv`` is the maintained inverse of
    ``factor`` of FactorGSM's twophase and qr methods; None (JAX's empty
    placeholder) for the eps method, which never applies F^{-1}."""

    mean: torch.Tensor        # (D,)
    factor: torch.Tensor      # (D, D)
    seed: int
    step: int
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    ns_stats: tuple = NS_STATS_INIT
    finv: "torch.Tensor | None" = None   # (D, D), or None

    @property
    def cov(self) -> torch.Tensor:
        from .ops.gsm_factor import factor_to_cov

        return factor_to_cov(self.factor)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init_state(seed: int, d: int, mean=None, cov=None, dtype=None,
               device=None) -> VIState:
    """Initial ``VIState`` (defaults mean=0, cov=I, the CUDA card)."""
    device = resolve_device(device)
    dtype = default_dtype(dtype)
    mean = (torch.zeros(d, dtype=dtype, device=device) if mean is None
            else torch.as_tensor(mean, dtype=dtype, device=device))
    cov = (torch.eye(d, dtype=dtype, device=device) if cov is None
           else torch.as_tensor(cov, dtype=dtype, device=device))
    return VIState(mean, cov, safe_cholesky(cov), int(seed), 0,
                   _zero_count(device), _zero_count(device))


def accept_or_revert(state: VIState, mean_new: torch.Tensor,
                     cov_new: torch.Tensor, chol_fn=None) -> VIState:
    """Accept the proposal iff its Cholesky factor is finite, else keep the
    old (mean, cov, chol); the select stays on the device.  Stacked
    replicas are decided one by one (one batched ``cholesky_ex``).

    ``chol_fn`` (default ``safe_cholesky``) factors ``cov_new``; it must
    give NaN where the matrix is not positive definite, as
    ``parallel.blocked_cholesky`` does (``GSM(chol_block=...)``).  With a
    column-sharded covariance (a DTensor, ``GSM(cov_sharding=...)``) the
    finiteness is decided over every rank's panel and the select runs on
    the panels."""
    chol_new = (safe_cholesky if chol_fn is None else chol_fn)(cov_new)
    if is_dtensor(chol_new):
        from .parallel.large_d import all_finite, select

        good = all_finite(chol_new)
        sel = lambda new, old: select(good, new, old)
    else:
        good = torch.isfinite(chol_new).flatten(-2).all(-1)
        gc = good[..., None, None]
        sel = lambda new, old: torch.where(gc, new, old)
    return VIState(
        torch.where(good[..., None], mean_new, state.mean),
        sel(cov_new, state.cov), sel(chol_new, state.chol),
        state.seed, state.step + 1,
        state.n_accepted + good.to(torch.int32),
        state.n_rejected + (~good).to(torch.int32))


def _stacked_stats(ns_stats) -> bool:
    """Whether ``ns_stats`` holds one (gu_ub, lmax_ub) pair per replica
    (FactorBaM's ``fit_batch``) rather than one pair shared by all (the GSM
    fitters' default)."""
    return len(ns_stats) > 0 and isinstance(ns_stats[0], tuple)


def replica(state, i: int):
    """Replica ``i`` of a stacked ``VIState``/``FactorVIState``, as the state
    of a single fit (views of the stacked tensors; its own ``ns_stats``
    pair where the replicas carry one each)."""
    extra = {}
    if getattr(state, "ns_stats", None) is not None and _stacked_stats(
            state.ns_stats):
        extra["ns_stats"] = state.ns_stats[i]
    return state._replace(seed=state.seed[i], **extra, **{
        name: value[i] for name, value in state._asdict().items()
        if torch.is_tensor(value)})


def stack_like(tensors) -> torch.Tensor:
    """``torch.stack`` that keeps the replicas' memory layout: matrices that
    are all column-major (as LAPACK's Cholesky factors come back) stay
    column-major in the stack, so that replica i's view enters every later
    product exactly as the single fit's tensor does (a BLAS product rounds
    differently on the transposed layout)."""
    if all(x.dim() == 2 and not x.is_contiguous() and x.mT.is_contiguous()
           for x in tensors):
        return torch.stack([x.mT for x in tensors]).mT
    return torch.stack(tensors)


def stack_replicas(states):
    """The stacked state of single-fit states that share ``step``
    (``stack_like`` per field); factor states keep each replica's
    ``ns_stats`` pair."""
    first = states[0]
    extra = {}
    if isinstance(first, FactorVIState):
        extra["ns_stats"] = tuple(tuple(s.ns_stats) for s in states)
    return first._replace(seed=tuple(s.seed for s in states), **extra, **{
        name: stack_like([getattr(s, name) for s in states])
        for name, value in first._asdict().items() if torch.is_tensor(value)})


def per_replica(step):
    """A single-fit step applied to every replica of a stacked state, one
    after another: each replica computes exactly what its single fit does."""
    return lambda s: stack_replicas([step(replica(s, i))
                                     for i in range(len(s.seed))])


def factor_state_from_numpy(mean, factor, seed: int, step: int,
                            n_accepted: int, n_rejected: int, dtype=None,
                            device=None, ns_stats=None) -> FactorVIState:
    """``FactorVIState`` from numpy arrays as the JAX package hands them
    over (``np.asarray(jax_array)``), so both packages start from the same
    state.  ``dtype`` defaults to the dtype of ``mean``; ``ns_stats`` (the
    JAX state's (2,) array) defaults to ``NS_STATS_INIT``; ``device`` to the
    CUDA card."""
    device = resolve_device(device)
    mean = np.asarray(mean)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, mean.dtype)).dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    count = lambda n: torch.tensor(int(n), dtype=torch.int32, device=device)
    stats = (NS_STATS_INIT if ns_stats is None
             else tuple(float(x) for x in np.asarray(ns_stats, np.float32)))
    return FactorVIState(as_t(mean), as_t(factor), int(seed), int(step),
                         count(n_accepted), count(n_rejected), stats)
