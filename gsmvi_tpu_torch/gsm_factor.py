"""FactorGSM: the Cholesky-free GSM fitter on factor state S = F F^T.

Counterpart of ``gsmvi_tpu/gsm_factor.py:46-527`` with ``method="eps"``.
Sampling is ``mu + eps F^T``, the update is the rank-2B eps-coordinate
correction of F (``ops/gsm_eps.py``), and the hot loop factors nothing
D-sized.  On a CUDA device, at shapes the kernels take, a step runs on the
hand-written Hopper kernels (``ops/fused_step.py``):

- ``"update"`` mode (opaque ``lp_g``): sampling product and score in torch,
  then K1 ``gsm_eps_update_fused`` (update, residual gates, select);
- ``"step"`` mode (``fused_score=(score_fn, params)``, e.g.
  ``target.fused_score``): K2 ``make_fused_eps_multistep`` runs
  ``steps_per_call`` whole steps per call with the score inside.

On a CUDA device a dtype or shape the kernels do not take raises;
``use_fused=False`` is the one plain route there.  Off the card, and with
``use_fused=False``, the step is the exact plain-torch eps step with (2B)^2
Choleskys.  Eps for absolute
step ``s`` is drawn from a generator seeded by ``driver.step_seed(seed, s)``
on every path: trajectories do not change with ``steps_per_call`` or with
the chunk cadence, and a saved state resumes exactly.
"""

from __future__ import annotations

import torch

from .config import default_dtype, pin_fp32
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, make_chunk_runner, on_gpu,
                     run_fit_loop)
from .ops.fused_step import (KERNEL_BATCH_RANGE, KERNEL_DIM_RANGE,
                             gsm_eps_update_fused, kernel_supports,
                             make_fused_eps_multistep, ns_iters_for_batch)
from .ops.gsm_eps import apply_eps_step
from .ops.gsm_factor import factor_to_cov
from .state import FactorVIState

__all__ = ["FactorGSM", "FactorVIState"]


class FactorGSM:
    """Cholesky-free GSM fitter; ``fit`` surface matches ``GSM.fit``."""

    def __init__(self, D, lp, lp_g, device="cpu", dtype=None,
                 method: str = "eps", use_fused: "bool | str" = "auto",
                 fused_score=None, steps_per_call=None,
                 pallas_precision: str = "highest", ns_iters=None):
        """``use_fused`` ("auto"/True/False): on a CUDA device the step runs
        on the CUDA kernels unless it is False (see ``_fused_mode``); with
        ``fused_score`` the whole step (sampling product, score, update,
        select) runs ``steps_per_call`` sub-steps per kernel call.

        ``pallas_precision`` names the precision of the O(B D^2) products,
        as in the JAX package; only "highest" (true fp32) is ported.
        ``ns_iters`` overrides the Newton-Schulz sweep counts (sqrt1, inv1,
        inv2, sqrt2, inv3); the default is batch-aware
        (``ns_iters_for_batch``).  The residual gates catch catastrophic
        loss, not slow bias: validate convergence when changing it.
        """
        if method != "eps":
            raise NotImplementedError(
                f"method={method!r}: only the 'eps' factor method is ported")
        if pallas_precision != "highest":
            raise NotImplementedError(
                f"pallas_precision={pallas_precision!r}: only 'highest' "
                "(true fp32) is ported")
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.device = torch.device(device)
        self.dtype = default_dtype(dtype)
        self.method = method
        self.use_fused = use_fused
        self.fused_score = fused_score
        # Sub-steps per K2 call.  Trajectories do not depend on it.
        self.steps_per_call = (steps_per_call if steps_per_call is not None
                               else (16 if D <= 128 else 8))
        self.pallas_precision = pallas_precision
        self.ns_iters = tuple(ns_iters) if ns_iters is not None else None
        self._eps = EpsStream(self.device)
        self._runners = RunnerCache()

    def _fused_mode(self, batch_size: int):
        """None | "update" | "step": which kernel path this config runs.

        None off the card or with ``use_fused=False``.  On a CUDA device the
        kernels take float32 with B in ``KERNEL_BATCH_RANGE`` and D in
        ``KERNEL_DIM_RANGE``; anything else raises rather than running the
        plain step on the card."""
        if self.use_fused is False or not on_gpu(self.device):
            return None
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"dtype {self.dtype}: the CUDA kernels take float32; pass "
                "use_fused=False for the plain-torch step on the card")
        if not kernel_supports(batch_size, self.D):
            raise ValueError(
                f"B={batch_size}, D={self.D}: the CUDA kernels take B in "
                f"{list(KERNEL_BATCH_RANGE)} and D in {list(KERNEL_DIM_RANGE)}"
                "; pass use_fused=False for the plain-torch step on the card")
        return "step" if self.fused_score is not None else "update"

    def _iters(self, batch_size: int):
        return ns_iters_for_batch(batch_size, self.ns_iters)

    def _get_runner(self, batch_size: int):
        mode = self._fused_mode(batch_size)
        score_objs = ()
        if self.fused_score is not None:
            score_objs = (self.fused_score[0], *self.fused_score[1])

        def build():
            if mode == "step":
                return self._make_fused_runner(batch_size)
            return make_chunk_runner(self._make_step(batch_size))

        return self._runners.get(
            (batch_size, mode, self.steps_per_call, self._iters(batch_size),
             self.dtype), score_objs, build)

    def _draw(self, state, batch_size: int, offset: int = 0):
        return self._eps(state.seed, state.step + offset, batch_size, self.D,
                         self.dtype)

    def _make_step(self, batch_size: int):
        """One-step runner of the "update" mode (K1) or the plain route;
        the "step" mode runs on ``_make_fused_runner``."""
        lp_g = self.lp_g
        dtype = self.dtype
        mode = self._fused_mode(batch_size)
        iters = self._iters(batch_size)

        def advance(s, mean, f, good):
            n_acc = good.to(torch.int32)
            return FactorVIState(mean, f, s.seed, s.step + 1,
                                 s.n_accepted + n_acc,
                                 s.n_rejected + (1 - n_acc))

        if mode == "update":
            def step(s: FactorVIState) -> FactorVIState:
                eps = self._draw(s, batch_size)
                ef = eps @ s.factor.T
                vs = lp_g(s.mean + ef).to(torch.float32).contiguous()
                mean, f, good = gsm_eps_update_fused(eps, vs, s.mean,
                                                     s.factor, iters=iters,
                                                     ef=ef)
                return advance(s, mean, f, good)

            return step

        def step(s: FactorVIState) -> FactorVIState:
            eps = self._draw(s, batch_size)
            vs = lp_g(s.mean + eps @ s.factor.T).to(dtype)
            mean, f, good = apply_eps_step(s.mean, s.factor, eps, vs)
            return advance(s, mean, f, good)

        return step

    def _make_fused_runner(self, batch_size: int):
        """Chunk runner of the "step" mode on K2: blocks of
        ``steps_per_call`` sub-steps, a chunk remainder as one call with
        ``nmax < spc``.  Each block's eps rows are the per-absolute-step
        draws, so the trajectory does not depend on spc."""
        score_fn, params = self.fused_score
        spc = self.steps_per_call
        multi = make_fused_eps_multistep(score_fn, len(params), batch_size,
                                         self.D, spc,
                                         iters=self._iters(batch_size))

        def block(s: FactorVIState, nmax: int) -> FactorVIState:
            eps_block = torch.cat([self._draw(s, batch_size, j)
                                   for j in range(spc)])
            mean, f, n_acc = multi(nmax, eps_block, s.mean, s.factor, *params)
            return FactorVIState(mean, f, s.seed, s.step + nmax,
                                 s.n_accepted + n_acc,
                                 s.n_rejected + (nmax - n_acc))

        def run_chunk(state: FactorVIState, k: int) -> FactorVIState:
            n_multi, rem = divmod(k, spc)
            for _ in range(n_multi):
                state = block(state, spc)
            if rem:
                state = block(state, rem)
            return state

        return run_chunk

    def fit(self, seed: int, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None):
        """Run ``niter + 1`` steps; returns (mean, cov), or the
        ``FactorVIState`` with ``return_state``.  ``state`` resumes a saved
        trajectory exactly, ignoring ``seed``/``mean``/``cov``.
        ``check_goodness`` is accepted for parity; checking is always on."""
        pin_fp32()
        dev, dtype = self.device, self.dtype
        if state is None:
            mean0 = (torch.zeros(self.D, dtype=dtype, device=dev)
                     if mean is None
                     else torch.as_tensor(mean, dtype=dtype, device=dev))
            f0 = (torch.eye(self.D, dtype=dtype, device=dev) if cov is None
                  else safe_cholesky(torch.as_tensor(cov, dtype=dtype,
                                                     device=dev)))
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            state = FactorVIState(mean0, f0, int(seed), 0, zero, zero)
        # The kernels take contiguous operands (a LAPACK factor may not be).
        state = state._replace(mean=state.mean.contiguous(),
                               factor=state.factor.contiguous())
        state = run_fit_loop(
            state, niter, self._get_runner(batch_size), monitor=monitor,
            monitor_params=lambda s: [s.mean, factor_to_cov(s.factor)],
            lp=self.lp, nprint=nprint, verbose=verbose,
            batch_size=batch_size)
        if return_state:
            return state
        return state.mean, factor_to_cov(state.factor)
