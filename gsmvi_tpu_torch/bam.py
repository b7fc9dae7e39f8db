"""BaM fitter: Batch-and-Match VI (arXiv:2402.14758) on PyTorch.

Counterpart of ``gsmvi_tpu/bam.py:39-280``: ``BaM(D, lp, lp_g,
use_lowrank, jit_compile)`` and ``fit(seed, regf, ...) -> (mean, cov)``.
``use_factor="auto"`` hands the fit to ``FactorBaM`` (the factor-coordinate
route, whose step runs on the Hopper kernels) exactly when the fitter's
device is CUDA; elsewhere the dense route runs in plain torch: sample from
the maintained Cholesky factor, score, the similarity-form update
(``ops/bam.py``, through the exact rank-(B+1) low-rank algebra when
4 (B+1) <= D), and an on-device Cholesky accept/revert.  The reference's
resample-on-failure loop keeps its semantics: with ``retries > 0`` a failed
proposal is redrawn from the disjoint retry stream, which reads the
validity flag on the host.  ``regf`` is a pure function of the iteration
index (``Regularizers``).
"""

from __future__ import annotations

import torch

from .config import default_dtype, pin_fp32
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, make_chunk_runner, on_gpu,
                     retry_seed, run_fit_loop)
from .ops.bam import Regularizers, bam_lowrank_update, bam_update  # noqa: F401 (re-export)
from .ops.gsm_factor import factor_to_cov
from .state import FactorVIState, VIState, accept_or_revert, init_state


class BaM:
    """Fit a dense-covariance Gaussian by Batch-and-Match updates.

    D    — dimensionality.
    lp   — target log-probability callable (monitors only).
    lp_g — score callable on tensors, (B, D) -> (B, D).
    use_lowrank — force the low-rank algebra (``auto_lowrank`` takes it
           when 4 (B+1) <= D; U is exactly rank B+1, so both agree).
    jit_compile — accepted for parity; only True (the tensor-callable
           route) is ported.
    device, dtype — where and in what precision the fit runs.
    sqrt_method — the dense root: "auto" (= "eigh" on CPU and GPU, as the
           JAX package picks off the TPU), "eigh" or "newton".
    use_factor — "auto" (factor route on CUDA), True or False.
    use_fused, fused_score — passed to the delegated ``FactorBaM``.
    """

    def __init__(self, D, lp, lp_g, use_lowrank=False, jit_compile=True,
                 device="cpu", dtype=None, sqrt_method: str = "auto",
                 auto_lowrank: bool = True,
                 use_factor: "bool | str" = "auto",
                 use_fused: "bool | str" = "auto", fused_score=None):
        if not jit_compile:
            raise NotImplementedError(
                "jit_compile=False (the eager numpy-callable loop) is not "
                "ported; lp_g must take and return torch tensors")
        if sqrt_method == "auto":
            sqrt_method = "eigh"
        if sqrt_method not in ("eigh", "newton"):
            raise ValueError(f"sqrt_method must be 'auto', 'eigh' or "
                             f"'newton', got {sqrt_method!r}")
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.use_lowrank = use_lowrank
        self.jit_compile = jit_compile
        self.device = torch.device(device)
        self.dtype = default_dtype(dtype)
        self.sqrt_method = sqrt_method
        self.auto_lowrank = auto_lowrank
        self.use_factor = use_factor
        self.use_fused = use_fused
        self.fused_score = fused_score
        self._factor_fitter = None
        self._eps = EpsStream(self.device)
        self._runners = RunnerCache()

    def _factor_route(self) -> bool:
        """Whether ``fit`` runs on the factor route: "auto" exactly on a
        CUDA device; True forces it anywhere (it is exact everywhere)."""
        if self.use_factor is False:
            return False
        if self.use_factor is True:
            return True
        return on_gpu(self.device)

    def _get_factor_fitter(self):
        from .bam_factor import FactorBaM

        if self._factor_fitter is None:
            self._factor_fitter = FactorBaM(
                self.D, self.lp, self.lp_g, device=self.device,
                dtype=self.dtype, use_fused=self.use_fused,
                fused_score=self.fused_score)
        return self._factor_fitter

    def _fit_factor(self, seed, regf, mean, cov, batch_size, niter, nprint,
                    verbose, monitor, retries, return_state, state):
        """Delegate one fit to the factor route, converting states at the
        boundary (the dense state's Cholesky factor is a valid sampling
        factor)."""
        fb = self._get_factor_fitter()
        fstate = None
        if state is not None:
            fstate = FactorVIState(state.mean, state.chol, state.seed,
                                   state.step, state.n_accepted,
                                   state.n_rejected)
        fst = fb.fit(seed, regf, mean=mean, cov=cov, batch_size=batch_size,
                     niter=niter, nprint=nprint, verbose=verbose,
                     monitor=monitor, retries=retries, return_state=True,
                     state=fstate)
        cov_out = factor_to_cov(fst.factor)
        if not return_state:
            return fst.mean, cov_out
        return VIState(fst.mean, cov_out, safe_cholesky(cov_out), fst.seed,
                       fst.step, fst.n_accepted, fst.n_rejected)

    def _update(self, samples, vs, mean, cov, reg, jitter):
        """Dense update; the exact low-rank algebra when 4 (B+1) <= D."""
        b, d = samples.shape
        if self.use_lowrank or (self.auto_lowrank and 4 * (b + 1) <= d):
            return bam_lowrank_update(samples, vs, mean, cov, reg, jitter,
                                      sqrt_method=self.sqrt_method)
        return bam_update(samples, vs, mean, cov, reg, jitter,
                          sqrt_method=self.sqrt_method)

    def _make_step(self, batch_size: int, regf, retries: int, jitter: float):
        """Dense step: sample, score, update, resample while the proposal
        fails (``retries``), accept/revert."""
        d = self.D
        dtype = self.dtype

        def attempt(s: VIState, eps, reg):
            samples = s.mean + eps @ s.chol.T
            vs = self.lp_g(samples).to(dtype)
            mean_new, cov_new = self._update(samples, vs, s.mean, s.cov, reg,
                                             jitter)
            good = torch.isfinite(safe_cholesky(cov_new)).all()
            return mean_new, cov_new, good

        def step(s: VIState) -> VIState:
            reg = torch.as_tensor(regf(s.step), dtype=dtype)
            mean_new, cov_new, good = attempt(
                s, self._eps(s.seed, s.step, batch_size, d, dtype), reg)
            tries = 0
            while tries < retries and not bool(good):
                tries += 1
                eps = self._eps(retry_seed(s.seed, s.step), tries,
                                batch_size, d, dtype)
                mean_new, cov_new, good = attempt(s, eps, reg)
            return accept_or_revert(s, mean_new, cov_new)

        return step

    def fit(self, seed: int, regf, mean=None, cov=None, batch_size=2,
            niter=5000, nprint=10, verbose=True, check_goodness=True,
            monitor=None, retries=10, jitter=1e-6, return_state=False,
            state=None):
        """Run ``niter + 1`` BaM steps; returns (mean, cov), or the
        ``VIState`` with ``return_state``.  ``jitter`` lands on V's
        diagonal on the dense route and is inert on the factor route (its
        proposal is PD by construction).  ``check_goodness`` is accepted
        for parity; checking is always on."""
        pin_fp32()
        if self._factor_route():
            return self._fit_factor(seed, regf, mean, cov, batch_size, niter,
                                    nprint, verbose, monitor, retries,
                                    return_state, state)
        if state is None:
            state = init_state(seed, self.D, mean, cov, self.dtype,
                               self.device)
        run_chunk = self._runners.get(
            (batch_size, retries, jitter), (regf,),
            lambda: make_chunk_runner(
                self._make_step(batch_size, regf, retries, jitter)))
        state = run_fit_loop(state, niter, run_chunk,
                             monitor=monitor, lp=self.lp, nprint=nprint,
                             verbose=verbose, batch_size=batch_size)
        if return_state:
            return state
        return state.mean, state.cov
