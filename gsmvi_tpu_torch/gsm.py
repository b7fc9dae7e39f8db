"""GSM fitter: Gaussian Score Matching VI on PyTorch.

Counterpart of ``gsmvi_tpu/gsm.py:36-329``: ``GSM(D, lp, lp_g)`` and
``fit(seed, ...) -> (mean, cov)``.  ``use_factor="auto"`` hands the fit to
``FactorGSM`` (the eps-coordinate route, whose step runs on the Hopper
kernels) exactly when the fitter's device is CUDA; elsewhere the dense route
runs: sample from the maintained Cholesky factor, score, the Gram-form
update (``ops/gsm.py``), and an on-device Cholesky accept/revert.  The dense
route is plain torch on every device (its TPU kernel is not ported yet).
"""

from __future__ import annotations

import warnings

import torch

from .config import default_dtype, pin_fp32
from .distributions import safe_cholesky
from .driver import EpsStream, make_chunk_runner, on_gpu, run_fit_loop
from .ops.gsm import gsm_update_stats
from .ops.gsm_factor import factor_to_cov
from .state import FactorVIState, VIState, accept_or_revert, init_state


class GSM:
    """Fit a dense-covariance Gaussian to a target via GSM updates.

    D    — dimensionality.
    lp   — target log-probability callable (monitors only).
    lp_g — score callable on tensors, (B, D) -> (B, D).
    device, dtype — where and in what precision the fit runs (default CPU,
           torch's default dtype).
    use_factor — "auto" (factor route on CUDA), True or False.
    use_fused, fused_score — passed to the delegated ``FactorGSM``; on CUDA
           a dtype or shape its kernels do not take raises unless
           ``use_fused=False``.
    """

    def __init__(self, D, lp, lp_g, device="cpu", dtype=None,
                 use_fused: "bool | str" = "auto",
                 use_factor: "bool | str" = "auto", fused_score=None):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.device = torch.device(device)
        self.dtype = default_dtype(dtype)
        self.use_fused = use_fused
        self.use_factor = use_factor
        self.fused_score = fused_score
        self._factor_fitter = None
        self._eps = EpsStream(self.device)
        self._runners = {}

    def _get_runner(self, batch_size: int):
        if batch_size not in self._runners:
            self._runners[batch_size] = make_chunk_runner(
                self._make_step(batch_size))
        return self._runners[batch_size]

    def _factor_route(self, batch_size: int) -> bool:
        """Whether this fit runs on the factor route: "auto" takes it
        exactly on CUDA; True forces it anywhere except the huge-batch
        regime (B >= 128 with 2B > D), where the rank-2B small space is no
        smaller than the dense problem and the dense route runs."""
        if self.use_factor is False:
            return False
        if batch_size >= 128 and 2 * batch_size > self.D:
            if self.use_factor is True:
                warnings.warn(
                    "use_factor=True requested but 2*batch_size > D — the "
                    "rank-2B eps small space is no smaller than the dense "
                    "problem; using the dense path", stacklevel=3)
            return False
        if self.use_factor is True:
            return True
        return on_gpu(self.device)

    def _get_factor_fitter(self):
        from .gsm_factor import FactorGSM

        if self._factor_fitter is None:
            self._factor_fitter = FactorGSM(
                self.D, self.lp, self.lp_g, device=self.device,
                dtype=self.dtype, use_fused=self.use_fused,
                fused_score=self.fused_score)
        return self._factor_fitter

    def _fit_factor(self, seed, mean, cov, batch_size, niter, nprint,
                    verbose, monitor, return_state, state):
        """Delegate one fit to the factor route, converting states at the
        boundary (the dense state's Cholesky factor is a valid sampling
        factor, so a resume there is distributional, not draw-exact)."""
        fg = self._get_factor_fitter()
        fstate = None
        if state is not None:
            fstate = FactorVIState(state.mean, state.chol, state.seed,
                                   state.step, state.n_accepted,
                                   state.n_rejected)
        fst = fg.fit(seed, mean=mean, cov=cov, batch_size=batch_size,
                     niter=niter, nprint=nprint, verbose=verbose,
                     monitor=monitor, return_state=True, state=fstate)
        cov_out = factor_to_cov(fst.factor)
        if not return_state:
            return fst.mean, cov_out
        return VIState(fst.mean, cov_out, safe_cholesky(cov_out), fst.seed,
                       fst.step, fst.n_accepted, fst.n_rejected)

    def _make_step(self, batch_size: int):
        """Dense step: sample, score, Gram-form update, accept/revert."""
        lp_g = self.lp_g
        d = self.D
        dtype = self.dtype

        def step(s: VIState) -> VIState:
            eps = self._eps(s.seed, s.step, batch_size, d, dtype)
            samples = s.mean + eps @ s.chol.T
            vs = lp_g(samples).to(dtype)
            dmu, ds = gsm_update_stats(samples, vs, s.mean, s.cov)
            return accept_or_revert(s, s.mean + dmu, s.cov + ds)

        return step

    def fit(self, seed: int, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None):
        """Run ``niter + 1`` GSM steps; returns (mean, cov), or the
        ``VIState`` with ``return_state``.  ``state`` resumes a saved fit
        (exactly on the dense route).  ``check_goodness`` is accepted for
        parity; checking is always on."""
        pin_fp32()
        if self._factor_route(batch_size):
            return self._fit_factor(seed, mean, cov, batch_size, niter,
                                    nprint, verbose, monitor, return_state,
                                    state)
        if self.fused_score is not None:
            warnings.warn(
                "fused_score is set but the factor route is inactive for "
                "this fit (use_factor=False, off-GPU, or a huge batch); the "
                "dense step has no whole-step kernel and fused_score is "
                "ignored", stacklevel=2)
        if state is None:
            state = init_state(seed, self.D, mean, cov, self.dtype,
                               self.device)
        state = run_fit_loop(state, niter, self._get_runner(batch_size),
                             monitor=monitor, lp=self.lp, nprint=nprint,
                             verbose=verbose, batch_size=batch_size)
        if return_state:
            return state
        return state.mean, state.cov
