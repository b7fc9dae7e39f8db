"""GSM fitter: Gaussian Score Matching VI on PyTorch.

Counterpart of ``gsmvi_tpu/gsm.py:36-397``: ``GSM(D, lp, lp_g)``,
``fit(seed, ...) -> (mean, cov)`` and ``fit_batch(seeds, ...)`` for K
independent replicas.  ``use_factor="auto"`` hands the fit to ``FactorGSM``
(the eps-coordinate route, whose step runs on the Hopper kernels) exactly
when the fitter's device is CUDA; elsewhere, with ``use_factor=False`` and
in the huge-batch regime (B >= 128 with 2B > D) the dense route runs:
sample from the maintained Cholesky factor, score, the Gram-form update,
and an on-device Cholesky accept/revert (``torch.linalg.cholesky_ex``,
as JAX computes it in XLA outside its kernel).  On a CUDA device in
float32 the dense update runs on K5 (``ops/gsm_step.py``) for every shape
in its range and raises outside it; ``use_fused=False`` runs the plain
update (``ops/gsm.py``) there, and off the card it always runs.

An ``lp_g`` that does not take tensors (a numpy score, as the reference
GSM-VI's users write it) takes the dense eager route, as in JAX
(``gsmvi_tpu/gsm.py:104-127``, ``:255-265``): each step samples on the
device, copies the rows to the host for the score and its result back
(``driver.host_score``), and runs the same dense update (K5 on the card).

``mesh=`` (``parallel.make_mesh``) makes ``fit`` data-parallel over its
``data_axis``, one rank per device: the factor route hands the mesh to
``FactorGSM``; the dense route has every rank draw the whole batch, score
its own rows, gather the rows and run the update replicated (K5 on the
card).  ``cov_sharding`` (``parallel.cov_sharding``) keeps the covariance
and its Cholesky factor as DTensors split by columns over a model axis and
runs the plain update on the ranks' column panels; ``chol_block=b``
factors the covariance by the blocked right-looking Cholesky
(``parallel.blocked_cholesky``), on those panels under ``cov_sharding``.
Both keep the dense route, as in JAX (``gsmvi_tpu/gsm.py:128-134``);
without ``chol_block`` a column-sharded covariance is factored whole on
every rank, as JAX's XLA Cholesky gathers it.
"""

from __future__ import annotations

import warnings

import torch

from .config import default_dtype, pin_fp32, resolve_device
from .distributions import safe_cholesky
from .driver import (EpsStream, broadcast_replicas, draw_replicas,
                     host_score, make_chunk_runner, on_gpu, run_fit_loop,
                     takes_tensors)
from .ops.gsm_factor import factor_to_cov
from .parallel.chol import make_blocked_cholesky
from .parallel.large_d import ColumnPanels, is_dtensor, panel_gsm_update
from .parallel.sharded import DataRows, no_mesh
from .ops.gsm_step import (GSM_STEP_BATCH_RANGE, GSM_STEP_DIM_RANGE,
                           gsm_step_supports, gsm_update_fused,
                           gsm_update_replicas_reference)
from .state import (FactorVIState, VIState, accept_or_revert, init_state,
                    per_replica)
from .utils.profiling import NO_SPAN, fit_call, reset_counts, span


class GSM:
    """Fit a dense-covariance Gaussian to a target via GSM updates.

    D    — dimensionality.
    lp   — target log-probability callable (monitors only).
    lp_g — score callable, (B, D) -> (B, D), row by row: on tensors, or on
           numpy arrays (the dense eager host loop; ``driver.host_score``).
    device, dtype — where and in what precision the fit runs (default: the
           CUDA card, ``"cuda"``; raises without one; torch's default dtype).
    use_factor — "auto" (factor route on CUDA), True or False.
    use_fused — on CUDA the step runs the kernels (the dense route's K5, the
           delegated ``FactorGSM``'s K1/K2/K6) and a dtype or shape they do
           not take raises, unless ``use_fused=False``.
    fused_score — passed to the delegated ``FactorGSM``.
    mesh, data_axis — a data-parallel ``fit`` over that mesh axis.
    cov_sharding, chol_block — a column-sharded covariance and the blocked
           Cholesky (the module docstring).
    """

    def __init__(self, D, lp, lp_g, device=None, dtype=None,
                 use_fused: "bool | str" = "auto",
                 use_factor: "bool | str" = "auto", fused_score=None,
                 mesh=None, data_axis: str = "data", cov_sharding=None,
                 chol_block=None):
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.device = resolve_device(device)
        self.dtype = default_dtype(dtype)
        self.use_fused = use_fused
        self.use_factor = use_factor
        self.fused_score = fused_score
        self.mesh = mesh
        self.data_axis = data_axis
        self.cov_sharding = cov_sharding
        self.chol_block = chol_block
        if chol_block is not None or cov_sharding is not None:
            self.chol_fn = make_blocked_cholesky(
                D if chol_block is None else chol_block, cov_sharding)
        else:
            self.chol_fn = None
        self._factor_fitter = None
        # What the last public fit call did (``utils.profiling.FIT_COUNTS``;
        # on the factor route ``FactorGSM``'s counts, copied); runners hold
        # this dict, so each call resets it in place.
        self.fit_counts = {}
        self._reset_counts()
        self._eps = EpsStream(self.device, self.fit_counts)
        self._runners = {}

    def _reset_counts(self) -> None:
        reset_counts(self.fit_counts)

    def _get_runner(self, batch_size: int, replicas: bool = False,
                    host: bool = False):
        fused = self._dense_fused(batch_size)
        key = (batch_size, fused, replicas, host)
        if key not in self._runners:
            step = self._make_step(batch_size, fused, host)
            if replicas and not fused:
                step = per_replica(step)
            self._runners[key] = make_chunk_runner(step,
                                                   counts=self.fit_counts)
            self.fit_counts["runner_builds"] += 1
        return self._runners[key]

    def _dense_fused(self, batch_size: int) -> bool:
        """Whether the dense step runs K5: on a CUDA device unless
        ``use_fused=False``.  There K5 takes float32 with B in
        ``GSM_STEP_BATCH_RANGE`` and D in ``GSM_STEP_DIM_RANGE``; anything
        else raises rather than running the plain update on the card.  A
        column-sharded covariance runs the plain update on its panels (the
        kernel keeps S whole), by design."""
        if (self.use_fused is False or self.cov_sharding is not None
                or not on_gpu(self.device)):
            return False
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"dtype {self.dtype}: the dense route's CUDA kernel takes "
                "float32; pass use_fused=False for the plain-torch step on "
                "the card")
        if not gsm_step_supports(batch_size, self.D):
            raise ValueError(
                f"B={batch_size}, D={self.D}: the dense route's CUDA kernel "
                f"takes B in {list(GSM_STEP_BATCH_RANGE)} and D in "
                f"{list(GSM_STEP_DIM_RANGE)}; pass use_fused=False for the "
                "plain-torch step on the card")
        return True

    def _host(self, batch_size: int) -> bool:
        """Whether ``lp_g`` is a host (numpy) callable (``takes_tensors``
        probes it once per fit on the fit's device)."""
        return not takes_tensors(self.lp_g, batch_size, self.D, self.dtype,
                                 self.device)

    def _factor_route(self, batch_size: int, host: bool = False) -> bool:
        """Whether this fit runs on the factor route: "auto" takes it
        exactly on CUDA; True forces it anywhere except the huge-batch
        regime (B >= 128 with 2B > D), where the rank-2B small space is no
        smaller than the dense problem and the dense route runs.  A host
        ``lp_g`` always runs the dense route (``gsmvi_tpu/gsm.py:118-124``,
        with its warning under ``use_factor=True``), and so do
        ``cov_sharding`` and ``chol_block``, which describe a dense
        covariance."""
        if host or self.use_factor is False:
            if host and self.use_factor is True:
                warnings.warn(
                    "use_factor=True requested but lp_g does not take "
                    "tensors; using the dense eager host loop", stacklevel=3)
            return False
        if self.chol_fn is not None:
            if self.use_factor is True:
                warnings.warn(
                    "use_factor=True requested but cov_sharding/chol_block "
                    "describe a partitioned dense covariance the factor "
                    "route cannot honor; using the dense sharded path",
                    stacklevel=3)
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
                fused_score=self.fused_score, mesh=self.mesh,
                data_axis=self.data_axis)
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
        self.fit_counts.update(fg.fit_counts)
        if not return_state:
            return fst.mean, factor_to_cov(fst.factor)
        return self._dense_state(fst)

    @staticmethod
    def _dense_state(fst: FactorVIState) -> VIState:
        """The ``VIState`` of a (stacked) factor-route state."""
        cov = factor_to_cov(fst.factor)
        return VIState(fst.mean, cov, safe_cholesky(cov), fst.seed, fst.step,
                       fst.n_accepted, fst.n_rejected)

    def _place(self, x):
        """``x`` in the ``cov_sharding`` layout (a DTensor stays)."""
        return x if is_dtensor(x) else self.cov_sharding.place(x)

    def _warn_fused_score(self):
        if self.fused_score is not None:
            warnings.warn(
                "fused_score is set but the factor route is inactive for "
                "this fit (use_factor=False, off-GPU, or a huge batch); the "
                "dense step has no whole-step kernel and fused_score is "
                "ignored", stacklevel=3)

    def _make_step(self, batch_size: int, fused: bool, host: bool = False):
        """Dense step: sample, score, Gram-form update (K5 or its plain
        version), accept/revert.  With ``fused`` it also takes stacked
        replicas (K5 and the accept/revert run batched).  ``host``: the
        score is a numpy callable, called through ``host_score``."""
        lp_g = host_score(self.lp_g) if host else self.lp_g
        d = self.D
        dtype = self.dtype
        counts = self.fit_counts
        update = gsm_update_fused if fused else gsm_update_replicas_reference
        rows = DataRows(self.mesh, self.data_axis)
        if self.cov_sharding is not None:
            p = ColumnPanels(self.cov_sharding, d)

            def step(s: VIState) -> VIState:
                eps = self._eps(s.seed, s.step, batch_size, d, dtype)
                ef, vs = rows.score(lp_g, eps, s.mean, p.local(s.chol), dtype,
                                    panels=p)
                mean_new, cov_new = panel_gsm_update(s.mean + ef, vs, s.mean,
                                                     p.local(s.cov), p)
                return accept_or_revert(s, mean_new, p.wrap(cov_new),
                                        self.chol_fn)

            return step
        def step(s: VIState) -> VIState:
            if isinstance(s.seed, tuple):       # stacked replicas, one device
                eps = draw_replicas(self._eps, s.seed, s.step, batch_size, d,
                                    dtype)
                samples = s.mean[..., None, :] + eps @ s.chol.mT
                vs = lp_g(samples.reshape(-1, d)).to(dtype).reshape(
                    samples.shape)
            else:
                ef, vs = rows.score(lp_g, self._eps(s.seed, s.step,
                                                    batch_size, d, dtype),
                                    s.mean, s.chol, dtype)
                samples = s.mean + ef
            counts["kernel_calls"] += int(fused)
            with span("gsmvi.block.launch") if fused else NO_SPAN:
                mean_new, cov_new = update(samples, vs.contiguous(), s.mean,
                                           s.cov)
            return accept_or_revert(s, mean_new, cov_new, self.chol_fn)

        return step

    def fit(self, seed: int, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None):
        """Run ``niter + 1`` GSM steps; returns (mean, cov), or the
        ``VIState`` with ``return_state``.  ``state`` resumes a saved fit
        (exactly on the dense route).  ``check_goodness`` is accepted for
        parity; checking is always on.  A numpy ``lp_g`` runs the dense
        eager host loop (the module docstring)."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            host = self._host(batch_size)
            if self._factor_route(batch_size, host):
                return self._fit_factor(seed, mean, cov, batch_size, niter,
                                        nprint, verbose, monitor,
                                        return_state, state)
            self._warn_fused_score()
            if state is None:
                state = init_state(seed, self.D, mean, cov, self.dtype,
                                   self.device)
            if host and verbose:
                print("lp_g does not take tensors; using the eager host loop")
            if self.cov_sharding is not None:
                state = state._replace(cov=self._place(state.cov),
                                       chol=self._place(state.chol))
            else:
                # K5 takes contiguous operands (a caller's covariance may not
                # be).
                state = state._replace(mean=state.mean.contiguous(),
                                       cov=state.cov.contiguous())
            run_chunk = self._get_runner(batch_size, host=host)
            call.phase("loop")
            state = run_fit_loop(state, niter, run_chunk, monitor=monitor,
                                 lp=self.lp, nprint=nprint, verbose=verbose,
                                 batch_size=batch_size)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, state.cov

    def fit_batch(self, seeds, mean=None, cov=None, batch_size=2, niter=5000,
                  return_state=False):
        """Fit K independent replicas together, one per seed in ``seeds``;
        returns (means (K, D), covs (K, D, D)), or the stacked ``VIState``.

        ``mean``/``cov`` are broadcast to every replica or carry a leading
        K axis (per-replica warm starts, random restarts).  Replica i draws
        what ``fit(seeds[i])`` draws.  The factor route delegates to
        ``FactorGSM.fit_batch`` (``small_solver="auto"``) and converts the
        states at the boundary; the dense route runs the K replicas through
        one batched K5 and one batched ``cholesky_ex`` per step on the card
        (its plain step one replica at a time elsewhere).  A numpy ``lp_g``
        takes the dense route, JAX's rule (``gsmvi_tpu/gsm.py:356``); JAX's
        vmapped step then cannot call it, the port's eager step calls it on
        the K·B stacked rows (one replica's rows at a time off the card).
        Monitors are not supported (``fit`` takes them).
        """
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            no_mesh(self, "GSM.fit_batch")
            seeds = tuple(int(s) for s in seeds)
            host = self._host(batch_size)
            if self._factor_route(batch_size, host):
                fg = self._get_factor_fitter()
                fst = fg.fit_batch(seeds, mean=mean, cov=cov,
                                   batch_size=batch_size, niter=niter,
                                   return_state=True)
                self.fit_counts.update(fg.fit_counts)
                if return_state:
                    return self._dense_state(fst)
                return fst.mean, factor_to_cov(fst.factor)
            self._warn_fused_score()
            k, d, dtype, dev = len(seeds), self.D, self.dtype, self.device
            means0 = broadcast_replicas(mean, torch.zeros(d), k, (d,), dtype,
                                        dev)
            covs0 = broadcast_replicas(cov, torch.eye(d), k, (d, d), dtype,
                                       dev)
            zero = torch.zeros(k, dtype=torch.int32, device=dev)
            state = VIState(means0, covs0, safe_cholesky(covs0), seeds, 0,
                            zero, zero)
            run = self._get_runner(batch_size, replicas=True, host=host)
            call.phase("loop")
            state = run(state, niter + 1)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, state.cov
