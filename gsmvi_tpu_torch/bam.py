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

``jit_compile=False``, or an ``lp_g`` that does not take tensors (a numpy
score), runs the dense eager loop, as JAX's ``_make_eager_step``
(``gsmvi_tpu/bam.py:240-275``) does: the same dense step with its
``retries`` and ``jitter``, a numpy score called on host copies of the rows
(``driver.host_score``).  The port's dense step is eager already, so a
tensor ``lp_g`` under ``jit_compile=False`` is called on tensors.

``mesh=`` (``parallel.make_mesh``) makes ``fit`` data-parallel over its
``data_axis``, as JAX's (``gsmvi_tpu/bam.py:54-63``): the factor route
hands the mesh to ``FactorBaM``; on the dense route every rank draws the
whole batch, scores its own rows, gathers the rows and runs the update
replicated.
"""

from __future__ import annotations

import torch

from .config import default_dtype, pin_fp32, resolve_device
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, broadcast_replicas,
                     host_score, make_chunk_runner, on_gpu, retry_seed,
                     run_fit_loop, takes_tensors)
from .ops.bam import Regularizers, bam_lowrank_update, bam_update  # noqa: F401 (re-export)
from .ops.gsm_factor import factor_to_cov
from .parallel.sharded import DataRows, no_mesh
from .state import (FactorVIState, VIState, accept_or_revert, init_state,
                    per_replica, stack_like)
from .utils.profiling import fit_call, reset_counts, span


class BaM:
    """Fit a dense-covariance Gaussian by Batch-and-Match updates.

    D    — dimensionality.
    lp   — target log-probability callable (monitors only).
    lp_g — score callable, (B, D) -> (B, D): on tensors, or on numpy
           arrays (the dense eager loop).
    use_lowrank — force the low-rank algebra (``auto_lowrank`` takes it
           when 4 (B+1) <= D; U is exactly rank B+1, so both agree).
    jit_compile — False runs the dense eager loop whatever ``use_factor``
           says, as JAX's does (the module docstring).
    device, dtype — where and in what precision the fit runs (default: the
           CUDA card, ``"cuda"``; raises without one; torch's default dtype).
    sqrt_method — the dense root: "auto" (= "eigh" on CPU and GPU, as the
           JAX package picks off the TPU), "eigh" or "newton".
    use_factor — "auto" (factor route on CUDA), True or False.
    use_fused, fused_score — passed to the delegated ``FactorBaM``.
    mesh, data_axis — a data-parallel ``fit`` over that mesh axis.
    """

    def __init__(self, D, lp, lp_g, use_lowrank=False, jit_compile=True,
                 device=None, dtype=None, sqrt_method: str = "auto",
                 auto_lowrank: bool = True,
                 use_factor: "bool | str" = "auto",
                 use_fused: "bool | str" = "auto", fused_score=None,
                 mesh=None, data_axis: str = "data"):
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
        self.device = resolve_device(device)
        self.dtype = default_dtype(dtype)
        self.sqrt_method = sqrt_method
        self.auto_lowrank = auto_lowrank
        self.use_factor = use_factor
        self.use_fused = use_fused
        self.fused_score = fused_score
        self.mesh = mesh
        self.data_axis = data_axis
        self._factor_fitter = None
        # What the last public fit call did: ``utils.profiling.FIT_COUNTS``
        # and resample attempts (on the factor route ``FactorBaM``'s counts,
        # copied).  Runners hold this dict, so each call resets it in place.
        self.fit_counts = {}
        self._reset_counts()
        self._eps = EpsStream(self.device, self.fit_counts)
        self._runners = RunnerCache(counts=self.fit_counts)

    def _reset_counts(self) -> None:
        reset_counts(self.fit_counts, retries=0)

    def _host(self, batch_size: int) -> bool:
        """Whether ``lp_g`` is a host (numpy) callable (``takes_tensors``
        probes it once per fit on the fit's device)."""
        return not takes_tensors(self.lp_g, batch_size, self.D, self.dtype,
                                 self.device)

    def _factor_route(self, host: bool = False) -> bool:
        """Whether ``fit`` runs on the factor route: "auto" exactly on a
        CUDA device; True forces it anywhere (it is exact everywhere).  A
        host ``lp_g`` or ``jit_compile=False`` never takes it
        (``gsmvi_tpu/bam.py:92-101``)."""
        if host or not self.jit_compile or self.use_factor is False:
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
                fused_score=self.fused_score, mesh=self.mesh,
                data_axis=self.data_axis)
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
        self.fit_counts.update(fb.fit_counts)
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

    def _make_step(self, batch_size: int, regf, retries: int, jitter: float,
                   host: bool = False):
        """Dense step: sample, score, update, resample while the proposal
        fails (``retries``), accept/revert.  ``host``: the score is a
        numpy callable, called through ``host_score``."""
        d = self.D
        dtype = self.dtype
        lp_g = host_score(self.lp_g) if host else self.lp_g
        rows = DataRows(self.mesh, self.data_axis)
        counts = self.fit_counts

        def attempt(s: VIState, eps, reg):
            ef, vs = rows.score(lp_g, eps, s.mean, s.chol, dtype)
            samples = s.mean + ef
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
                counts["retries"] += 1
                with span("gsmvi.block.retry"):
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
        for parity; checking is always on.  ``jit_compile=False`` or a
        numpy ``lp_g`` runs the dense eager loop (the module docstring)."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            host = self._host(batch_size)
            if self._factor_route(host):
                return self._fit_factor(seed, regf, mean, cov, batch_size,
                                        niter, nprint, verbose, monitor,
                                        retries, return_state, state)
            if state is None:
                state = init_state(seed, self.D, mean, cov, self.dtype,
                                   self.device)
            if (host or not self.jit_compile) and verbose:
                print("lp_g does not take tensors or jit_compile=False; "
                      "using the eager host loop")
            run_chunk = self._runners.get(
                (batch_size, retries, jitter, host), (regf,),
                lambda: make_chunk_runner(
                    self._make_step(batch_size, regf, retries, jitter, host),
                    counts=self.fit_counts))
            call.phase("loop")
            state = run_fit_loop(state, niter, run_chunk,
                                 monitor=monitor, lp=self.lp, nprint=nprint,
                                 verbose=verbose, batch_size=batch_size)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, state.cov

    def fit_batch(self, seeds, regf, mean=None, cov=None, batch_size=2,
                  niter=5000, retries=10, jitter=1e-6, return_state=False):
        """K independent BaM replicas, one per seed in ``seeds``, each
        ``niter + 1`` dense steps; returns (means (K, D), covs (K, D, D)),
        or the stacked ``VIState``.

        As the JAX package's ``fit_batch`` (``gsmvi_tpu/bam.py:282-311``),
        which vmaps the dense step, the replicas run the dense route
        whatever ``use_factor`` says: replica i is
        ``BaM(..., use_factor=False).fit(seeds[i])``, its retries its own.
        The dense step has no kernel, so the replicas run it one after
        another each step (``per_replica``).  ``regf`` must be a pure
        schedule; ``mean``/``cov`` are broadcast or carry a leading K
        axis.  A numpy ``lp_g`` is called on each replica's rows through
        ``host_score`` (JAX's vmapped step cannot call one)."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            no_mesh(self, "BaM.fit_batch")
            seeds = tuple(int(s) for s in seeds)
            host = self._host(batch_size)
            k, d, dtype, dev = len(seeds), self.D, self.dtype, self.device
            means0 = broadcast_replicas(mean, torch.zeros(d), k, (d,), dtype,
                                        dev)
            covs0 = broadcast_replicas(cov, torch.eye(d), k, (d, d), dtype,
                                       dev)
            # Factored one replica at a time, as fit's init_state factors,
            # each in LAPACK's layout.
            chols0 = stack_like([safe_cholesky(c) for c in covs0])
            zero = torch.zeros(k, dtype=torch.int32, device=dev)
            state = VIState(means0, covs0, chols0, seeds, 0, zero, zero)
            run = self._runners.get(
                ("batch", batch_size, retries, jitter, host), (regf,),
                lambda: make_chunk_runner(per_replica(
                    self._make_step(batch_size, regf, retries, jitter, host)),
                    counts=self.fit_counts))
            call.phase("loop")
            state = run(state, niter + 1)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, state.cov
