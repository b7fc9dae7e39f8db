"""FactorGSM: the Cholesky-free GSM fitter on factor state S = F F^T.

Counterpart of ``gsmvi_tpu/gsm_factor.py:46-680``.  Sampling is ``mu + eps
F^T``, the update (``method="eps"``, the default) is the rank-2B
eps-coordinate correction of F (``ops/gsm_eps.py``), and the hot loop
factors nothing D-sized.  On a CUDA device, at shapes the kernels take, an
eps step runs on the hand-written Hopper kernels (``ops/fused_step.py``):

- ``"update"`` mode (opaque ``lp_g``): sampling product and score in torch,
  then K1 ``gsm_eps_update_fused`` (update, residual gates, select);
- ``"step"`` mode (``fused_score=(score_fn, params)``, e.g.
  ``target.fused_score``): K2 ``make_fused_eps_multistep`` runs
  ``steps_per_call`` whole steps per call with the score inside, a full
  block as one CUDA graph replay on persistent buffers with the draws
  written in place; at ``steps_per_call=1`` each step is one call of K4
  ``make_fused_eps_step`` (external draw, NS update), as the JAX package
  runs it there.

``fit_batch`` runs K replica fits together on the same modes: batched K1
(``small_solver`` "auto"/"ns") or K6 ``make_fused_eps_batch_multistep``
("fused", ``ops/batch_fused.py``), each launch covering all K replicas.

``pallas_precision`` ("highest", "high", "bf16") names the precision of the
kernels' O(B D^2) products (``ef``, ``vf``, ``t`` and the fat apply) as in
JAX: "highest" true float32; "bf16" both operands rounded to bfloat16 with
float32 products and sums (the TPU's 1-pass ``Precision.DEFAULT``); "high"
bf16x3 (the TPU's 3-pass ``Precision.HIGH``).  The (2B)^2 small space and
its gates stay float32.  On the card "bf16" and "high" run hand-written
``mma.sync`` bf16 tensor-core products (``thin_mma.cu``, ``apply_mma.cu``);
JAX runs "high" only on its XLA paths, since Mosaic has no 3-pass
lowering (``gsmvi_tpu/gsm_factor.py:159-170``).  Off the card the plain
eps step is float32 whatever the option says, as JAX's CPU run is.

``method="twophase"`` and ``"qr"`` carry Finv in ``FactorVIState.finv``
and update (F, Finv) by ``ops/gsm_factor.py`` (a PSD update then a
downdate; a thin QR and a (2B)^2 ``eigh``), refreshing Finv against F by
Newton steps every ``refresh_every`` steps.  JAX has no Pallas kernel for
them (its ``_pallas_mode`` returns None off ``method="eps"``) and runs them
in XLA; the port runs them in torch's own ops on every device, which is
that design, not a fallback: ``use_fused=True`` with such a method raises.

``fit(..., audit_every=N)`` audits the kernel path every N iterations
(``utils/audit.py``): one fresh, stream-disjoint draw from the live state
goes through the fused kernel (K4 in "step" mode, K1 in "update" mode) and
the exact plain eps step, and an accepted step that deviates beyond
``audit_tol`` warns; records land in ``audit_log``.  The audit leaves the
fit's trajectory unchanged.

``mesh=`` (a ``DeviceMesh``, ``parallel.make_mesh``) makes ``fit``
data-parallel over its ``data_axis``, one rank per device: every rank
draws the whole batch and scores its own rows, the rows are gathered, and
the update runs replicated on the whole batch (``parallel.sharded
.make_gathered_update``: K1 on the card, the plain eps step elsewhere),
as JAX runs its mesh step (``gsmvi_tpu/gsm_factor.py:362-390``); the
whole-step kernels (K2, K4) do not run under a mesh.  On the card the
batch must split evenly over the axis (else it raises, naming
``use_fused=False``).  ``cov_sharding`` (``parallel.cov_sharding``)
keeps F as a DTensor split by columns over a model axis and runs the plain
eps step on the ranks' column panels (``parallel.large_d``), for D too
large for one card; the kernels keep F whole, so ``_fused_mode`` is None
there, as JAX's (``gsm_factor.py:168-173``).

On a CUDA device a dtype or shape the kernels do not take raises;
``use_fused=False`` (and ``small_solver="chol"``) is the one plain route
there.  Off the card, and with ``use_fused=False``, the step is the exact
plain-torch eps step with (2B)^2 Choleskys.  Eps for absolute step ``s`` is
drawn from a generator seeded by ``driver.step_seed(seed, s)`` on every
path: trajectories do not change with ``steps_per_call`` or with the chunk
cadence, a saved state resumes exactly, and a ``fit_batch`` replica draws
what the single fit with its seed draws.
"""

from __future__ import annotations

import warnings

import torch

from .config import default_dtype, pin_fp32, resolve_device
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, broadcast_replicas,
                     draw_block, draw_replicas, make_chunk_runner, on_gpu,
                     run_fit_loop, takes_tensors)
from .ops.batch_fused import make_fused_eps_batch_multistep
from .ops.fused_step import (KERNEL_BATCH_RANGE, KERNEL_DIM_RANGE,
                             check_precision, gsm_eps_update_fused,
                             kernel_supports, make_fused_eps_multistep,
                             make_fused_eps_step, ns_iters_for_batch)
from .ops.gsm_eps import apply_eps_step
from .ops.gsm_factor import (factor_gsm_step_stats, factor_gsm_step_stats_v2,
                             factor_refresh, factor_to_cov)
from .parallel.large_d import (ColumnPanels, is_dtensor, panel_eps_update,
                               sharded_cov)
from .parallel.mesh import axis_size
from .parallel.sharded import DataRows, make_gathered_update, no_mesh
from .state import FactorVIState, per_replica
from .utils.audit import make_audit_hook, make_gsm_audit
from .utils.profiling import fit_call, reset_counts, span

SMALL_SOLVERS = ("auto", "ns", "fused", "chol")
METHODS = ("eps", "twophase", "qr")

__all__ = ["FactorGSM", "FactorVIState"]


class FactorGSM:
    """Cholesky-free GSM fitter; ``fit`` surface matches ``GSM.fit``."""

    def __init__(self, D, lp, lp_g, device=None, dtype=None,
                 refresh_every: int = 1000, method: str = "eps",
                 use_fused: "bool | str" = "auto", fused_score=None,
                 steps_per_call=None, pallas_precision: str = "highest",
                 ns_iters=None, cuda_graph: bool = True, mesh=None,
                 data_axis: str = "data", cov_sharding=None):
        """``device`` defaults to the CUDA card (raises without one; pass
        ``device="cpu"`` for the CPU).  ``use_fused`` ("auto"/True/False):
        on a CUDA device the step runs on the CUDA kernels unless it is
        False (see ``_fused_mode``); with ``fused_score`` the whole step
        (sampling product, score, update, select) runs ``steps_per_call``
        sub-steps per kernel call.

        ``method``: "eps" (default), "twophase" or "qr" (the module
        docstring); the last two maintain Finv, refreshed every
        ``refresh_every`` steps (0: never), and run no kernel.
        ``pallas_precision`` ("highest", "high", "bf16") names the
        precision of the kernels' O(B D^2) products (the module
        docstring).
        ``ns_iters`` overrides the Newton-Schulz sweep counts (sqrt1, inv1,
        inv2, sqrt2, inv3); the default is batch-aware
        (``ns_iters_for_batch``).  The residual gates catch catastrophic
        loss, not slow bias: validate convergence when changing it.
        ``cuda_graph=False`` enqueues every K2/K6 block's launches from the
        host instead of replaying its CUDA graph: the same numbers, the
        comparison route for the graph's cost.

        ``mesh``/``data_axis``: a data-parallel ``fit`` over that mesh axis;
        ``cov_sharding``: F split by columns over a model axis (the module
        docstring).
        """
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got "
                             f"{method!r}")
        check_precision(pallas_precision)
        if method != "eps" and use_fused is True:
            raise ValueError(
                f"method={method!r} has no kernel (the JAX package runs it in "
                "XLA, the port in torch's own ops): use_fused=True takes "
                "method='eps'")
        if cov_sharding is not None and method != "eps":
            raise ValueError(f"cov_sharding runs the eps step on F's column "
                             f"panels; method={method!r} is not ported there")
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.device = resolve_device(device)
        self.dtype = default_dtype(dtype)
        self.method = method
        self.refresh_every = int(refresh_every)
        self.use_fused = use_fused
        self.fused_score = fused_score
        # Sub-steps per K2 call.  Trajectories do not depend on it.
        self.steps_per_call = (steps_per_call if steps_per_call is not None
                               else (16 if D <= 128 else 8))
        self.pallas_precision = pallas_precision
        self.ns_iters = tuple(ns_iters) if ns_iters is not None else None
        self.cuda_graph = bool(cuda_graph)
        self.mesh = mesh
        self.data_axis = data_axis
        self.cov_sharding = cov_sharding
        # What the last public fit call did (``utils.profiling.FIT_COUNTS``);
        # runners hold this dict, so each call resets it in place.
        self.fit_counts = {}
        self._reset_counts()
        self._eps = EpsStream(self.device, self.fit_counts)
        self._runners = RunnerCache(counts=self.fit_counts)
        self.audit_log = []

    def _reset_counts(self) -> None:
        reset_counts(self.fit_counts)

    def _fused_mode(self, batch_size: int):
        """None | "update" | "step": which kernel path this config runs.

        None off the card, with ``use_fused=False``, for the twophase
        and qr methods and with ``cov_sharding``.  On a CUDA device the
        kernels take float32 with B in ``KERNEL_BATCH_RANGE`` and D in
        ``KERNEL_DIM_RANGE``; anything else raises rather than running the
        plain step on the card.  Under a mesh the mode is "update" (K1 on
        the gathered rows), and B must split evenly over the data axis."""
        if (self.use_fused is False or self.method != "eps"
                or self.cov_sharding is not None
                or not on_gpu(self.device)):
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
        if self.mesh is not None:
            n = axis_size(self.mesh, self.data_axis)
            if batch_size % n:
                raise ValueError(
                    f"B={batch_size} does not split evenly over the {n} ranks "
                    f"of mesh axis {self.data_axis!r}: the update kernel runs "
                    "on the gathered rows of equal shards; pass "
                    "use_fused=False for the plain-torch step on the card")
            return "update"
        return "step" if self.fused_score is not None else "update"

    def _batch_mode(self, batch_size: int, small_solver: str):
        """None | "update" | "step": the route of ``fit_batch``.

        "chol", ``use_fused=False`` and every route off the card: None, the
        exact plain eps step one replica at a time.  On a CUDA device
        "auto"/"ns" run batched K1 and "fused" runs K6, which needs
        ``fused_score`` (it raises without; the JAX package falls back to
        its XLA step silently); the range and dtype rules are
        ``_fused_mode``'s."""
        if small_solver not in SMALL_SOLVERS:
            raise ValueError(f"small_solver must be one of {SMALL_SOLVERS}, "
                             f"got {small_solver!r}")
        if small_solver == "chol" or self._fused_mode(batch_size) is None:
            return None
        if small_solver != "fused":
            return "update"
        if self.fused_score is None:
            raise ValueError(
                "small_solver='fused' runs the whole replica steps on the "
                "card with the score inside: pass fused_score=(score_fn, "
                "params) (e.g. target.fused_score), or take small_solver="
                "'auto'/'ns' (batched update kernel) or 'chol' (plain step)")
        return "step"

    def _iters(self, batch_size: int):
        return ns_iters_for_batch(batch_size, self.ns_iters)

    def _get_runner(self, batch_size: int, mode, k=None):
        """Chunk runner of ``mode`` for one fit, or for ``k`` replicas."""
        score_objs = ()
        if self.fused_score is not None:
            score_objs = (self.fused_score[0], *self.fused_score[1])

        def build():
            if mode == "step" and (k is not None or self.steps_per_call > 1):
                return self._make_fused_runner(batch_size, k)
            step = self._make_step(batch_size, mode)
            if k is not None and mode is None:
                step = per_replica(step)
            return make_chunk_runner(step, counts=self.fit_counts)

        return self._runners.get(
            (batch_size, mode, k, self.steps_per_call,
             self._iters(batch_size), self.dtype, self.method,
             self.refresh_every, self.pallas_precision), score_objs, build)

    def _init_finv(self, f0):
        """Finv of the initial factor: None for the eps method, which never
        applies F^{-1}; else the triangular inverse of the (lower) Cholesky
        factor (``gsmvi_tpu/gsm_factor.py:492-498``), per replica for a
        stack."""
        if self.method == "eps":
            return None
        eye = torch.eye(self.D, dtype=f0.dtype, device=f0.device)
        return torch.linalg.solve_triangular(f0, eye.expand_as(f0),
                                             upper=False)

    def _draw(self, state, batch_size: int, offset: int = 0):
        """Step ``state.step + offset``'s draws: (B, D), or (K, B, D) for
        stacked replicas, each replica on its own seed's stream."""
        if isinstance(state.seed, tuple):
            return draw_replicas(self._eps, state.seed, state.step + offset,
                                 batch_size, self.D, self.dtype)
        return self._eps(state.seed, state.step + offset, batch_size, self.D,
                         self.dtype)

    def _make_step(self, batch_size: int, mode):
        """One-step runner of the "update" mode (K1; it also takes stacked
        replicas), of the "step" mode at ``steps_per_call=1`` (K4, one fit)
        or of the plain route (one fit); the "step" mode at spc > 1 runs on
        ``_make_fused_runner``."""
        lp_g = self.lp_g
        dtype = self.dtype
        d = self.D
        iters = self._iters(batch_size)
        prec = self.pallas_precision
        counts = self.fit_counts

        def advance(s, mean, f, good, finv=None):
            n_acc = good.to(torch.int32)
            return FactorVIState(mean, f, s.seed, s.step + 1,
                                 s.n_accepted + n_acc,
                                 s.n_rejected + (1 - n_acc), s.ns_stats,
                                 finv)

        rows = DataRows(self.mesh, self.data_axis)
        if mode is None and self.method != "eps":
            return self._make_method_step(batch_size, advance, rows)

        if mode == "update":
            def update(eps, vs, mean, f, ef):
                return gsm_eps_update_fused(eps, vs, mean, f, iters=iters,
                                            ef=ef, precision=prec)

            # With no mesh this rank holds every row and nothing is gathered.
            gathered = make_gathered_update(self.mesh, self.data_axis, lp_g,
                                            update, pass_ef=True)

            def step(s: FactorVIState) -> FactorVIState:
                with span("gsmvi.block.draw"):
                    eps = self._draw(s, batch_size)
                counts["kernel_calls"] += 1
                with span("gsmvi.block.launch"):
                    if isinstance(s.seed, tuple):   # stacked replicas
                        ef = eps @ s.factor.mT
                        x = (s.mean[..., None, :] + ef).reshape(-1, d)
                        vs = lp_g(x).to(torch.float32).reshape(ef.shape)
                        mean, f, good = update(eps, vs.contiguous(), s.mean,
                                               s.factor, ef)
                    else:
                        mean, f, good = gathered(rows.local(eps), s.mean,
                                                 s.factor)
                return advance(s, mean, f, good)

            return step

        if mode == "step":
            score_fn, params = self.fused_score
            fused = make_fused_eps_step(score_fn, len(params), batch_size, d,
                                        external_eps=True, iters=iters,
                                        precision=prec)

            def step(s: FactorVIState) -> FactorVIState:
                with span("gsmvi.block.draw"):
                    eps = self._draw(s, batch_size)
                counts["kernel_calls"] += 1
                with span("gsmvi.block.launch"):
                    mean, f, good = fused(eps, s.mean, s.factor, *params)
                return advance(s, mean, f, good)

            return step

        if self.cov_sharding is not None:
            p = ColumnPanels(self.cov_sharding, d)

            def step(s: FactorVIState) -> FactorVIState:
                eps = self._draw(s, batch_size)
                fc = p.local(s.factor)
                ef, vs = rows.score(lp_g, eps, s.mean, fc, dtype, panels=p)
                mean, f, good = panel_eps_update(eps, vs, ef, s.mean, fc, p)
                return advance(s, torch.where(good, mean, s.mean),
                               p.wrap(torch.where(good, f, fc)), good)

            return step

        def step(s: FactorVIState) -> FactorVIState:
            eps = self._draw(s, batch_size)
            _, vs = rows.score(lp_g, eps, s.mean, s.factor, dtype)
            mean, f, good = apply_eps_step(s.mean, s.factor, eps, vs)
            return advance(s, mean, f, good)

        return step

    def _make_method_step(self, batch_size: int, advance, rows):
        """One step of the twophase or qr method (``gsmvi_tpu/gsm_factor.py
        :445-464``): sample, score, the (F, Finv) update, the select, and
        Finv's Newton refresh after every ``refresh_every``-th step."""
        stats = (factor_gsm_step_stats_v2 if self.method == "twophase"
                 else factor_gsm_step_stats)
        refresh_every = self.refresh_every

        def step(s: FactorVIState) -> FactorVIState:
            ef, vs = rows.score(self.lp_g, self._draw(s, batch_size), s.mean,
                                s.factor, self.dtype)
            samples = s.mean + ef
            dmu, f_new, finv_new, good = stats(samples, vs, s.mean, s.factor,
                                               s.finv)
            mean = torch.where(good, s.mean + dmu, s.mean)
            f = torch.where(good, f_new, s.factor)
            finv = torch.where(good, finv_new, s.finv)
            if refresh_every and (s.step + 1) % refresh_every == 0:
                finv = factor_refresh(f, finv)
            return advance(s, mean, f, good, finv)

        return step

    def _make_fused_runner(self, batch_size: int, k=None):
        """Chunk runner of the "step" mode on K2 (one fit) or K6 (``k``
        replicas): blocks of ``steps_per_call`` sub-steps, a chunk
        remainder as one call with ``nmax < spc``.  Each block's draws, the
        per-absolute-step draws, are written in place into the blocks'
        persistent eps block (``draw_block``), so the trajectory does not
        depend on spc; on the card a full block is one CUDA graph replay
        (``FusedBlocks``) unless ``cuda_graph`` is False.  The runner's
        ``blocks`` attribute is its ``FusedBlocks`` (its capture and replay
        counts)."""
        score_fn, params = self.fused_score
        spc = self.steps_per_call
        iters = self._iters(batch_size)
        if k is None:
            multi = make_fused_eps_multistep(score_fn, len(params),
                                             batch_size, self.D, spc,
                                             iters=iters,
                                             precision=self.pallas_precision)
        else:
            multi = make_fused_eps_batch_multistep(
                score_fn, len(params), batch_size, self.D, k, spc,
                iters=iters, precision=self.pallas_precision)
        counts = self.fit_counts
        reps = 1 if k is None else k

        def block(s: FactorVIState, nmax: int) -> FactorVIState:
            eps_block = multi.eps_block(s.mean.device)
            with span("gsmvi.block.draw"):
                draw_block(self._eps, eps_block, s.seed, s.step, nmax,
                           batch_size)
            captures, replays = multi.captures, multi.replays
            with span("gsmvi.block.launch"):
                mean, f, n_acc = multi(nmax, eps_block, s.mean, s.factor,
                                       *params, graph=self.cuda_graph)
            counts["steps"] += nmax * reps
            counts["kernel_calls"] += 1
            counts["graph_captures"] += multi.captures - captures
            counts["graph_replays"] += multi.replays - replays
            return FactorVIState(mean, f, s.seed, s.step + nmax,
                                 s.n_accepted + n_acc,
                                 s.n_rejected + (nmax - n_acc))

        def run_chunk(state: FactorVIState, n: int) -> FactorVIState:
            n_multi, rem = divmod(n, spc)
            for _ in range(n_multi):
                state = block(state, spc)
            if rem:
                state = block(state, rem)
            return state

        run_chunk.blocks = multi
        return run_chunk

    def _make_audit_hook(self, batch_size: int, tol: float):
        """The periodic fused-vs-exact audit hook (``utils/audit.py``), its
        audit cached per config; None, with a warning, when this config runs
        no kernel: there is nothing fused to audit then."""
        mode = self._fused_mode(batch_size)
        self.audit_log = []
        if mode is None:
            warnings.warn("audit_every set but the fused kernel path is not "
                          "active for this config; no audits will run",
                          stacklevel=3)
            return None
        # The whole-step audit (K4) in "step" mode also certifies the fused
        # score against lp_g; "update" mode audits K1 on lp_g's scores.
        score = self.fused_score if mode == "step" else None
        score_objs = () if score is None else (score[0], *score[1])
        audit_fn = self._runners.get(
            ("audit", batch_size, mode, self._iters(batch_size), self.dtype,
             self.pallas_precision),
            (self.lp_g, *score_objs),
            lambda: make_gsm_audit(self.lp_g, batch_size, self.D,
                                   self._iters(batch_size),
                                   fused_score=score,
                                   precision=self.pallas_precision))
        return make_audit_hook(audit_fn, self.audit_log, tol, "FactorGSM")

    def fit(self, seed: int, mean=None, cov=None, batch_size=2, niter=5000,
            nprint=10, verbose=True, check_goodness=True, monitor=None,
            return_state=False, state=None, audit_every=0, audit_tol=1e-3):
        """Run ``niter + 1`` steps; returns (mean, cov), or the
        ``FactorVIState`` with ``return_state``.  ``state`` resumes a saved
        trajectory exactly, ignoring ``seed``/``mean``/``cov``.
        ``check_goodness`` is accepted for parity; checking is always on.

        ``audit_every`` — when > 0 and a kernel path is active, every
        ``audit_every`` iterations one fresh draw from the live state goes
        through the fused kernel and the exact eps step
        (``utils/audit.py``); an accepted step deviating beyond
        ``audit_tol`` (relative, either moment) warns.  Records land in
        ``self.audit_log``.  The audit draw is stream-disjoint from the
        fit, so the trajectory is unchanged.  This catches slow NS bias,
        which the residual gates cannot (they catch catastrophic loss).

        ``lp_g`` must take tensors: a numpy score raises ``TypeError``, as
        JAX's does (``gsmvi_tpu/gsm_factor.py:502-506``); ``GSM`` takes
        one."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            dev, dtype = self.device, self.dtype
            mode = self._fused_mode(batch_size)  # the range gates first
            if not takes_tensors(self.lp_g, batch_size, self.D, dtype, dev):
                raise TypeError(
                    "FactorGSM requires an lp_g that takes (B, D) tensors of "
                    "the fit's dtype and device; use GSM for numpy score "
                    "functions")
            if state is None:
                mean0 = (torch.zeros(self.D, dtype=dtype, device=dev)
                         if mean is None
                         else torch.as_tensor(mean, dtype=dtype, device=dev))
                f0 = (torch.eye(self.D, dtype=dtype, device=dev)
                      if cov is None
                      else safe_cholesky(torch.as_tensor(cov, dtype=dtype,
                                                         device=dev)))
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                state = FactorVIState(mean0, f0, int(seed), 0, zero, zero,
                                      finv=self._init_finv(f0))
            elif self.method != "eps" and state.finv is None:
                # A state of the eps method (or a dense one) carries no Finv.
                state = state._replace(finv=torch.linalg.inv(state.factor))
            if self.cov_sharding is not None:
                if not is_dtensor(state.factor):
                    state = state._replace(
                        factor=self.cov_sharding.place(state.factor))
            else:
                # The kernels take contiguous operands (a LAPACK factor may
                # not be).
                state = state._replace(mean=state.mean.contiguous(),
                                       factor=state.factor.contiguous())
            state_hook = (self._make_audit_hook(batch_size, audit_tol)
                          if audit_every else None)
            run_chunk = self._get_runner(batch_size, mode)
            call.phase("loop")
            state = run_fit_loop(
                state, niter, run_chunk, monitor=monitor,
                monitor_params=lambda s: [s.mean, factor_to_cov(s.factor)],
                lp=self.lp, nprint=nprint, verbose=verbose,
                batch_size=batch_size, state_hook=state_hook,
                state_hook_every=audit_every)
            call.phase("finish")
            if return_state:
                return state
            if self.cov_sharding is not None:
                return state.mean, sharded_cov(state.factor)
            return state.mean, factor_to_cov(state.factor)

    def fit_batch(self, seeds, mean=None, cov=None, batch_size=2, niter=5000,
                  return_state=False, small_solver="auto"):
        """K independent FactorGSM replicas, one per seed in ``seeds``, each
        ``niter + 1`` steps; returns (means (K, D), covs (K, D, D)), or the
        stacked ``FactorVIState``.

        ``mean``/``cov`` are broadcast to every replica or carry a leading K
        axis (per-replica warm starts).  Replica i draws what
        ``fit(seeds[i])`` draws.  ``small_solver`` picks the route on a
        CUDA device (``_batch_mode``): "auto"/"ns" batched K1, the score
        called once on the K·B stacked rows; "fused" K6 with
        ``fused_score`` inside (each replica then equals the single
        ``fit`` on K2 bit for bit); "chol" the exact plain step per
        replica.  Off the card every route is the exact plain step per
        replica, as ``fit`` runs there.  The twophase and qr methods run
        their plain step per replica on every device, as JAX vmaps its
        method step whatever ``small_solver`` says.  Monitors are not
        supported.
        """
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            no_mesh(self, "FactorGSM.fit_batch")
            mode = self._batch_mode(batch_size, small_solver)
            seeds = tuple(int(s) for s in seeds)
            k, d, dev, dtype = len(seeds), self.D, self.device, self.dtype
            means0 = broadcast_replicas(mean, torch.zeros(d), k, (d,), dtype,
                                        dev)
            if cov is None:
                f0 = broadcast_replicas(None, torch.eye(d), k, (d, d), dtype,
                                        dev)
            else:
                f0 = safe_cholesky(broadcast_replicas(
                    cov, None, k, (d, d), dtype, dev)).contiguous()
            zero = torch.zeros(k, dtype=torch.int32, device=dev)
            state = FactorVIState(means0, f0, seeds, 0, zero, zero,
                                  finv=self._init_finv(f0))
            run = self._get_runner(batch_size, mode, k)
            call.phase("loop")
            state = run(state, niter + 1)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, factor_to_cov(state.factor)
