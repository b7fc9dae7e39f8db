"""ADVI: ELBO maximization over (mean, Cholesky factor).

Counterpart of ``gsmvi_tpu/advi.py``: ``ADVI(D, lp, device=...)`` with
``fit(seed, opt, ...) -> (mean, cov, losses)`` (torch autograd on the
reparameterized negative ELBO, then ``opt``'s update) and
``fit_fused(seed, learning_rate, ...)`` (the whole iteration with the
gradient taken analytically and Adam inside, ``ops/advi_fused.py``).

- ``estimator="analytic"`` is the reference's estimator; ``"stl"`` is the
  sticking-the-landing path derivative (same expectation, gradient variance
  vanishing at the optimum), whose triangular solve uses the factor with
  its diagonal clamped at 1e-5 of its largest entry (``_safe_tril``).
- ``opt`` is ``Adam(learning_rate, b1, b2, eps)``, the port's stand-in for
  ``optax.adam`` (the one optimizer the JAX package's callers pass), whose
  update is ``ops.advi_fused._adam_apply``.
- ``fit_fused`` on a CUDA device runs K9 (analytic) or K10 (STL) at
  float32 with B in ``ADVI_KERNEL_BATCH_RANGE`` and D in
  ``ADVI_KERNEL_DIM_RANGE`` (``ops/advi_fused.py``: B 1-65536, D 1-8192),
  and raises outside that (``ValueError``, or ``NotImplementedError`` for
  another dtype); it never turns into ``fit`` as the JAX package does off
  the TPU.  On the CPU it runs the kernels' plain versions, in float32 as
  the kernels do.
- K10 freezes a block at the first sub-step whose tracked-inverse residual
  or gradient fails its gate; that one step replays here in plain torch
  (exact clamped solve, the same draw and Adam) and the tracked inverse is
  re-seeded exactly.  Deciding a replay needs the kernel's report on the
  host: one read per block.  K9 is never read.

JAX carries a PRNG key; the port carries ``seed`` and the absolute
``step``, and eps for step ``s`` is ``driver.EpsStream``'s draw for
``step_seed(seed, s)`` on every path (JAX's ``fit`` splits its key per step
instead, and its fused path folds the step in: both are replaced by the one
stream, so trajectories do not depend on ``steps_per_call`` or the chunk
cadence and resume exactly).  ``mesh=`` and ``fit_batch`` are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from .config import default_dtype, pin_fp32, resolve_device
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, draw_block, make_chunk_runner,
                     on_gpu, run_fit_loop)
from .ops.advi_fused import (ADVI_KERNEL_BATCH_RANGE, ADVI_KERNEL_DIM_RANGE,
                             REP_NDONE, REP_STIFF, _adam_apply,
                             advi_kernel_supports, lr_bias_arrays,
                             make_fused_advi_multistep,
                             make_fused_advi_stl_multistep)

__all__ = ["ADVI", "ADVIState", "Adam", "AdamState", "FusedADVIState",
           "FusedADVISTLState", "advi_state_from_numpy"]

_ESTIMATORS = ("analytic", "stl")


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count (int32 on the fit's
    device, so a reverted step leaves it unchanged without a host read) and
    the moments, each a (loc, scales) pair."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


class Adam(NamedTuple):
    """``optax.adam(learning_rate, b1, b2, eps)``: ``learning_rate`` is a
    float or a ``step -> lr`` callable, called on the update count as a 0-d
    tensor (so it must be written in torch operations, as optax schedules
    are written in jax ones)."""

    learning_rate: Union[float, Callable] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        zeros = tuple(torch.zeros_like(p) for p in params)
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return AdamState(count, zeros, zeros)

    def update(self, grads, state: AdamState, params):
        """(new params, new state): ``_adam_apply`` per parameter with the
        bias corrections of update t = ``count + 1``, computed on the device
        in the parameters' dtype as optax computes them, and the learning
        rate at ``count``.  No host value becomes a device tensor here (a
        host-to-device copy would wait for the device every step)."""
        t = (state.count + 1).to(params[0].dtype)
        bc1 = 1.0 / (1.0 - torch.pow(self.b1, t))
        bc2 = 1.0 / (1.0 - torch.pow(self.b2, t))
        lr = (self.learning_rate(state.count)
              if callable(self.learning_rate) else float(self.learning_rate))
        out = [_adam_apply(p, m, v, g, lr, bc1, bc2, self.b1, self.b2,
                           self.eps)
               for p, m, v, g in zip(params, state.mu, state.nu, grads)]
        return (tuple(o[0] for o in out),
                AdamState(state.count + 1, tuple(o[1] for o in out),
                          tuple(o[2] for o in out)))


class ADVIState(NamedTuple):
    """State of ``fit``: ``scales`` is the masked-dense (D, D) factor."""

    loc: torch.Tensor        # (D,)
    scales: torch.Tensor     # (D, D), lower triangle used
    opt_state: AdamState
    seed: int                # eps stream base
    step: int                # absolute step = stream position
    loss: torch.Tensor       # most recent loss value


class FusedADVIState(NamedTuple):
    """State of the K9 path: the tril factor and the four Adam moments."""

    loc: torch.Tensor        # (D,)
    l: torch.Tensor          # (D, D) lower-triangular factor
    mloc: torch.Tensor       # (D,)   Adam first moment of loc
    vloc: torch.Tensor       # (D,)   Adam second moment of loc
    ml: torch.Tensor         # (D, D) Adam first moment of L
    vl: torch.Tensor         # (D, D) Adam second moment of L
    seed: int
    step: int


class FusedADVISTLState(NamedTuple):
    """State of the K10 path: as ``FusedADVIState`` plus the tracked
    ``ainv ~= l^{-1}`` (state, so trajectories do not depend on the chunk
    cadence; re-seeded exactly after every replay)."""

    loc: torch.Tensor
    l: torch.Tensor
    ainv: torch.Tensor
    mloc: torch.Tensor
    vloc: torch.Tensor
    ml: torch.Tensor
    vl: torch.Tensor
    seed: int
    step: int


def advi_state_from_numpy(loc, l, seed: int, step: int, *, moments=None,
                          ainv=None, adam=None, dtype=None, device=None):
    """An ADVI state from numpy arrays as the JAX package hands them over
    (``np.asarray(jax_array)``), so both packages continue from one state.

    - ``adam=(count, mu, nu)``, optax's ``ScaleByAdamState`` with ``mu`` and
      ``nu`` (loc, scales) pairs: an ``ADVIState`` whose scales are ``l``.
    - else a fused state with ``moments=(mloc, vloc, ml, vl)`` (zeros when
      omitted): ``FusedADVISTLState`` when ``ainv`` is given, else
      ``FusedADVIState``.

    ``dtype`` defaults to the dtype of ``loc``; ``device`` to the CUDA card.
    """
    device = resolve_device(device)
    loc = np.asarray(loc)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, loc.dtype)).dtype
    # A copy: numpy views of JAX arrays are read-only.
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    loc_t, l_t = as_t(loc), as_t(l)
    if adam is not None:
        count, mu, nu = adam
        opt = AdamState(torch.tensor(int(count), dtype=torch.int32,
                                     device=device),
                        tuple(as_t(m) for m in mu), tuple(as_t(v) for v in nu))
        return ADVIState(loc_t, l_t, opt, int(seed), int(step),
                         torch.zeros((), dtype=dtype, device=device))
    if moments is None:
        d = loc.shape[-1]
        moments = (np.zeros(d), np.zeros(d), np.zeros((d, d)),
                   np.zeros((d, d)))
    mloc, vloc, ml, vl = (as_t(m) for m in moments)
    if ainv is not None:
        return FusedADVISTLState(loc_t, l_t, as_t(ainv), mloc, vloc, ml, vl,
                                 int(seed), int(step))
    return FusedADVIState(loc_t, l_t, mloc, vloc, ml, vl, int(seed),
                          int(step))


def _fused_state(loc, l, seed: int, step: int) -> FusedADVIState:
    """A ``FusedADVIState`` at (loc, l) with zero Adam moments."""
    z_row, z_mat = torch.zeros_like(loc), torch.zeros_like(l)
    return FusedADVIState(loc, l, z_row, z_row, z_mat, z_mat, seed, step)


def _tree_select(good, new, old):
    """``torch.where(good, new, old)`` over matching tuples of tensors."""
    if torch.is_tensor(new):
        return torch.where(good, new, old)
    items = [_tree_select(good, a, b) for a, b in zip(new, old)]
    return type(new)(*items) if hasattr(new, "_fields") else tuple(items)


class ADVI:
    """Fit a dense-covariance Gaussian by maximizing the ELBO."""

    def __init__(self, D, lp, device=None, dtype=None, fused_score=None,
                 steps_per_call=None, mesh=None, cuda_graph: bool = True):
        """``lp(x)``, x (B, D), returns the batch-summed log density and
        must be differentiable by torch autograd.  ``fused_score``: the
        ``(score_fn, params)`` pair (``target.fused_score``) that
        ``fit_fused`` runs inside its kernels; ``fit`` does not use it.
        ``device`` defaults to the CUDA card (raises without one; pass
        ``device="cpu"`` for the CPU).  ``cuda_graph=False`` enqueues every
        K9/K10 block's launches from the host instead of replaying its CUDA
        graph: the same numbers, the comparison route for the graph's
        cost."""
        if mesh is not None:
            raise NotImplementedError("mesh=: the data-parallel ADVI batch "
                                      "is not ported")
        self.D = D
        self.lp = lp
        self.device = resolve_device(device)
        self.dtype = default_dtype(dtype)
        self.fused_score = fused_score
        self.steps_per_call = (steps_per_call if steps_per_call is not None
                               else (16 if D <= 128 else 8))
        self.cuda_graph = bool(cuda_graph)
        # What the last fit_fused did: kernel calls, report reads, replays.
        # Runners hold this dict, so fit_fused resets it in place.
        self.fit_counts = {}
        self._reset_counts()
        self._eps = EpsStream(self.device)
        self._runners = RunnerCache()

    def _reset_counts(self) -> None:
        self.fit_counts.update(kernel_calls=0, report_reads=0, replays=0)

    # -- parameterization ---------------------------------------------------
    def scales_to_tril(self, scales):
        """The lower-triangular factor from either parameter form: a
        masked-dense (D, D) matrix (what the fitters optimize) or the
        reference's flat (D(D+1)/2,) vector."""
        if scales.ndim == 2:
            return torch.tril(scales)
        idx = torch.tril_indices(self.D, self.D, device=scales.device)
        tril = torch.zeros((self.D, self.D), dtype=scales.dtype,
                           device=scales.device)
        tril[idx[0], idx[1]] = scales
        return tril

    def scales_to_cov(self, scales):
        """L L^T (reference ``gsmvi/advi.py:25-29``)."""
        l = self.scales_to_tril(scales)
        return l @ l.T

    @staticmethod
    def _safe_tril(l):
        """The factor with |L_ii| clamped at 1e-5 of the largest diagonal
        entry (bias-free below covariance condition 1e10, bounded above
        float32 overflow), for the STL solves."""
        diag = torch.diagonal(l)
        floor = 1e-5 * torch.clamp(torch.max(torch.abs(diag)), min=1e-30)
        safe = torch.where(torch.abs(diag) < floor,
                           torch.where(diag < 0, -floor, floor), diag)
        return l + torch.diag(safe - diag)

    def _start(self, mean, cov, dtype):
        """(loc, L) of a fresh fit: ``mean`` (zeros) and the Cholesky
        factor of ``cov`` (I), on the fit's device."""
        dev = self.device
        loc = (torch.zeros(self.D, dtype=dtype, device=dev) if mean is None
               else torch.as_tensor(mean, dtype=dtype, device=dev))
        cov = (torch.eye(self.D, dtype=dtype, device=dev) if cov is None
               else torch.as_tensor(cov, dtype=dtype, device=dev))
        return loc, torch.tril(safe_cholesky(cov))

    def _exact_ainv(self, l):
        """The exact inverse of the clamped factor, row-major as the
        kernels take it (LAPACK's solve returns it column-major)."""
        eye = torch.eye(self.D, dtype=l.dtype, device=l.device)
        return torch.linalg.solve_triangular(self._safe_tril(l), eye,
                                             upper=False).contiguous()

    # -- loss ---------------------------------------------------------------
    def neg_elbo(self, params, eps, estimator: str = "analytic"):
        """Negative ELBO of q = N(loc, L L^T) on the draws ``eps`` (B, D)
        (the JAX package draws them from a key inside; here the caller
        hands them over).  ``"analytic"`` keeps the entropy's parameter
        dependence analytic; ``"stl"`` evaluates log q at detached
        parameters through a triangular solve, so the gradient keeps only
        the path derivative."""
        loc, scales = params
        b = eps.shape[0]
        l = self.scales_to_tril(scales)
        samples = loc + eps @ l.T
        if estimator == "stl":
            l_safe = self._safe_tril(l.detach())
            v = torch.linalg.solve_triangular(
                l_safe, (samples - loc.detach()).T, upper=False).T
            logdet = torch.sum(torch.log(torch.abs(torch.diagonal(l_safe))))
            ent_quad = -0.5 * torch.sum(v * v)
        elif estimator == "analytic":
            logdet = torch.sum(torch.log(torch.abs(torch.diagonal(l))))
            ent_quad = -0.5 * torch.sum(eps * eps)
        else:
            raise ValueError(f"unknown estimator: {estimator!r}")
        logq = ent_quad - b * (logdet + 0.5 * self.D * math.log(2.0 * math.pi))
        logl = torch.sum(self.lp(samples))
        return -(logl - logq)

    def _draw(self, state, batch_size: int, offset: int = 0,
              dtype=torch.float32):
        return self._eps(state.seed, state.step + offset, batch_size, self.D,
                         dtype)

    def _make_step(self, batch_size: int, opt, estimator: str = "analytic"):
        """One step (state) -> (state, loss): autograd on ``neg_elbo`` at
        the step's draw, then ``opt``'s update.  A nonfinite STL step is
        reverted on the device (the analytic estimator accepts every step,
        as the reference does)."""

        def step(state: ADVIState):
            eps = self._draw(state, batch_size, dtype=self.dtype)
            loc = state.loc.detach().requires_grad_(True)
            scales = state.scales.detach().requires_grad_(True)
            loss = self.neg_elbo((loc, scales), eps, estimator)
            grads = torch.autograd.grad(loss, (loc, scales))
            params = (state.loc, state.scales)
            (loc_n, scales_n), opt_n = opt.update(grads, state.opt_state,
                                                  params)
            if estimator == "stl":
                good = torch.isfinite(loc_n).all() & torch.isfinite(
                    scales_n).all()
                loc_n = torch.where(good, loc_n, state.loc)
                scales_n = torch.where(good, scales_n, state.scales)
                opt_n = _tree_select(good, opt_n, state.opt_state)
            loss = loss.detach()
            return (ADVIState(loc_n, scales_n, opt_n, state.seed,
                              state.step + 1, loss), loss)

        return step

    def fit(self, seed: int, opt, mean=None, cov=None, batch_size=8,
            niter=1000, nprint=10, verbose=True, monitor=None,
            return_state=False, return_losses=True, estimator="analytic"):
        """Run ``niter + 1`` steps; returns (mean, cov, losses) as the
        reference does, ``losses`` a numpy array of length ``niter + 1``
        (the per-step losses stay on the device until the end: one copy),
        or ``None`` with ``return_losses=False``.  ``return_state`` gives
        (``ADVIState``, losses)."""
        if estimator not in _ESTIMATORS:
            raise ValueError(f"unknown estimator: {estimator!r}")
        pin_fp32()
        dtype = self.dtype
        mean0, scales0 = self._start(mean, cov, dtype)
        state = ADVIState(mean0, scales0, opt.init((mean0, scales0)),
                          int(seed), 0, torch.zeros((), dtype=dtype,
                                                    device=self.device))

        def build():
            step = self._make_step(batch_size, opt, estimator)
            if return_losses:
                return make_chunk_runner(step, collect_aux=True)
            return make_chunk_runner(lambda s: step(s)[0])

        run_chunk = self._runners.get(
            ("fit", batch_size, return_losses, estimator, dtype), (opt,),
            build)
        out = run_fit_loop(
            state, niter, run_chunk, monitor=monitor,
            monitor_params=lambda s: [s.loc, self.scales_to_cov(s.scales)],
            lp=self.lp, nprint=nprint, verbose=verbose,
            batch_size=batch_size, collect_aux=return_losses)
        if return_losses:
            state, losses = out
            losses = losses.cpu().numpy()
        else:
            state, losses = out, None
        if return_state:
            return state, losses
        return state.loc, self.scales_to_cov(state.scales), losses

    # -- fused path -----------------------------------------------------------
    def _check_fused(self, batch_size: int) -> None:
        """Raise where ``fit_fused`` cannot run: without ``fused_score``, or
        on a CUDA device at a dtype or shape the kernels do not take."""
        if self.fused_score is None:
            raise ValueError("fit_fused needs fused_score=(score_fn, params)")
        if not on_gpu(self.device):
            return
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"dtype {self.dtype}: the ADVI CUDA kernels take float32; "
                "use fit for the plain-torch step on the card")
        if not advi_kernel_supports(batch_size, self.D):
            raise ValueError(
                f"B={batch_size}, D={self.D}: the ADVI CUDA kernels take B "
                f"in {list(ADVI_KERNEL_BATCH_RANGE)} and D in "
                f"{list(ADVI_KERNEL_DIM_RANGE)}; use fit for the plain-torch "
                "step on the card")

    def _block_scalars(self, step: int, learning_rate, b1: float,
                       b2: float):
        """(lrs, bc1s, bc2s) of the ``steps_per_call`` absolute steps from
        ``step``: float32 CPU tensors (``lr_bias_arrays``; a float rate or
        a ``step -> lr`` callable)."""
        steps = torch.arange(step, step + self.steps_per_call,
                             dtype=torch.int32)
        return lr_bias_arrays(learning_rate, b1, b2, steps)

    def _make_fused_runner(self, batch_size: int, learning_rate, b1: float,
                           b2: float, eps_adam: float):
        """Chunk runner on K9: blocks of ``steps_per_call`` sub-steps, the
        chunk remainder as one block with ``nmax < spc``; nothing is read
        from the device.  The state is copied into K9's working state at
        the chunk's start and out at its end; each block's draws go in
        place into K9's eps block (``draw_block``), and on the card a full
        block is one CUDA-graph replay unless ``cuda_graph`` is False.  The
        runner's ``blocks`` attribute is its ``AdviBlocks``."""
        score_fn, params = self.fused_score
        spc = self.steps_per_call
        multi = make_fused_advi_multistep(score_fn, len(params), batch_size,
                                          self.D, spc, b1=b1, b2=b2,
                                          eps_adam=eps_adam)
        counts = self.fit_counts

        def run_chunk(state: FusedADVIState, k: int) -> FusedADVIState:
            multi.load(*state[:6])
            eps_block = multi.eps_block(state.loc.device)
            step, end = state.step, state.step + k
            while step < end:
                nmax = min(spc, end - step)
                draw_block(self._eps, eps_block, state.seed, step, nmax,
                           batch_size)
                multi.run(*self._block_scalars(step, learning_rate, b1, b2),
                          nmax,
                          *params, graph=self.cuda_graph)
                counts["kernel_calls"] += 1
                step += nmax
            return FusedADVIState(*multi.state(), state.seed, step)

        run_chunk.blocks = multi
        return run_chunk

    def _make_fused_stl_runner(self, batch_size: int, learning_rate,
                               b1: float, b2: float, eps_adam: float):
        """Chunk runner on K10, on K10's working state as the K9 runner
        does: per block one read of the report (n_done, stiff); a stiff
        sub-step replays here with the exact clamped solve, the block's own
        draw and Adam, re-seeds the tracked inverse, and goes back into the
        working state."""
        score_fn, params = self.fused_score
        spc = self.steps_per_call
        multi = make_fused_advi_stl_multistep(score_fn, len(params),
                                              batch_size, self.D, spc,
                                              b1=b1, b2=b2,
                                              eps_adam=eps_adam)
        counts = self.fit_counts

        def replay(s: FusedADVISTLState, e, lr, bc1, bc2):
            counts["replays"] += 1
            l_safe = self._safe_tril(s.l)
            sc = score_fn(s.loc + e @ s.l.T, *params)
            w = torch.linalg.solve_triangular(l_safe.T, e.T, upper=True)
            g_all = sc + w.T                       # rows s_b + L^{-T} e_b
            g_loc = -torch.sum(g_all, dim=0)
            g_l = torch.tril(-(g_all.T @ e))
            loc_n, mloc_n, vloc_n = _adam_apply(s.loc, s.mloc, s.vloc, g_loc,
                                                lr, bc1, bc2, b1, b2,
                                                eps_adam)
            l_n, ml_n, vl_n = _adam_apply(s.l, s.ml, s.vl, g_l, lr, bc1, bc2,
                                          b1, b2, eps_adam)
            good = torch.isfinite(loc_n).all() & torch.isfinite(l_n).all()
            sel = lambda a, b: torch.where(good, a, b)
            l_n = sel(l_n, s.l)
            return FusedADVISTLState(
                sel(loc_n, s.loc), l_n, self._exact_ainv(l_n),
                sel(mloc_n, s.mloc), sel(vloc_n, s.vloc), sel(ml_n, s.ml),
                sel(vl_n, s.vl), s.seed, s.step + 1)

        def run_chunk(state: FusedADVISTLState, k: int) -> FusedADVISTLState:
            multi.load(*state[:7])
            eps_block = multi.eps_block(state.loc.device)
            step, end = state.step, state.step + k
            while step < end:
                nmax = min(spc, end - step)
                draw_block(self._eps, eps_block, state.seed, step, nmax,
                           batch_size)
                lrs, bc1s, bc2s = self._block_scalars(step, learning_rate,
                                                      b1, b2)
                multi.run(lrs, bc1s, bc2s, nmax, *params,
                          graph=self.cuda_graph)
                r = multi.report().tolist()     # the one read of the block
                n_done, stiff = int(r[REP_NDONE]), int(r[REP_STIFF])
                counts["kernel_calls"] += 1
                counts["report_reads"] += 1
                step += n_done
                if stiff:
                    rows = eps_block[n_done * batch_size:
                                     (n_done + 1) * batch_size]
                    s = replay(FusedADVISTLState(*multi.state(), state.seed,
                                                 step), rows,
                               float(lrs[n_done]), float(bc1s[n_done]),
                               float(bc2s[n_done]))
                    multi.load(*s[:7])
                    step = s.step
            return FusedADVISTLState(*multi.state(), state.seed, step)

        run_chunk.blocks = multi
        return run_chunk

    def _fused_runner(self, batch_size: int, learning_rate, b1: float,
                      b2: float, eps: float, estimator: str):
        """``fit_fused``'s chunk runner ``(state, k) -> state`` for this
        configuration, cached with its blocks (and their graphs)."""
        lr_objs = (learning_rate,) if callable(learning_rate) else ()
        make = (self._make_fused_stl_runner if estimator == "stl"
                else self._make_fused_runner)
        return self._runners.get(
            ("fused", estimator, batch_size, self.steps_per_call, b1, b2,
             eps, None if callable(learning_rate) else float(learning_rate)),
            (self.fused_score[0], *self.fused_score[1], *lr_objs),
            lambda: make(batch_size, learning_rate, b1, b2, eps))

    def _lift(self, state, stl: bool):
        """``state`` (None for a fresh start, an ``ADVIState`` or either
        fused state) in the form the ``stl`` or analytic runner takes:
        an ``ADVIState`` lifts with fresh Adam moments, the STL form gets
        an exact tracked inverse, the analytic form drops it."""
        if isinstance(state, ADVIState):
            state = _fused_state(state.loc, self.scales_to_tril(state.scales),
                                 state.seed, state.step)
        if stl and not isinstance(state, FusedADVISTLState):
            state = FusedADVISTLState(
                state.loc, state.l, self._exact_ainv(state.l), state.mloc,
                state.vloc, state.ml, state.vl, state.seed, state.step)
        elif not stl and isinstance(state, FusedADVISTLState):
            state = FusedADVIState(state.loc, state.l, state.mloc,
                                   state.vloc, state.ml, state.vl,
                                   state.seed, state.step)
        # The kernels take contiguous float32 operands on the fit's device.
        return type(state)(*(t.to(device=self.device,
                                  dtype=torch.float32).contiguous()
                             if torch.is_tensor(t) else t for t in state))

    def fit_fused(self, seed: int, learning_rate=1e-2, b1=0.9, b2=0.999,
                  eps=1e-8, mean=None, cov=None, batch_size=8, niter=1000,
                  nprint=10, verbose=True, monitor=None, return_state=False,
                  state=None, estimator="analytic"):
        """ADVI fit on the whole-step kernels: in-kernel Adam with
        optax.adam's update; ``learning_rate`` a float or a ``step -> lr``
        callable (called with the absolute step as a 0-d tensor).

        ``state`` resumes a fused state exactly (ignoring ``seed``,
        ``mean``, ``cov``), or lifts an ``ADVIState`` from ``fit`` (fresh
        Adam moments) or the other estimator's fused state (the moments
        carry over: the two-phase "analytic bulk, STL polish" recipe).
        Returns ``(mean, cov, None)`` (no loss trace in the kernels), or
        ``(state, None)`` with ``return_state``."""
        if estimator not in _ESTIMATORS:
            raise ValueError(f"unknown estimator: {estimator!r}")
        self._check_fused(batch_size)
        pin_fp32()
        stl = estimator == "stl"
        if state is None:
            state = _fused_state(*self._start(mean, cov, torch.float32),
                                 int(seed), 0)
        state = self._lift(state, stl)
        self._reset_counts()
        run_chunk = self._fused_runner(batch_size, learning_rate, b1, b2, eps,
                                       estimator)
        state = run_fit_loop(
            state, niter, run_chunk, monitor=monitor,
            monitor_params=lambda s: [s.loc, self.scales_to_cov(s.l)],
            lp=self.lp, nprint=nprint, verbose=verbose,
            batch_size=batch_size)
        if return_state:
            return state, None
        return state.loc, self.scales_to_cov(state.l), None

    def fit_batch(self, *args, **kwargs):
        raise NotImplementedError("fit_batch: K independent ADVI replicas "
                                  "are not ported")
