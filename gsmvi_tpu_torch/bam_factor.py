"""FactorBaM: Batch-and-Match with factor state S = F F^T.

Counterpart of ``gsmvi_tpu/bam_factor.py:57-568``: the same ``fit``
surface as ``BaM`` (per-iteration regularizer schedule, up to ``retries``
resampling attempts on a failed validity check, warm starts), with the
update in factor coordinates (``ops/bam_eps.py``), so the hot loop factors
nothing D-sized.  On a CUDA device, at shapes the kernels take, a step runs
on the hand-written Hopper kernels (``ops/bam_fused.py``):

- ``"update"`` mode (opaque ``lp_g``): sampling product and score in torch,
  then K7 ``bam_eps_update_fused``;
- ``"step"`` mode (``fused_score=(score_fn, params)``): K8
  ``make_fused_bam_multistep`` runs up to ``steps_per_call`` whole steps per
  call with the score inside, stopping at a stiff sub-step.

A step the kernels flag STIFF is replayed on the SVD route
(``bam_eps_update``) with the same draw.  Deciding a replay needs the
kernel's flags on the host, so the loop makes exactly one small
device-to-host read per step (update mode) or per block (step mode): the
kernel's float32 report, which also carries the measured (gu_ub, lmax_ub)
that pick the next NS tier.  Replays and retries are the plain route and
read the device as they need.

The measured-feedback NS ladder (``ns_profile="auto"``) runs each step on
the most benign tier whose gates the carried stats pass with margin; the
stats update only just before multiples of ``FEEDBACK_CADENCE`` and at
stiff steps, and step-mode blocks stop at cadence boundaries, so the
trajectory does not depend on ``steps_per_call`` or the chunk cadence.
Eps for absolute step ``s`` comes from ``driver.step_seed(seed, s)``;
resample attempts from the disjoint ``driver.retry_seed`` stream.

``fit(..., audit_every=N)`` audits the kernel path every N iterations
(``utils/audit.py``): one fresh, stream-disjoint draw from the live state
goes through K7 on the NS tier the carried stats pick (the tier the fit
runs there) and the exact thin-SVD step; an accepted, non-stiff step that
deviates beyond ``audit_tol`` warns, and records land in ``audit_log``.
The audit leaves the fit's trajectory unchanged.

``mesh=`` (``parallel.make_mesh``) makes ``fit`` data-parallel over its
``data_axis``, one rank per device, as JAX's mesh step
(``gsmvi_tpu/bam_factor.py:249-273``): every rank draws the whole batch
and scores its own rows, the rows are gathered
(``parallel.sharded.make_gathered_update``), and K7 with its stiff replay
runs replicated on the whole batch (the plain step off the card); K8 does
not run under a mesh.  On the card the batch must split evenly over the
axis (else it raises, naming ``use_fused=False``).

On a CUDA device a dtype or shape the kernels do not take raises;
``use_fused=False`` is the one plain route there.
"""

from __future__ import annotations

import warnings

import torch

from .config import default_dtype, pin_fp32, resolve_device
from .distributions import safe_cholesky
from .driver import (EpsStream, RunnerCache, broadcast_replicas,
                     draw_replicas, make_chunk_runner, on_gpu, retry_seed,
                     run_fit_loop, takes_tensors)
from .ops.bam_eps import bam_eps_update
from .ops.bam_fused import (BAM_KERNEL_BATCH_RANGE, BAM_KERNEL_DIM_RANGE,
                            BAM_NS_ITERS_DEFAULT, BAM_NS_TIERS,
                            FEEDBACK_CADENCE, GU_GATE_DEFAULT,
                            LMAX_GATE_DEFAULT, REP_GU, REP_KEEP, REP_LMAX,
                            REP_NACC, REP_NDONE, REP_STIFF, REP_STOPPED,
                            _bam_update_packed, _bam_update_replicas_packed,
                            bam_kernel_supports, make_fused_bam_multistep,
                            ns_tier_from_stats)
from .ops.gsm_factor import factor_to_cov
from .parallel.mesh import axis_size
from .parallel.sharded import DataRows, make_gathered_update, no_mesh
from .state import (NS_STATS_INIT, FactorVIState, per_replica, replica,
                    stack_replicas)
from .utils.audit import make_audit_hook, make_bam_audit
from .utils.profiling import fit_call, reset_counts, span

__all__ = ["FactorBaM"]


class FactorBaM:
    """BaM on factor state; ``fit`` surface matches ``BaM.fit``."""

    def __init__(self, D, lp, lp_g, device=None, dtype=None,
                 solver: str = "auto", use_fused: "bool | str" = "auto",
                 fused_score=None, steps_per_call=None,
                 lmax_gate: float = LMAX_GATE_DEFAULT,
                 gu_gate: float = GU_GATE_DEFAULT,
                 ns_iters=BAM_NS_ITERS_DEFAULT, ns_profile: str = "auto",
                 mesh=None, data_axis: str = "data"):
        """``device`` defaults to the CUDA card (raises without one; pass
        ``device="cpu"`` for the CPU).  ``solver`` ("auto"/"svd"/"eigh")
        picks the small-space spectrum of the plain route and of the stiff
        replays (``ops/bam_eps.py``).
        ``use_fused`` ("auto"/True/False): on a CUDA device the step runs on
        the kernels unless it is False; with ``fused_score`` the whole step
        runs ``steps_per_call`` sub-steps per call.  ``lmax_gate``/``gu_gate``
        and ``ns_iters`` are the long profile's gates and sweeps;
        ``ns_profile`` "auto" runs the measured-feedback ladder below them,
        "long" pins every step to the long profile.  ``mesh``/``data_axis``:
        a data-parallel ``fit`` over that mesh axis (the module
        docstring)."""
        if ns_profile not in ("auto", "long"):
            raise ValueError("ns_profile must be 'auto' or 'long'")
        self.D = D
        self.lp = lp
        self.lp_g = lp_g
        self.device = resolve_device(device)
        self.dtype = default_dtype(dtype)
        self.solver = solver
        self.use_fused = use_fused
        self.fused_score = fused_score
        self.steps_per_call = (steps_per_call if steps_per_call is not None
                               else (16 if D <= 128 else 8))
        self.lmax_gate = float(lmax_gate)
        self.gu_gate = float(gu_gate)
        self.ns_iters = tuple(ns_iters)
        self.ns_profile = ns_profile
        self.mesh = mesh
        self.data_axis = data_axis
        self._rows = DataRows(mesh, data_axis)
        # What the last public fit call did: ``utils.profiling.FIT_COUNTS``
        # (``kernel_calls`` the K7/K8 calls), report reads, stiff replays,
        # resample attempts, and steps attempted per NS tier.  Runners hold
        # this dict, so each call resets it in place.
        self.fit_counts = {}
        self._reset_counts()
        self._eps = EpsStream(self.device, self.fit_counts)
        self._runners = RunnerCache(counts=self.fit_counts)
        self.audit_log = []

    def _reset_counts(self) -> None:
        reset_counts(self.fit_counts, report_reads=0, replays=0, retries=0,
                     tiers=[0] * len(self._ns_tiers()))

    def _fused_mode(self, batch_size: int):
        """None | "update" | "step": which kernel path this config runs.

        None off the card or with ``use_fused=False``.  On a CUDA device the
        kernels take float32 with ``bam_kernel_supports(B, D)``; anything
        else raises rather than running the plain step on the card.  Under
        a mesh the mode is "update" (K7 on the gathered rows), and B must
        split evenly over the data axis."""
        if self.use_fused is False or not on_gpu(self.device):
            return None
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"dtype {self.dtype}: the CUDA kernels take float32; pass "
                "use_fused=False for the plain-torch step on the card")
        if not bam_kernel_supports(batch_size, self.D):
            raise ValueError(
                f"B={batch_size}, D={self.D}: the BaM CUDA kernels take B in "
                f"{list(BAM_KERNEL_BATCH_RANGE)} and D in "
                f"{list(BAM_KERNEL_DIM_RANGE)}; pass use_fused=False for the "
                "plain-torch step on the card")
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

    def _ns_tiers(self):
        """((iters, gu_gate, lmax_gate), ...) from the configured long
        profile to the most benign tier; built-in tiers whose gates sit
        above the configured ones are pruned."""
        tier0 = (self.ns_iters, self.gu_gate, self.lmax_gate)
        if self.ns_profile == "long":
            return (tier0,)
        lower = tuple(t for t in BAM_NS_TIERS[1:]
                      if t[1] <= self.gu_gate and t[2] <= self.lmax_gate)
        return (tier0, *lower)

    def _draw(self, state, batch_size: int, offset: int = 0):
        return self._eps(state.seed, state.step + offset, batch_size, self.D,
                         self.dtype)

    def _attempt(self, s: FactorVIState, eps, reg):
        """One plain attempt on the SVD/eigh route with draw ``eps``."""
        _, vs = self._rows.score(self.lp_g, eps, s.mean, s.factor, self.dtype)
        mean_new, f_new, good = bam_eps_update(eps, vs, s.mean, s.factor,
                                               reg, solver=self.solver)
        return mean_new.to(self.dtype), f_new.to(self.dtype), good

    def _retry(self, s: FactorVIState, mean_new, f_new, good, reg,
               retries: int, batch_size: int):
        """The reference's resample loop: up to ``retries`` fresh draws from
        the retry stream while ``good`` is False (a host read each)."""
        tries = 0
        while tries < retries and not bool(good):
            tries += 1
            self.fit_counts["retries"] += 1
            with span("gsmvi.block.retry"):
                eps = self._eps(retry_seed(s.seed, s.step), tries,
                                batch_size, self.D, self.dtype)
                mean_new, f_new, good = self._attempt(s, eps, reg)
        return mean_new, f_new, good

    @staticmethod
    def _advance(s: FactorVIState, mean_new, f_new, good, ns_stats):
        """Select on ``good`` (a host bool or a device flag) and count."""
        if isinstance(good, bool):
            mean, f, g32 = ((mean_new, f_new, 1) if good
                            else (s.mean, s.factor, 0))
        else:
            mean = torch.where(good, mean_new, s.mean)
            f = torch.where(good, f_new, s.factor)
            g32 = good.to(torch.int32)
        return FactorVIState(mean, f, s.seed, s.step + 1,
                             s.n_accepted + g32, s.n_rejected + (1 - g32),
                             ns_stats)

    def _make_step(self, batch_size: int, regf, retries: int):
        """One-step runner of the "update" mode (K7) or the plain route."""
        mode = self._fused_mode(batch_size)
        tiers = self._ns_tiers()
        counts = self.fit_counts

        if mode != "update":
            def step(s: FactorVIState) -> FactorVIState:
                reg = regf(s.step)
                mean_new, f_new, good = self._attempt(
                    s, self._draw(s, batch_size), reg)
                if retries > 0:
                    mean_new, f_new, good = self._retry(
                        s, mean_new, f_new, good, reg, retries, batch_size)
                return self._advance(s, mean_new, f_new, good, s.ns_stats)

            return step

        def update(eps, vs, mean, f, s: FactorVIState, ef):
            reg = regf(s.step)
            tj = ns_tier_from_stats(*s.ns_stats, tiers)
            it, gg, lm = tiers[tj]
            with span("gsmvi.block.launch"):
                mean_new, f_new, rep = _bam_update_packed(
                    eps, vs, mean, f, reg, iters=it, lmax_gate=lm,
                    gu_gate=gg, ef=ef)
            with span("gsmvi.block.report"):
                r = rep.tolist()                # the one read of the step
            counts["kernel_calls"] += 1
            counts["report_reads"] += 1
            counts["tiers"][tj] += 1
            stiff = r[REP_STIFF] != 0
            good = r[REP_KEEP] != 0
            if stiff:
                # Replay on the SVD route with the SAME draw.
                counts["replays"] += 1
                with span("gsmvi.block.replay"):
                    mean_new, f_new, good = bam_eps_update(
                        eps, vs, mean, f, reg, solver=self.solver)
            # Feedback carry: adopt the kernel's stats just before a cadence
            # boundary or on a stiff flag.
            ns = (((r[REP_GU], r[REP_LMAX])
                   if (s.step + 1) % FEEDBACK_CADENCE == 0 or stiff
                   else s.ns_stats))
            if retries > 0:
                mean_new, f_new, good = self._retry(
                    s, mean_new, f_new, good, reg, retries, batch_size)
            return self._advance(s, mean_new, f_new, good, ns)

        # With no mesh this rank holds every row and nothing is gathered.
        gathered = make_gathered_update(self.mesh, self.data_axis, self.lp_g,
                                        update, pass_ef=True)

        def step(s: FactorVIState) -> FactorVIState:
            with span("gsmvi.block.draw"):
                eps = self._draw(s, batch_size)
            return gathered(self._rows.local(eps), s.mean, s.factor, s)

        return step

    def _replica_rows(self, s: FactorVIState, batch_size: int):
        """(eps, ef, vs) of stacked replicas at ``s.step``, (K, B, D) each,
        replica i's exactly as the single fit's step forms them: its draw,
        ``ef = eps F^T`` and ``lp_g`` on its own (B, D) rows.  Neither runs
        on the stack: cuBLAS rounds a batched product, or one over K B
        rows, differently from the B-row product of a single fit (on an
        H100, the Gaussian score on 8 x 32 stacked rows differed from the
        per-replica scores by up to 3e-4), which would break replica i =
        ``fit(seeds[i])``."""
        with span("gsmvi.block.draw"):
            eps = draw_replicas(self._eps, s.seed, s.step, batch_size,
                                self.D, self.dtype)
        ef = torch.stack([e @ f.T for e, f in zip(eps, s.factor)])
        vs = torch.stack([self.lp_g(m + x).to(torch.float32)
                          for m, x in zip(s.mean, ef)])
        return eps, ef, vs

    def _make_replica_step(self, batch_size: int, regf, retries: int):
        """One step of K stacked replicas in the "update" mode: the draws
        and scores (``_replica_rows``), ONE K7 launch sequence for all
        replicas, each on the NS tier its own carried stats pick
        (``_bam_update_replicas_packed``), ONE read of the (K, REP_SIZE)
        report, then per replica what the single fit's step does: a stiff
        replica replays on the SVD route with its own draw, a rejected one
        (``retries`` > 0) resamples from its own retry stream while the
        others hold, and each carries its own feedback stats.  Replica i
        ends each step in the single fit's state."""
        tiers = self._ns_tiers()
        counts = self.fit_counts

        def step(s: FactorVIState) -> FactorVIState:
            eps, ef, vs = self._replica_rows(s, batch_size)
            reg = regf(s.step)
            tjs = [ns_tier_from_stats(*st, tiers) for st in s.ns_stats]
            with span("gsmvi.block.launch"):
                mean_new, f_new, rep = _bam_update_replicas_packed(
                    eps, vs, s.mean, s.factor, reg, [tiers[j] for j in tjs],
                    ef=ef)
            with span("gsmvi.block.report"):
                r = rep.tolist()                # the one read of the step
            counts["kernel_calls"] += 1
            counts["report_reads"] += 1
            for tj in tjs:
                counts["tiers"][tj] += 1
            cadence = (s.step + 1) % FEEDBACK_CADENCE == 0
            stiff = [row[REP_STIFF] != 0 for row in r]
            keep = [row[REP_KEEP] != 0 for row in r]
            ns = tuple((row[REP_GU], row[REP_LMAX]) if cadence or st
                       else old for row, st, old in zip(r, stiff,
                                                        s.ns_stats))
            slow = [st or (retries > 0 and not kp)
                    for st, kp in zip(stiff, keep)]
            if not any(slow):
                g32 = (rep[:, REP_KEEP] != 0).to(torch.int32)
                return FactorVIState(mean_new, f_new, s.seed, s.step + 1,
                                     s.n_accepted + g32,
                                     s.n_rejected + (1 - g32), ns)
            out = []
            for i in range(len(s.seed)):
                si = replica(s, i)
                m, f, good = mean_new[i], f_new[i], keep[i]
                if stiff[i]:
                    counts["replays"] += 1
                    with span("gsmvi.block.replay"):
                        m, f, good = bam_eps_update(eps[i], vs[i], si.mean,
                                                    si.factor, reg,
                                                    solver=self.solver)
                if slow[i] and retries > 0:
                    m, f, good = self._retry(si, m, f, good, reg, retries,
                                             batch_size)
                out.append(self._advance(si, m, f, good, ns[i]))
            return stack_replicas(out)

        return step

    def _make_fused_runner(self, batch_size: int, regf, retries: int):
        """Chunk runner of the "step" mode on K8.

        Per block: the eps rows and regularizers of the next
        ``steps_per_call`` absolute steps, K8 on the tier the carried stats
        pick (the block stops at the next cadence boundary when the ladder
        has more than one tier), ONE read of the report, the feedback carry,
        and, if the block stopped on a stiff or (retries > 0) rejected
        sub-step, the replay of that step on the SVD route with the block's
        own draw, then resample attempts from the retry stream."""
        score_fn, params = self.fused_score
        spc = self.steps_per_call
        d = self.D
        tiers = self._ns_tiers()
        multis = [make_fused_bam_multistep(score_fn, len(params), batch_size,
                                           d, spc, iters=it, lmax_gate=lm,
                                           gu_gate=gg)
                  for (it, gg, lm) in tiers]
        stop_on_reject = 1 if retries > 0 else 0
        counts = self.fit_counts

        def replay(s: FactorVIState, eps) -> FactorVIState:
            counts["replays"] += 1
            counts["steps"] += 1
            reg = regf(s.step)
            with span("gsmvi.block.replay"):
                mean_new, f_new, good = self._attempt(s, eps, reg)
            if retries > 0:
                mean_new, f_new, good = self._retry(
                    s, mean_new, f_new, good, reg, retries, batch_size)
            return self._advance(s, mean_new, f_new, good, s.ns_stats)

        def run_chunk(state: FactorVIState, k: int) -> FactorVIState:
            step0 = state.step
            while state.step - step0 < k:
                nmax = min(spc, k - (state.step - step0))
                if len(tiers) > 1:
                    nmax = min(nmax, FEEDBACK_CADENCE
                               - state.step % FEEDBACK_CADENCE)
                tj = ns_tier_from_stats(*state.ns_stats, tiers)
                regs = [regf(state.step + j) for j in range(spc)]
                with span("gsmvi.block.draw"):
                    eps_block = torch.cat([self._draw(state, batch_size, j)
                                           for j in range(spc)])
                with span("gsmvi.block.launch"):
                    mean, f, rep = multis[tj].packed(
                        regs, nmax, stop_on_reject, eps_block, state.mean,
                        state.factor, *params)
                with span("gsmvi.block.report"):
                    r = rep.tolist()            # the one read of the block
                n_done, n_acc = int(r[REP_NDONE]), int(r[REP_NACC])
                stopped = int(r[REP_STOPPED])
                counts["steps"] += n_done
                counts["kernel_calls"] += 1
                counts["report_reads"] += 1
                counts["tiers"][tj] += n_done + (stopped > 0)
                end = state.step + n_done
                upd = (end % FEEDBACK_CADENCE == 0 and n_done > 0) \
                    or stopped == 1
                ns = (r[REP_GU], r[REP_LMAX]) if upd else state.ns_stats
                state = FactorVIState(mean, f, state.seed, end,
                                      state.n_accepted + n_acc,
                                      state.n_rejected + (n_done - n_acc),
                                      ns)
                if stopped:
                    state = replay(state, eps_block[n_done * batch_size:
                                                    (n_done + 1) * batch_size])
            return state

        return run_chunk

    def _make_tiered_update(self):
        """K7 on the NS tier that carried stats pick: ``update(eps, vs,
        mean, f, reg, ns_stats) -> (mean, f, good, stiff)`` (the audit's
        fused side; ``good`` is K7's keep flag)."""
        tiers = self._ns_tiers()

        def update(eps, vs, mean, f, reg, ns_stats):
            it, gg, lm = tiers[ns_tier_from_stats(*ns_stats, tiers)]
            mean_new, f_new, rep = _bam_update_packed(
                eps, vs, mean, f, reg, iters=it, lmax_gate=lm, gu_gate=gg)
            return mean_new, f_new, rep[REP_KEEP] != 0, rep[REP_STIFF] != 0

        return update

    def _make_audit_hook(self, batch_size: int, regf, tol: float):
        """The periodic fused-vs-SVD audit hook (``utils/audit.py``), its
        audit cached per config; None, with a warning, when this config runs
        no kernel."""
        self.audit_log = []
        if self._fused_mode(batch_size) is None:
            warnings.warn("audit_every set but the fused kernel path is not "
                          "active for this config; no audits will run",
                          stacklevel=3)
            return None
        audit_fn = self._runners.get(
            ("audit", batch_size, self.ns_iters, self.ns_profile,
             self.lmax_gate, self.gu_gate, self.dtype),
            (regf, self.lp_g),
            lambda: make_bam_audit(self.lp_g, batch_size, self.D, regf,
                                   self._make_tiered_update()))
        return make_audit_hook(audit_fn, self.audit_log, tol, "FactorBaM")

    def _get_runner(self, batch_size: int, regf, retries: int):
        mode = self._fused_mode(batch_size)
        score_objs = ()
        if self.fused_score is not None:
            score_objs = (self.fused_score[0], *self.fused_score[1])

        def build():
            if mode == "step":
                return self._make_fused_runner(batch_size, regf, retries)
            return make_chunk_runner(self._make_step(batch_size, regf,
                                                     retries),
                                     counts=self.fit_counts)

        return self._runners.get(
            (batch_size, retries, mode, self.steps_per_call, self.solver,
             self.lmax_gate, self.gu_gate, self.ns_iters, self.ns_profile,
             self.dtype), (regf, *score_objs), build)

    def fit_batch(self, seeds, regf, mean=None, cov=None, batch_size=2,
                  niter=5000, retries=10, return_state=False):
        """K independent FactorBaM replicas, one per seed in ``seeds``, each
        ``niter + 1`` steps; returns (means (K, D), covs (K, D, D)), or the
        stacked ``FactorVIState`` (``ns_stats`` one pair per replica).

        ``regf`` must be a pure schedule: one ``reg`` serves every replica
        of a step.  ``mean``/``cov`` are broadcast to every replica or carry
        a leading K axis.  Replica i draws what ``fit(seeds[i])`` draws and
        ends where that fit ends, on the route ``fit`` takes without
        ``fused_score`` (the "update" mode: ``lp_g`` is opaque here, called
        on each replica's rows).  On the card each step is one K7 launch
        sequence for all K replicas (``_make_replica_step``); off the card,
        or with ``use_fused=False``, the plain step per replica.  Monitors
        and audits are not supported (``fit`` takes them); ``fit_counts``
        holds the replica launches, replays and retries of the call."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            no_mesh(self, "FactorBaM.fit_batch")
            mode = self._fused_mode(batch_size)
            seeds = tuple(int(s) for s in seeds)
            k, d, dev, dtype = len(seeds), self.D, self.device, self.dtype
            means0 = broadcast_replicas(mean, torch.zeros(d), k, (d,), dtype,
                                        dev)
            if cov is None:
                f0 = broadcast_replicas(None, torch.eye(d), k, (d, d), dtype,
                                        dev)
            else:
                # Factored one replica at a time, as fit factors its cov.
                f0 = torch.stack([safe_cholesky(c) for c in broadcast_replicas(
                    cov, None, k, (d, d), dtype, dev)])
            zero = torch.zeros(k, dtype=torch.int32, device=dev)
            state = FactorVIState(means0, f0, seeds, 0, zero, zero,
                                  (NS_STATS_INIT,) * k)

            def build():
                step = (per_replica(self._make_step(batch_size, regf, retries))
                        if mode is None else
                        self._make_replica_step(batch_size, regf, retries))
                return make_chunk_runner(step, counts=self.fit_counts)

            run = self._runners.get(
                ("batch", batch_size, retries, mode is None, self.solver,
                 self.lmax_gate, self.gu_gate, self.ns_iters, self.ns_profile,
                 self.dtype), (regf, self.lp_g), build)
            call.phase("loop")
            state = run(state, niter + 1)
            call.phase("finish")
            if return_state:
                return state
            return state.mean, factor_to_cov(state.factor)

    def fit(self, seed: int, regf, mean=None, cov=None, batch_size=2,
            niter=5000, nprint=10, verbose=True, check_goodness=True,
            monitor=None, retries=10, jitter=None, return_state=False,
            state=None, audit_every=0, audit_tol=1e-3):
        """Run ``niter + 1`` BaM steps; returns (mean, cov), or the
        ``FactorVIState`` with ``return_state``.  ``regf`` is a pure
        function of the iteration index (``Regularizers``).  ``state``
        resumes a saved trajectory exactly, ignoring ``seed``/``mean``/
        ``cov``.  ``jitter`` is accepted and inert: this route's proposal is
        PD by construction.  ``check_goodness`` is accepted for parity;
        checking is always on.

        ``audit_every`` — when > 0 and a kernel path is active, every
        ``audit_every`` iterations compare the (tiered) fused NS update
        with the exact thin-SVD step on a fresh, stream-disjoint draw from
        the live state (``utils/audit.py``); an accepted non-stiff step
        deviating beyond ``audit_tol`` warns.  Records land in
        ``self.audit_log``; the trajectory is unchanged.  ``lp_g`` must take
        tensors: a numpy score raises ``TypeError``, as JAX's does
        (``gsmvi_tpu/bam_factor.py:528-531``); ``BaM`` takes one."""
        with fit_call(self) as call:
            call.phase("setup")
            pin_fp32()
            dev, dtype = self.device, self.dtype
            self._fused_mode(batch_size)     # the kernels' range gates first
            if not takes_tensors(self.lp_g, batch_size, self.D, dtype, dev):
                raise TypeError(
                    "FactorBaM requires an lp_g that takes (B, D) tensors of "
                    "the fit's dtype and device; use BaM for numpy score "
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
                state = FactorVIState(mean0, f0, int(seed), 0, zero, zero)
            # The kernels take contiguous operands (a LAPACK factor may not
            # be).
            state = state._replace(mean=state.mean.contiguous(),
                                   factor=state.factor.contiguous())
            state_hook = (self._make_audit_hook(batch_size, regf, audit_tol)
                          if audit_every else None)
            run_chunk = self._get_runner(batch_size, regf, retries)
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
            return state.mean, factor_to_cov(state.factor)
