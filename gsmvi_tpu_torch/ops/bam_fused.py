"""The BaM NS step: plain torch versions and the Hopper kernel wrappers.

Counterpart of ``gsmvi_tpu/ops/pallas/bam_fused.py``.  One exact
rank-(B+1) BaM step in factor coordinates (``ops/bam_eps.py``) with the
small-space spectral map evaluated as a matrix function of the Gram
G = Y^T Y by matmul-only Newton-Schulz chains:

    psi(G) = -4 (I + s)^{-2} (I + sqrt(2) (I + s)^{-1/2})^{-1},
    s = sqrt(I + 4 G),    F' = F W1 (I + Y psi(G) Y^T).

Forming G in float32 perturbs its spectrum by ~eps * lmax(G), so a step
whose row-sum bound on lmax(G) exceeds ``lmax_gate``, or whose cu-chain Gram
bound gu exceeds ``gu_gate``, is flagged STIFF and the fitter replays it on
the SVD route (``ops/bam_eps.py``) with the same draw.  Two TPU kernels are
ported here:

- K7 ``bam_eps_update_fused``: the update, three residual gates (tol 3e-3),
  the trace gate, both stiffness gates, keep = good & ~stiff, the select,
  and the (gu_ub, lmax_ub) export.  Plain version:
  ``bam_eps_update_ns_reference`` over ``bam_smallspace_ns_reference``
  (a line-by-line twin of ``_bam_smallspace_ns``).  Its small space alone
  is ``bam_smallspace``, plain version ``bam_smallspace_stacks_reference``.
- K8 ``make_fused_bam_multistep``: up to ``steps_per_call`` whole BaM steps
  per call with an external eps block and per-step regularizers, stopping
  at the first stiff (or, with ``stop_on_reject``, rejected) sub-step.
  Plain version: ``bam_multistep_reference``.

On the card a K7 call is eight launches: ``vf = v F`` and ``t = vf F^T``
on the split-k thin product (``thin_gemm.cu``), the small space on a
thread-block cluster of ``cluster_columns(D)`` blocks
(``ops/cuda/csrc/bam_smallspace_cluster.cu``; above ``BAM_SHARED_MAX_B``
the global-memory chain ``bam_smallspace_large`` of
``smallspace_global.cu`` in its place), the fat apply on the GEMM template
into a second buffer with per-tile sums of squares, the two mean matvecs on
F' (thin product), a one-block finalize (trace gate, keep, mean, report;
``bam_smallspace.cu``) and a grid select of F or F'.  A K8 call loops its
sub-steps on the host with the ``ef``/``x`` thin product and the score
before those; each launch reads the report's ``stopped`` word and does
nothing once the block has stopped.  Both return a float32 report of
``REP_SIZE`` values on the device (``REP_*`` indices), so a caller reads
every flag and statistic of a call in ONE device-to-host transfer
(``_bam_update_packed``, ``step.packed``).
Wrappers run the plain version on CPU tensors, launch on CUDA tensors, and
raise on what the kernels do not take; they never fall back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..state import NS_STATS_INIT
from .fused_step import (KERNEL_DIM_RANGE, KERNEL_WRAPPERS, _library,
                         _newton_inv, _ns_sqrt, _on_cpu, _ptr, _require,
                         _spd_norm_ub, _stream, _thin, cluster_columns,
                         ns_sqrt_both)

# Newton-Schulz sweep counts (u_sqrt, cu_inv, s1_sqrt, p_invsqrt, w_inv),
# sized by the JAX package for the gated envelope (bam_fused.py:65-76).
# CAUTION: the residual gates catch catastrophic loss, not slow bias.
BAM_NS_ITERS_DEFAULT = (20, 13, 16, 11, 6)
# lmax(G) above which the f32 Gram no longer resolves O(1) eigenvalues.
LMAX_GATE_DEFAULT = 1e4
# Row-sum bound on lmax(Om^T Om) above which the cu chain biases in f32.
GU_GATE_DEFAULT = 5e4
NS_TOL = 3e-3
# The measured-feedback ladder, stiffest first: (iters, gu_gate, lmax_gate)
# (bam_fused.py:107-112).  Tier choice is throughput-only: each tier's own
# in-kernel gates decide stiffness.
BAM_NS_TIERS = (
    (BAM_NS_ITERS_DEFAULT, GU_GATE_DEFAULT, 1e4),
    ((10, 7, 10, 7, 4), 64.0, 1500.0),
    ((7, 5, 8, 5, 4), 14.0, 120.0),
    ((5, 4, 6, 4, 3), 3.0, 12.0),
)
# The carried statistics update only at absolute steps just before a
# multiple of FEEDBACK_CADENCE and at stiff steps, which keeps trajectories
# invariant to steps_per_call and chunking (bam_fused.py:114-136).
FEEDBACK_CADENCE = 64
FEEDBACK_MARGIN = 0.7

# Report layout (float32), shared with bam_smallspace.cu.  The small space
# hands the finalize SS_SIZE results (gu_ub, lmax_ub, res_ok, stiff, and the
# trace screen's two small-Gram sums).
REP_KEEP, REP_STIFF, REP_GU, REP_LMAX = 0, 1, 2, 3
REP_NDONE, REP_NACC, REP_STOPPED, REP_APPLY = 4, 5, 6, 7
REP_SIZE = 8
SS_SIZE = 6

# Shapes the CUDA kernels take.  The small space is padded to kpad = B + 8
# (the TPU kernel's padding, which the gates depend on).  The cluster kernel
# (``bam_smallspace_cluster.cu``) keeps, in each block's shared memory,
# twelve (kpad, kpad) float32 matrices at a padded leading dimension, three
# (kpad, 36) row slabs and the column sums' (3, 8, 32) partials; its chain
# products give each of 256 threads a T x T tile of a 16T x 16T grid, T <= 4,
# so kpad <= 64: B <= 56 (BAM_SHARED_MAX_B) at 227,456 of the 232,448 bytes
# a block may use on Hopper.  Above, up to B = 128 (the JAX kernel's own
# top, ``gsmvi_tpu/ops/pallas/bam_fused.py:345-352``), the small space is a
# chain of grid launches with its matrices in global memory
# (``smallspace_global.cu``).  The D range is that of the GSM kernels
# (``fused_step.KERNEL_DIM_RANGE``); D is masked at the tile edges.
SMEM_LIMIT_BYTES = 232448
_KPAD_MAX, _NMAT, _SLAB_LD, _COL_PARTS = 64, 12, 36, 3 * 8 * 32
_GEMM_TILE = 32                      # gemm.cuh's output tile


def bam_cluster_tile(b: int) -> int:
    """The chain tile T of the BaM cluster small space at batch ``b``: the
    smallest T in 1-4 with kpad = b + 8 <= 16 T."""
    return -(-(b + 8) // 16)


def _cluster_ld(kpad: int, tile: int) -> int:
    """The (kpad, kpad) matrices' leading dimension: a multiple of 4, of 12
    at T = 3 (``bam_cluster_ld`` in ``bam_smallspace_cluster.cuh``)."""
    step = 12 if tile == 3 else 4
    return -(-kpad // step) * step


def bam_smallspace_smem_bytes(b: int) -> int:
    """Dynamic shared memory of the BaM cluster small space at batch ``b``."""
    kpad = b + 8
    ld = _cluster_ld(kpad, bam_cluster_tile(b))
    return 4 * (_NMAT * ld * ld + 3 * ld * _SLAB_LD + _COL_PARTS + 32)


BAM_SHARED_MAX_B = max(b for b in range(1, _KPAD_MAX - 7)
                       if bam_smallspace_smem_bytes(b) <= SMEM_LIMIT_BYTES)
BAM_KERNEL_BATCH_RANGE = (1, 128)
BAM_KERNEL_DIM_RANGE = KERNEL_DIM_RANGE


def bam_kernel_supports(b: int, d: int) -> bool:
    """True iff the BaM CUDA kernels take batch ``b`` and dimension ``d``."""
    return (BAM_KERNEL_BATCH_RANGE[0] <= b <= BAM_KERNEL_BATCH_RANGE[1]
            and BAM_KERNEL_DIM_RANGE[0] <= d <= BAM_KERNEL_DIM_RANGE[1])


def ns_tier_from_stats(gu_ub, lmax_ub, tiers=BAM_NS_TIERS,
                       margin: float = FEEDBACK_MARGIN) -> int:
    """Most benign tier whose gates the measured stats pass with ``margin``
    headroom: the count of benign tiers passed, as JAX counts it, with its
    float32 comparisons.  inf stats (cold start) select tier 0."""
    gu = np.float32(float(gu_ub))
    lm = np.float32(float(lmax_ub))
    return sum(int(gu < np.float32(margin * gg) and lm < np.float32(margin * lg))
               for (_, gg, lg) in tiers[1:])


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _bam_smallspace_core(om_t, q_t, fom_t, qf, *, iters, lmax_gate: float,
                         gu_gate: float, tol: float):
    """The chains and stacked rows of ``_bam_smallspace_ns`` from its
    (kpad, D) row objects om_t, q_t = fu_t F, fom_t = (F Om)^T and qf =
    q_t F^T.  Returns (stack_u, stack_w, res_ok, stiff, gu_ub, lmax_ub, ta,
    tb): the (2 kpad, D) rows of F' = F + stack_u^T stack_w, the three
    residual gates' verdict, the stiffness flag, the two gate statistics and
    the trace screen's sums, ||F W1||^2 = ||F||^2 + 2 ta + tb."""
    kpad = om_t.shape[0]
    eye_k = torch.eye(kpad, dtype=om_t.dtype, device=om_t.device)
    gu = om_t @ om_t.T
    gu = 0.5 * (gu + gu.T)
    gu_ub = _spd_norm_ub(gu)
    s_u = _ns_sqrt(eye_k + gu, iters[0])
    s_u = 0.5 * (s_u + s_u.T)
    res_u = torch.sum((s_u @ s_u - (eye_k + gu)) ** 2) \
        / (torch.sum((eye_k + gu) ** 2) + 1e-30)
    cu = _newton_inv(eye_k + s_u, iters[1])

    omq = om_t @ q_t.T
    y_t = q_t + (cu @ omq).T @ om_t

    g = y_t @ y_t.T
    g = 0.5 * (g + g.T)
    lmax_ub = _spd_norm_ub(g)
    stiff = (lmax_ub > lmax_gate) | (gu_ub > gu_gate)
    a1 = eye_k + 4.0 * g
    s1 = _ns_sqrt(a1, iters[2])
    s1 = 0.5 * (s1 + s1.T)
    res_1 = torch.sum((s1 @ s1 - a1) ** 2) / (torch.sum(a1 ** 2) + 1e-30)
    ips = eye_k + s1
    _, p = ns_sqrt_both(ips, iters[3])
    p = 0.5 * (p + p.T)
    res_p = torch.sum(((p @ p) @ ips - eye_k) ** 2) / kpad
    winv = _newton_inv(eye_k + math.sqrt(2.0) * p, iters[4])
    p2 = p @ p
    tau = -4.0 * ((p2 @ p2) @ winv)
    tau = 0.5 * (tau + tau.T)

    w1row = cu @ om_t
    cu_omq = cu @ omq
    yf = qf + cu_omq.T @ fom_t
    yw1 = y_t @ w1row.T
    fyT = yf + yw1 @ fom_t
    u2row = tau @ fyT
    stack_u = torch.cat([fom_t, u2row])
    stack_w = torch.cat([w1row, y_t])
    w1f = cu @ fom_t
    ta = torch.sum(w1f * fom_t)
    tb = torch.sum((fom_t @ fom_t.T) * (w1row @ w1row.T))
    res_ok = (res_u < tol) & (res_1 < tol) & (res_p < tol)
    return stack_u, stack_w, res_ok, stiff, gu_ub, lmax_ub, ta, tb


def bam_smallspace_ns_reference(e, v, mu, f, reg, *, batch: int,
                                iters=BAM_NS_ITERS_DEFAULT,
                                lmax_gate: float = LMAX_GATE_DEFAULT,
                                gu_gate: float = GU_GATE_DEFAULT,
                                tol: float = NS_TOL, ef_t=None):
    """Twin of ``_bam_smallspace_ns``: e, v (B, D); mu (1, D); f (D, D);
    ``ef_t`` optional ``e f^T``.  Returns (mu_new (1, D), f_new, good,
    stiff, gu_ub, lmax_ub): the proposal, the accept flag of the residual
    and trace screens, the stiffness flag and the two gate statistics."""
    b = batch
    d = f.shape[-1]
    kpad = b + 8
    dt, dev = f.dtype, f.device
    reg = torch.as_tensor(reg, dtype=torch.float32)
    r1 = reg / (1.0 + reg)
    epsbar = torch.mean(e, dim=0, keepdim=True)
    gbar = torch.mean(v, dim=0, keepdim=True)
    ed = e - epsbar
    gd = v - gbar
    sru = torch.sqrt(reg / b)
    zeros_pad = torch.zeros((kpad - b - 1, d), dtype=dt, device=dev)
    om_t = torch.cat([sru * ed, -torch.sqrt(r1) * epsbar, zeros_pad])
    fu_t = torch.cat([sru * gd, torch.sqrt(r1) * gbar, zeros_pad])
    q_t = fu_t @ f
    if ef_t is None:
        fom_t = om_t @ f.T
        ef_bar = None
    else:
        ef_bar = torch.mean(ef_t, dim=0, keepdim=True)
        fom_t = torch.cat([sru * (ef_t - ef_bar), -torch.sqrt(r1) * ef_bar,
                           zeros_pad])
    qf = q_t @ f.T
    stack_u, stack_w, res_ok, stiff, gu_ub, lmax_ub, ta, tb = \
        _bam_smallspace_core(om_t, q_t, fom_t, qf, iters=iters,
                             lmax_gate=lmax_gate, gu_gate=gu_gate, tol=tol)
    f_new = f + stack_u.T @ stack_w
    tr_v = torch.sum(f * f) + 2.0 * ta + tb
    tr_new = torch.sum(f_new * f_new)
    good = (torch.isfinite(tr_new) & (tr_new <= 1.05 * tr_v + 1e-6)
            & res_ok)

    t1 = gbar @ f_new
    s_gbar = t1 @ f_new.T
    xbar = mu + (ef_bar if ef_bar is not None else epsbar @ f.T)
    mu_new = mu / (1.0 + reg) + r1 * (s_gbar + xbar)
    return mu_new, f_new, good, stiff, gu_ub, lmax_ub


def bam_smallspace_stacks_reference(e, v, vf, t, ef, mean, reg, *,
                                    batch: int, iters=BAM_NS_ITERS_DEFAULT,
                                    lmax_gate: float = LMAX_GATE_DEFAULT,
                                    gu_gate: float = GU_GATE_DEFAULT,
                                    tol: float = NS_TOL):
    """The small space alone (the plain version of ``bam_smallspace``), in
    the kernel's formulation: om_t, q_t, qf and fom_t assembled from the
    rows e, vf = v F, t = vf F^T and ef = e F^T (B, D) and their column
    means, then ``bam_smallspace_ns_reference``'s chains line for line.
    Returns (stack_u, stack_w, vec, ss): the fat apply's rows of
    F' = F + stack_u^T stack_w ((2 (B+1), D) each, the kpad pad rows, which
    are zero, left out), vec = [gbar; mean + efbar] (2, D) and ss, the
    ``SS_SIZE`` results (gu_ub, lmax_ub, res_ok, stiff, ta, tb) that the
    finalize reads."""
    b = batch
    d = e.shape[-1]
    kpad = b + 8
    reg = torch.as_tensor(reg, dtype=torch.float32)
    r1 = reg / (1.0 + reg)
    sru = torch.sqrt(reg / b)
    sr1 = torch.sqrt(r1)
    pad = torch.zeros((kpad - b - 1, d), dtype=e.dtype, device=e.device)

    def centred(x, sign):
        """[sru (x - xbar); sign sr1 xbar; 0] (kpad, D), and xbar."""
        xbar = torch.mean(x, dim=0, keepdim=True)
        return torch.cat([sru * (x - xbar), sign * (sr1 * xbar), pad]), xbar

    om_t, _ = centred(e, -1.0)
    q_t, _ = centred(vf, 1.0)
    qf, _ = centred(t, 1.0)
    fom_t, ef_bar = centred(ef, -1.0)
    stack_u, stack_w, res_ok, stiff, gu_ub, lmax_ub, ta, tb = \
        _bam_smallspace_core(om_t, q_t, fom_t, qf, iters=iters,
                             lmax_gate=lmax_gate, gu_gate=gu_gate, tol=tol)
    rows = torch.cat([torch.arange(b + 1), kpad + torch.arange(b + 1)])
    vec = torch.cat([torch.mean(v, dim=0, keepdim=True),
                     mean.reshape(1, d) + ef_bar])
    ss = torch.stack([gu_ub, lmax_ub, res_ok.to(e.dtype), stiff.to(e.dtype),
                      ta, tb]).to(e.dtype)
    return stack_u[rows], stack_w[rows], vec, ss


def bam_eps_update_ns_reference(eps, vs, mean, f, reg,
                                iters=BAM_NS_ITERS_DEFAULT,
                                lmax_gate: float = LMAX_GATE_DEFAULT,
                                gu_gate: float = GU_GATE_DEFAULT, ef=None):
    """Twin of ``_update_kernel``: (mean, f, keep, stiff, ns_stats) with the
    old state kept unless keep = good & ~stiff."""
    b, d = eps.shape
    mu_new, f_new, good, stiff, gu_ub, lmax_ub = bam_smallspace_ns_reference(
        eps, vs, mean.reshape(1, d), f, reg, batch=b, iters=iters,
        lmax_gate=lmax_gate, gu_gate=gu_gate, ef_t=ef)
    keep = good & ~stiff
    return (torch.where(keep, mu_new[0], mean), torch.where(keep, f_new, f),
            keep, stiff, torch.stack([gu_ub, lmax_ub]))


def bam_multistep_reference(score_fn, params, regs, nmax: int,
                            stop_on_reject, eps_block, mean, f, *,
                            batch: int, iters=BAM_NS_ITERS_DEFAULT,
                            lmax_gate: float = LMAX_GATE_DEFAULT,
                            gu_gate: float = GU_GATE_DEFAULT):
    """Twin of K8's body: the first ``nmax`` sub-steps of the block, each
    ``ef = e F^T``, ``x = mu + ef``, ``v = score_fn(x, *params)`` and the NS
    update, stopping at the first stiff (or, with ``stop_on_reject``, not
    accepted) sub-step, which is left unconsumed.  Masked on the device as
    the TPU kernel is, so no host read.  Returns (mean, f, n_done, n_acc,
    stopped, ns_stats): int32 counts, ``stopped`` 0 (ran to nmax), 1 (stiff)
    or 2 (rejected with stop_on_reject), and the (gu_ub, lmax_ub) of the
    last attempted sub-step (inf if none)."""
    d = f.shape[-1]
    dev = f.device
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    n_done, n_acc, stopped = i32(0), i32(0), i32(0)
    stats = torch.full((2,), float("inf"), dtype=torch.float32, device=dev)
    sor = bool(stop_on_reject)
    mu = mean.reshape(1, d)
    for j in range(int(nmax)):
        active = stopped == 0
        e = eps_block[j * batch:(j + 1) * batch]
        ef = e @ f.T
        v = score_fn(mu + ef, *params)
        mu_new, f_new, good, stiff, gu_ub, lmax_ub = \
            bam_smallspace_ns_reference(e, v, mu, f, float(regs[j]),
                                        batch=batch, iters=iters,
                                        lmax_gate=lmax_gate, gu_gate=gu_gate,
                                        ef_t=ef)
        stop_now = active & (stiff | (~good if sor else torch.zeros_like(good)))
        consume = active & ~stop_now
        accept = consume & good
        mu = torch.where(accept, mu_new, mu)
        f = torch.where(accept, f_new, f)
        stats = torch.where(active, torch.stack([gu_ub, lmax_ub]), stats)
        n_done = n_done + consume.to(torch.int32)
        n_acc = n_acc + accept.to(torch.int32)
        stopped = torch.where(stop_now, torch.where(stiff, i32(1), i32(2)),
                              stopped)
    return mu[0], f, n_done, n_acc, stopped, stats


def _plain_report(*, keep=False, stiff=False, stats=NS_STATS_INIT, n_done=0,
                  n_acc=0, stopped=0, apply=False):
    """The report a kernel call writes, from the plain version's outputs
    (host values of CPU tensors)."""
    rep = [0.0] * REP_SIZE
    rep[REP_KEEP], rep[REP_STIFF] = float(bool(keep)), float(bool(stiff))
    rep[REP_GU], rep[REP_LMAX] = (float(x) for x in stats)
    rep[REP_NDONE], rep[REP_NACC] = float(int(n_done)), float(int(n_acc))
    rep[REP_STOPPED], rep[REP_APPLY] = float(int(stopped)), float(bool(apply))
    return torch.tensor(rep, dtype=torch.float32)


# ---------------------------------------------------------------------------
# CUDA launch helpers
# ---------------------------------------------------------------------------

def _require_bam_shape(b: int, d: int) -> None:
    if not bam_kernel_supports(b, d):
        raise ValueError(
            f"BaM CUDA kernels take B in [{BAM_KERNEL_BATCH_RANGE[0]}, "
            f"{BAM_KERNEL_BATCH_RANGE[1]}] and D in [{BAM_KERNEL_DIM_RANGE[0]}"
            f", {BAM_KERNEL_DIM_RANGE[1]}], got B={b}, D={d}")


class _BamBuffers:
    """Scratch of one BaM update on the card, allocated once per call."""

    def __init__(self, b: int, d: int, device, with_f_prop: bool = False):
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        k1 = b + 1
        self.vf, self.t = empty(b, d), empty(b, d)
        self.rows = empty(4 * k1, d)
        self.su, self.sw = empty(2 * k1, d), empty(2 * k1, d)
        self.vec = empty(2, d)
        self.ss = empty(8)
        self.t1, self.sg = empty(1, d), empty(1, d)
        self.nparts = (-(-d // _GEMM_TILE)) ** 2
        self.partial = empty(2 * self.nparts)
        self.f_prop = empty(d, d) if with_f_prop else None
        self.ws = (empty(_library().size("gsmvi_bam_large_ws", b))
                   if b > BAM_SHARED_MAX_B else None)


def _launch_bam_smallspace(lib, stream, e, v, ef, mean_in, buf: _BamBuffers,
                           reg, iters, lmax_gate, gu_gate, halt=None) -> None:
    """The small space of one update, from ``buf.vf`` and ``buf.t``: the
    stacked rows ``buf.su``/``buf.sw``, ``buf.vec`` and ``buf.ss``.  Up to
    ``BAM_SHARED_MAX_B`` on a cluster of ``cluster_columns(D)`` blocks
    (counted in ``bam_smallspace.launches``), above on the global-memory
    chain (``bam_smallspace_large``)."""
    b, d = e.shape
    args = (_ptr(e), _ptr(v), _ptr(buf.vf), _ptr(buf.t), _ptr(ef),
            _ptr(mean_in), _ptr(buf.rows), _ptr(buf.su), _ptr(buf.sw),
            _ptr(buf.vec), _ptr(buf.ss), _ptr(halt))
    scalars = (float(reg), *iters, float(lmax_gate), float(gu_gate), NS_TOL)
    if buf.ws is None:
        bam_smallspace.launches += 1
        lib.call("gsmvi_bam_smallspace_cluster", *args, b, d, *scalars,
                 *cluster_columns(d), bam_cluster_tile(b), stream)
    else:
        bam_smallspace_large(lib, stream, args, buf.ws, b, d, scalars)


def _launch_bam_update(lib, stream, e, v, ef, mean_in, mean_out, f_in, f_dst,
                       f_prop, buf: _BamBuffers, reg, iters, lmax_gate,
                       gu_gate, rep, halt=None, multistep: int = 0,
                       stop_on_reject: int = 0) -> None:
    """One update's launches: vf, t (thin product), small space, fat apply
    (F' into ``f_prop``), the two mean matvecs on F' (thin product),
    finalize (mean into ``mean_out``, report into ``rep``) and the select of
    F' or ``f_in`` into ``f_dst``."""
    b, d = e.shape
    _thin(lib, stream, v, f_in, buf.vf, trans=False, halt=halt)
    _thin(lib, stream, buf.vf, f_in, buf.t, trans=True, halt=halt)
    _launch_bam_smallspace(lib, stream, e, v, ef, mean_in, buf, reg, iters,
                           lmax_gate, gu_gate, halt=halt)
    lib.call("gsmvi_bam_apply", _ptr(buf.su), _ptr(buf.sw), _ptr(f_in),
             _ptr(f_prop), _ptr(buf.partial), _ptr(halt), 2 * (b + 1), d,
             stream)
    _thin(lib, stream, buf.vec[:1], f_prop, buf.t1, trans=False, halt=halt)
    _thin(lib, stream, buf.t1, f_prop, buf.sg, trans=True, halt=halt)
    lib.call("gsmvi_bam_finalize", _ptr(buf.partial), buf.nparts,
             _ptr(buf.ss), _ptr(buf.sg), _ptr(buf.vec), _ptr(mean_in),
             _ptr(mean_out), _ptr(rep), multistep, stop_on_reject,
             float(reg), d, stream)
    lib.call("gsmvi_bam_select", _ptr(rep), _ptr(f_prop), _ptr(f_in),
             _ptr(f_dst), d * d, stream)


def bam_smallspace_large(lib, stream, args, ws, b: int, d: int,
                         scalars) -> None:
    """Launch the global-memory BaM small space (``smallspace_global.cu``)
    that K7 and K8 run above ``BAM_SHARED_MAX_B``: ``args`` are
    ``gsmvi_bam_smallspace_cluster``'s pointers, ``scalars`` (reg, iters,
    gates, tol), ``ws`` its workspace.  ``launches`` counts the updates that
    took it, so a run shows which small space ran."""
    bam_smallspace_large.launches += 1
    lib.call("gsmvi_bam_smallspace_large", *args, _ptr(ws), b, d, *scalars,
             stream)


bam_smallspace_large.launches = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _bam_update_packed(eps, vs, mean, f, reg, iters=BAM_NS_ITERS_DEFAULT,
                       lmax_gate: float = LMAX_GATE_DEFAULT,
                       gu_gate: float = GU_GATE_DEFAULT, ef=None):
    """K7 as (mean, f, report): the report is a float32 (REP_SIZE,) tensor
    on the operands' device, read by a caller in one transfer."""
    b, d = eps.shape
    iters = tuple(int(i) for i in iters)
    tensors = [eps, vs, mean, f] + ([ef] if ef is not None else [])
    if _on_cpu(*tensors):
        m, ff, keep, stiff, stats = bam_eps_update_ns_reference(
            eps, vs, mean, f, reg, iters=iters, lmax_gate=lmax_gate,
            gu_gate=gu_gate, ef=ef)
        return m, ff, _plain_report(keep=keep, stiff=stiff, stats=stats,
                                    n_done=1, n_acc=keep, apply=keep)
    _require_bam_shape(b, d)
    for name, t, shape in (("eps", eps, (b, d)), ("vs", vs, (b, d)),
                           ("mean", mean, (d,)), ("f", f, (d, d))):
        _require(name, t, shape)
    lib = _library()
    stream = _stream(eps.device)
    bam_eps_update_fused.launches += 1
    if ef is None:
        ef = torch.empty_like(eps)
        _thin(lib, stream, eps, f, ef, trans=True)
    else:
        _require("ef", ef, (b, d))
    buf = _BamBuffers(b, d, eps.device)
    mean_out = torch.empty_like(mean)
    f_out = torch.empty_like(f)
    rep = torch.empty(REP_SIZE, dtype=torch.float32, device=eps.device)
    _launch_bam_update(lib, stream, eps, vs, ef, mean, mean_out, f, f_out,
                       f_out, buf, reg, iters, lmax_gate, gu_gate, rep)
    return mean_out, f_out, rep


def bam_eps_update_fused(eps, vs, mean, f, reg, iters=BAM_NS_ITERS_DEFAULT,
                         lmax_gate: float = LMAX_GATE_DEFAULT,
                         gu_gate: float = GU_GATE_DEFAULT, ef=None):
    """K7: BaM NS update + residual, trace and stiffness gates + select.

    eps, vs (B, D); mean (D,); f (D, D); ``reg`` a float; ``ef`` optional
    ``eps @ f.T`` (the sampling product a caller already formed).  Returns
    (mean, f, good, stiff, ns_stats) with the old state kept unless
    good & ~stiff; ``good`` here is that keep flag, as in JAX; ``stiff``
    asks the caller to replay the step on the SVD route with the same eps;
    ``ns_stats`` is the measured (gu_ub, lmax_ub), float32 (2,).
    """
    mean_out, f_out, rep = _bam_update_packed(eps, vs, mean, f, reg, iters,
                                              lmax_gate, gu_gate, ef)
    return (mean_out, f_out, rep[REP_KEEP] != 0, rep[REP_STIFF] != 0,
            rep[REP_GU:REP_LMAX + 1])


bam_eps_update_fused.launches = 0


def make_fused_bam_multistep(score_fn, n_params: int, batch: int, d: int,
                             steps_per_call: int, iters=BAM_NS_ITERS_DEFAULT,
                             lmax_gate: float = LMAX_GATE_DEFAULT,
                             gu_gate: float = GU_GATE_DEFAULT):
    """K8: up to ``steps_per_call`` whole BaM steps per call.

    Returns ``step(regs, nmax, stop_on_reject, eps_block, mean, f, *params)
    -> (mean, f, n_done, n_acc, stopped, ns_stats)`` over the first ``nmax``
    (<= spc) sub-steps of the ``(spc*B, D)`` eps block; ``regs`` holds spc
    floats (a host sequence or a tensor).  ``stopped`` is 0 (ran to nmax),
    1 (stiff) or 2 (rejected with ``stop_on_reject``); the stopping sub-step
    is not consumed and its stats are the ones returned.
    ``step.packed(...)`` is the same call returning (mean, f, report).
    ``score_fn(x, *params) -> (B, D)`` is the score, e.g. ``gaussian_score``.
    """
    spc = int(steps_per_call)
    iters = tuple(int(i) for i in iters)

    def packed(regs, nmax, stop_on_reject, eps_block, mean, f, *params):
        nmax = int(nmax)
        if not 0 <= nmax <= spc:
            raise ValueError(f"nmax={nmax} outside [0, {spc}]")
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        regs = [float(r) for r in (regs.tolist() if torch.is_tensor(regs)
                                   else regs)]
        if len(regs) != spc:
            raise ValueError(f"expected {spc} regularizers, got {len(regs)}")
        sor = int(bool(stop_on_reject))
        eps_block = eps_block.reshape(spc * batch, d)
        if _on_cpu(eps_block, mean, f):
            m, ff, nd, na, st, stats = bam_multistep_reference(
                score_fn, params, regs, nmax, sor, eps_block, mean, f,
                batch=batch, iters=iters, lmax_gate=lmax_gate,
                gu_gate=gu_gate)
            return m, ff, _plain_report(stats=stats, n_done=nd, n_acc=na,
                                        stopped=st)
        _require_bam_shape(batch, d)
        for name, t, shape in (("eps_block", eps_block, (spc * batch, d)),
                               ("mean", mean, (d,)), ("f", f, (d, d))):
            _require(name, t, shape)
        dev = eps_block.device
        mean_w, f_w = mean.clone(), f.clone()
        rep = torch.zeros(REP_SIZE, dtype=torch.float32, device=dev)
        if nmax == 0:
            rep[REP_GU:REP_LMAX + 1] = float("inf")
            return mean_w, f_w, rep
        lib = _library()
        stream = _stream(dev)
        make_fused_bam_multistep.launches += 1
        ef = torch.empty((batch, d), dtype=torch.float32, device=dev)
        x = torch.empty_like(ef)
        buf = _BamBuffers(batch, d, dev, with_f_prop=True)
        halt = rep[REP_STOPPED:]
        for j in range(nmax):
            e = eps_block[j * batch:(j + 1) * batch]
            _thin(lib, stream, e, f_w, ef, trans=True, mu=mean_w, x_out=x,
                  halt=halt)
            v = score_fn(x, *params)
            _require("score", v, (batch, d))
            _launch_bam_update(lib, stream, e, v, ef, mean_w, mean_w, f_w,
                               f_w, buf.f_prop, buf, regs[j], iters,
                               lmax_gate, gu_gate, rep, halt=halt,
                               multistep=1, stop_on_reject=sor)
        return mean_w, f_w, rep

    def step(regs, nmax, stop_on_reject, eps_block, mean, f, *params):
        mean_out, f_out, rep = packed(regs, nmax, stop_on_reject, eps_block,
                                      mean, f, *params)
        counts = rep[REP_NDONE:REP_STOPPED + 1].to(torch.int32)
        return (mean_out, f_out, counts[0], counts[1], counts[2],
                rep[REP_GU:REP_LMAX + 1])

    step.packed = packed
    return step


make_fused_bam_multistep.launches = 0


def bam_smallspace(e, v, vf, t, ef, mean, reg, iters=BAM_NS_ITERS_DEFAULT,
                   lmax_gate: float = LMAX_GATE_DEFAULT,
                   gu_gate: float = GU_GATE_DEFAULT):
    """K7/K8's small space alone: from the rows e, v, vf = v F, t = vf F^T
    and ef = e F^T (B, D), the mean (D,) and ``reg``, returns (stack_u,
    stack_w, vec, ss): the fat apply's (2 (B+1), D) rows, [gbar; mean +
    efbar] (2, D) and the ``SS_SIZE`` results the finalize reads (gu_ub,
    lmax_ub, res_ok, stiff, ta, tb).  On the card the cluster kernel
    (``bam_smallspace_cluster.cu``) for B <= ``BAM_SHARED_MAX_B``, the
    global-memory chain above; on the CPU
    ``bam_smallspace_stacks_reference``."""
    b, d = e.shape
    iters = tuple(int(i) for i in iters)
    if _on_cpu(e, v, vf, t, ef, mean):
        return bam_smallspace_stacks_reference(
            e, v, vf, t, ef, mean, reg, batch=b, iters=iters,
            lmax_gate=lmax_gate, gu_gate=gu_gate)
    _require_bam_shape(b, d)
    for name, x in (("e", e), ("v", v), ("vf", vf), ("t", t), ("ef", ef)):
        _require(name, x, (b, d))
    _require("mean", mean, (d,))
    buf = _BamBuffers(b, d, e.device)
    buf.vf, buf.t = vf, t
    _launch_bam_smallspace(_library(), _stream(e.device), e, v, ef, mean,
                           buf, reg, iters, lmax_gate, gu_gate)
    return buf.su, buf.sw, buf.vec, buf.ss[:SS_SIZE]


bam_smallspace.launches = 0

# Registered beside K1-K3, so ``fused_step.launch_counts()`` and
# ``reset_launch_counts()`` cover every kernel of the package.
KERNEL_WRAPPERS.update({
    "bam_eps_update_fused": bam_eps_update_fused,
    "make_fused_bam_multistep": make_fused_bam_multistep,
    "bam_smallspace_large": bam_smallspace_large,
    "bam_smallspace": bam_smallspace,
})
