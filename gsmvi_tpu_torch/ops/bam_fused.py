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
``bam_smallspace_panel``, its (kpad, kpad) matrices in row panels over a
cluster of ``PANEL_RANKS`` blocks, ``bam_smallspace_panel.cu``), the fat
apply (``apply_f32.cu`` on ``apply_tile(D)``'s output tiles, counted in
``bam_apply.launches``; its plain version ``bam_apply_reference``) into a
second buffer with per-tile sums of squares, the two mean matvecs on
F' (thin product), a one-block finalize (trace gate, keep, mean, report;
``bam_smallspace.cu``) and a grid select of F or F'.  A K8 call loops its
sub-steps on the host with the ``ef``/``x`` thin product and the score
before those; each launch reads the report's ``stopped`` word and does
nothing once the block has stopped.  Both return a float32 report of
``REP_SIZE`` values on the device (``REP_*`` indices), so a caller reads
every flag and statistic of a call in ONE device-to-host transfer
(``_bam_update_packed``, ``step.packed``).

K7 also takes a leading replica axis (``bam_eps_update_replicas``, the
route of ``FactorBaM.fit_batch``): the same eight launches update K
replicas, the thin products on their replica tiles, the small space's
cluster (or row panels) of each replica on blockIdx.y, the apply batched,
one finalize block and one select row of blocks per replica, with a (K,
REP_SIZE) report.  Each replica runs its own NS tier from a (K,
TIER_STRIDE) table on the card (``tier_table``, made once per combination
of tiers), and replica i computes, bit for bit, what K7 on it alone
computes.  Plain version: ``bam_eps_update_replicas_reference``.
Wrappers run the plain version on CPU tensors, launch on CUDA tensors, and
raise on what the kernels do not take; they never fall back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..state import NS_STATS_INIT
from .fused_step import (KERNEL_DIM_RANGE, KERNEL_WRAPPERS, SMEM_LIMIT_BYTES,
                         _library, _newton_inv, _ns_sqrt, _on_cpu, _ptr,
                         _require, _require_dim_supported, _spd_norm_ub,
                         _stream, _thin, apply_tile, cluster_columns,
                         ns_sqrt_both, panel_clusters, panel_smem_bytes)

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
# Floats a replica owns in the small space's results and in a tier table
# (BAM_SS_STRIDE and BAM_TIER_STRIDE of ops/cuda/csrc/bam_replica.cuh): a
# tier row is the five NS sweep counts, lmax_gate, gu_gate and a pad.
SS_STRIDE, TIER_STRIDE = 8, 8

# Shapes the CUDA kernels take.  The small space is padded to kpad = B + 8
# (the TPU kernel's padding, which the gates depend on).  The cluster kernel
# (``bam_smallspace_cluster.cu``) keeps, in each block's shared memory,
# twelve (kpad, kpad) float32 matrices at a padded leading dimension, three
# (kpad, 36) row slabs and the column sums' (3, 8, 32) partials; its chain
# products give each of 256 threads a T x T tile of a 16T x 16T grid, T <= 4,
# so kpad <= 64: B <= 56 (BAM_SHARED_MAX_B) at 227,456 of the 232,448 bytes
# a block may use on Hopper.  Above, up to B = 128 (the JAX kernel's own
# top, ``gsmvi_tpu/ops/pallas/bam_fused.py:345-352``), the small space keeps
# fourteen (kpad, kpad) matrices in row panels over a cluster of PANEL_RANKS
# blocks (``bam_smallspace_panel.cu``), at most 9 rows of each per block.
# The D range is that of the GSM kernels (``fused_step.KERNEL_DIM_RANGE``);
# D is masked at the tile edges.
_KPAD_MAX, _NMAT, _SLAB_LD, _COL_PARTS = 64, 12, 36, 3 * 8 * 32
_PANEL_NMAT, _PANEL_COL_PARTS = 14, 5 * 8 * 32


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


def bam_panel_smem_bytes(b: int) -> int:
    """Dynamic shared memory of the BaM panel small space at batch ``b``
    (``pb_smem_bytes`` in ``bam_smallspace_panel.cuh``)."""
    return panel_smem_bytes(b + 8, _PANEL_NMAT, _PANEL_COL_PARTS)


def bam_panel_tile(b: int) -> tuple:
    """(row groups of 8, column blocks of 128) of the BaM panel kernel's
    thread tile at batch ``b``: (1, 1) while kpad = b + 8 <= 128 (8 rows
    per block), else (2, 2) (``bam_smallspace_panel_t22.cu``)."""
    return (1, 1) if b + 8 <= 128 else (2, 2)
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


def _long_profile_tiers(k: int):
    """K replicas' tiers, all on the long profile."""
    return [(BAM_NS_ITERS_DEFAULT, GU_GATE_DEFAULT, LMAX_GATE_DEFAULT)] * k


def bam_eps_update_replicas_reference(eps, vs, mean, f, reg, tiers=None,
                                      ef=None):
    """The plain version of K7's replica axis: ``bam_eps_update_ns_reference``
    applied replica by replica to eps, vs, ef (K, B, D), mean (K, D) and f
    (K, D, D), replica i on its tier ``tiers[i]`` = (iters, gu_gate,
    lmax_gate) (default: the long profile for all).  Returns (mean (K, D),
    f (K, D, D), keep (K,), stiff (K,), ns_stats (K, 2))."""
    tiers = tiers or _long_profile_tiers(eps.shape[0])
    outs = [bam_eps_update_ns_reference(
        eps[i], vs[i], mean[i], f[i], reg, iters=tuple(int(x) for x in it),
        lmax_gate=float(lm), gu_gate=float(gg),
        ef=None if ef is None else ef[i])
        for i, (it, gg, lm) in enumerate(tiers)]
    return tuple(torch.stack(x) for x in zip(*outs))


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
    """Scratch of one BaM update on the card (of K replicas: a leading axis
    K), allocated once per call."""

    def __init__(self, b: int, d: int, device, with_f_prop: bool = False,
                 k=None):
        lead = () if k is None else (k,)
        empty = lambda *s: torch.empty((*lead, *s), dtype=torch.float32,
                                       device=device)
        k1 = b + 1
        self.vf, self.t = empty(b, d), empty(b, d)
        self.rows = empty(4 * k1, d)
        self.su, self.sw = empty(2 * k1, d), empty(2 * k1, d)
        self.vec = empty(2, d)
        self.ss = empty(SS_STRIDE)
        self.t1, self.sg = empty(1, d), empty(1, d)
        self.nparts = bam_apply_tiles(d)
        self.partial = empty(2 * self.nparts)
        self.f_prop = empty(d, d) if with_f_prop else None
        # The panel small space's mirrors of its panels.
        self.ws = (empty(_library().size("gsmvi_bam_panel_ws", b))
                   if b > BAM_SHARED_MAX_B else None)


def _launch_bam_smallspace(lib, stream, e, v, ef, mean_in, buf: _BamBuffers,
                           reg, iters, lmax_gate, gu_gate, halt=None,
                           tier=None) -> None:
    """The small space of one update (of K replicas), from ``buf.vf`` and
    ``buf.t``: the stacked rows ``buf.su``/``buf.sw``, ``buf.vec`` and
    ``buf.ss``.  By batch alone: up to ``BAM_SHARED_MAX_B`` on a cluster of
    ``cluster_columns(D)`` blocks per replica (counted in
    ``bam_smallspace.launches``), above on row panels over a cluster of
    ``PANEL_RANKS`` blocks per replica (``bam_smallspace_panel``).  With a
    tier table ``tier`` (K, TIER_STRIDE) on the device, replica i runs the
    sweeps and gates of its row instead of ``iters`` and the gates."""
    k = e.shape[0] if e.dim() == 3 else 1
    b, d = e.shape[-2:]
    args = (_ptr(e), _ptr(v), _ptr(buf.vf), _ptr(buf.t), _ptr(ef),
            _ptr(mean_in), _ptr(buf.rows), _ptr(buf.su), _ptr(buf.sw),
            _ptr(buf.vec), _ptr(buf.ss), _ptr(halt))
    scalars = (float(reg), *iters, float(lmax_gate), float(gu_gate), NS_TOL)
    if b <= BAM_SHARED_MAX_B:
        bam_smallspace.launches += 1
        lib.call("gsmvi_bam_smallspace_cluster", *args, b, d, *scalars,
                 *cluster_columns(d), bam_cluster_tile(b), _ptr(tier), k,
                 stream)
    else:
        bam_smallspace_panel(lib, stream, args, buf.ws, b, d, scalars,
                             tier=tier, k=k)


def _launch_bam_update(lib, stream, e, v, ef, mean_in, mean_out, f_in, f_dst,
                       f_prop, buf: _BamBuffers, reg, iters, lmax_gate,
                       gu_gate, rep, halt=None, multistep: int = 0,
                       stop_on_reject: int = 0, tier=None) -> None:
    """One update's launches: vf, t (thin product), small space, fat apply
    (F' into ``f_prop``), the two mean matvecs on F' (thin product),
    finalize (mean into ``mean_out``, report into ``rep``) and the select of
    F' or ``f_in`` into ``f_dst``.  With a leading replica axis K on every
    operand (packed; ``rep`` (K, REP_SIZE)) the same eight launches update
    the K replicas, replica i as a call on it alone would (``tier``: see
    ``_launch_bam_smallspace``)."""
    k = e.shape[0] if e.dim() == 3 else 1
    b, d = e.shape[-2:]
    _thin(lib, stream, v, f_in, buf.vf, trans=False, halt=halt)
    _thin(lib, stream, buf.vf, f_in, buf.t, trans=True, halt=halt)
    _launch_bam_smallspace(lib, stream, e, v, ef, mean_in, buf, reg, iters,
                           lmax_gate, gu_gate, halt=halt, tier=tier)
    _launch_bam_apply(lib, stream, buf.su, buf.sw, f_in, f_prop, buf.partial,
                      halt, k)
    _thin(lib, stream, buf.vec[..., :1, :], f_prop, buf.t1, trans=False,
          halt=halt)
    _thin(lib, stream, buf.t1, f_prop, buf.sg, trans=True, halt=halt)
    lib.call("gsmvi_bam_finalize", _ptr(buf.partial), buf.nparts,
             _ptr(buf.ss), _ptr(buf.sg), _ptr(buf.vec), _ptr(mean_in),
             _ptr(mean_out), _ptr(rep), multistep, stop_on_reject,
             float(reg), d, k, stream)
    lib.call("gsmvi_bam_select", _ptr(rep), _ptr(f_prop), _ptr(f_in),
             _ptr(f_dst), d * d, k, stream)


def _launch_bam_apply(lib, stream, su, sw, f_in, f_out, partial, halt,
                      reps: int) -> None:
    """BaM's fat apply: f_out = f_in + su^T sw and each output tile's
    (sum f_out^2, sum f_in^2) into ``partial`` (``bam_apply_tiles(D)``
    pairs a replica), one launch of ``apply_f32.cu`` on ``apply_tile(D)``
    for ``reps`` packed replicas, counted in ``bam_apply.launches``; a
    no-op while ``*halt`` is non-zero (one replica only)."""
    k2, d = su.shape[-2:]
    bam_apply.launches += 1
    lib.call("gsmvi_bam_apply", _ptr(su), _ptr(sw), _ptr(f_in), _ptr(f_out),
             _ptr(partial), _ptr(halt), k2, d, reps, *apply_tile(d), stream)


def bam_smallspace_panel(lib, stream, args, ws, b: int, d: int,
                         scalars, tier=None, k: int = 1) -> None:
    """Launch the row-panel BaM small space (``bam_smallspace_panel.cu``)
    that K7 and K8 run above ``BAM_SHARED_MAX_B``: one cluster of
    ``PANEL_RANKS`` blocks per replica (``k`` of them), ``args``
    ``gsmvi_bam_smallspace_cluster``'s pointers, ``ws`` the mirrors of its
    panels in device memory, ``scalars`` (reg, iters, gates, tol),
    ``tier`` the replicas' tier table or None.  Its placement is checked
    first (``panel_clusters``); ``launches`` counts the updates that took
    it, so a run shows which small space ran."""
    panel_clusters(lib, "bam", b)
    bam_smallspace_panel.launches += 1
    lib.call("gsmvi_bam_smallspace_panel", *args, _ptr(ws), b, d, *scalars,
             _ptr(tier), k, stream)


bam_smallspace_panel.launches = 0


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


# The replicas' tier tables on the card, by (device, tiers): made when a
# combination of tiers first runs and held (a fit's replicas change tier
# only at feedback-cadence boundaries and stiff steps); at most
# TIER_TABLES_MAX held, the oldest dropped first.
_TIER_TABLES = {}
TIER_TABLES_MAX = 64


def tier_table(tiers, device) -> torch.Tensor:
    """The (K, TIER_STRIDE) float32 tier table of ``tiers`` (K (iters,
    gu_gate, lmax_gate) triples) on ``device``: rows [iters..., lmax_gate,
    gu_gate, 0], read by the small spaces replica by replica."""
    key = (str(device), tuple((tuple(int(x) for x in it), float(gg),
                               float(lm)) for it, gg, lm in tiers))
    table = _TIER_TABLES.pop(key, None)
    if table is None:
        rows = [[*it, lm, gg, 0.0] for it, gg, lm in key[1]]
        table = torch.tensor(rows, dtype=torch.float32, device=device)
        if len(_TIER_TABLES) >= TIER_TABLES_MAX:
            _TIER_TABLES.pop(next(iter(_TIER_TABLES)))
    _TIER_TABLES[key] = table
    return table


def _bam_update_replicas_packed(eps, vs, mean, f, reg, tiers=None, ef=None):
    """K7 over stacked replicas as (mean (K, D), f (K, D, D), report (K,
    REP_SIZE)): eps, vs, ef (K, B, D), mean (K, D), f (K, D, D), one
    ``reg`` for all, replica i on its NS tier ``tiers[i]`` = (iters,
    gu_gate, lmax_gate) (default: the long profile for all).  On the card
    the eight launches of one K7 call cover the K replicas, replica i
    computing what K7 on it alone computes; the report of all K is read in
    one transfer."""
    k, b, d = eps.shape
    tiers = tiers or _long_profile_tiers(k)
    if len(tiers) != k:
        raise ValueError(f"expected {k} tiers, got {len(tiers)}")
    tensors = [eps, vs, mean, f] + ([ef] if ef is not None else [])
    if _on_cpu(*tensors):
        m, ff, keep, stiff, stats = bam_eps_update_replicas_reference(
            eps, vs, mean, f, reg, tiers, ef=ef)
        return m, ff, torch.stack([
            _plain_report(keep=keep[i], stiff=stiff[i], stats=stats[i],
                          n_done=1, n_acc=keep[i], apply=keep[i])
            for i in range(k)])
    _require_bam_shape(b, d)
    for name, t, shape in (("eps", eps, (k, b, d)), ("vs", vs, (k, b, d)),
                           ("mean", mean, (k, d)), ("f", f, (k, d, d))):
        _require(name, t, shape)
    dev = eps.device
    lib = _library()
    stream = _stream(dev)
    bam_eps_update_replicas.launches += 1
    if ef is None:
        ef = torch.empty_like(eps)
        _thin(lib, stream, eps, f, ef, trans=True)
    else:
        _require("ef", ef, (k, b, d))
    table = tier_table(tiers, dev)
    buf = _BamBuffers(b, d, dev, k=k)
    mean_out = torch.empty_like(mean)
    f_out = torch.empty_like(f)
    rep = torch.empty((k, REP_SIZE), dtype=torch.float32, device=dev)
    # The launch scalars' profile is the table's first row; the kernels
    # read every replica's own row.
    it0, gg0, lm0 = tiers[0]
    _launch_bam_update(lib, stream, eps, vs, ef, mean, mean_out, f, f_out,
                       f_out, buf, reg, tuple(int(x) for x in it0),
                       float(lm0), float(gg0), rep, tier=table)
    return mean_out, f_out, rep


def bam_eps_update_replicas(eps, vs, mean, f, reg, tiers=None, ef=None):
    """K7 with a replica axis: one update of K independent BaM fits.

    eps, vs (K, B, D); mean (K, D); f (K, D, D); ``reg`` a float shared by
    the replicas (a step of a pure schedule); ``tiers`` K (iters, gu_gate,
    lmax_gate) NS tiers, one per replica (default: the long profile);
    ``ef`` optional ``eps @ f^T``.  Returns (mean (K, D), f (K, D, D), keep
    (K,), stiff (K,), ns_stats (K, 2)); replica i's values are those of
    ``bam_eps_update_fused`` on replica i alone at its tier.  Plain
    version: ``bam_eps_update_replicas_reference``."""
    mean_out, f_out, rep = _bam_update_replicas_packed(eps, vs, mean, f, reg,
                                                       tiers, ef)
    return (mean_out, f_out, rep[:, REP_KEEP] != 0, rep[:, REP_STIFF] != 0,
            rep[:, REP_GU:REP_LMAX + 1])


bam_eps_update_replicas.launches = 0


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
    row-panel cluster kernel above; on the CPU
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


def bam_apply_tiles(d: int) -> int:
    """The output tiles of BaM's fat apply at dimension ``d`` (the plan
    ``apply_tile(d)``): the count of its (sum f'^2, sum f^2) partials a
    replica, ``nparts`` of the finalize."""
    bm, bn = apply_tile(d)
    return -(-d // bm) * -(-d // bn)


def _tile_sums_of_squares(x):
    """(..., bam_apply_tiles(D)): sum x^2 over each output tile of
    ``apply_tile(D)``, tiles row-major (t = y ceil(D / tile_n) + x)."""
    d = x.shape[-1]
    bm, bn = apply_tile(d)
    sq = torch.nn.functional.pad(x * x, (0, -d % bn, 0, -d % bm))
    lead = tuple(x.shape[:-2])
    sq = sq.reshape(*lead, -(-d // bm), bm, -(-d // bn), bn).sum((-3, -1))
    return sq.reshape(*lead, -1)


def bam_apply_reference(su, sw, f):
    """BaM's fat apply, plain: (f + su^T sw, partial) with su, sw (2(B+1),
    D) or (K, 2(B+1), D), f (D, D) or (K, D, D), and partial (...,
    bam_apply_tiles(D), 2) each output tile's (sum f'^2, sum f^2) in
    float32, which the trace gate sums (``jnp.sum(f_new * f_new)`` of
    ``gsmvi_tpu/ops/pallas/bam_fused.py:323`` and the F norm)."""
    f_new = f + su.transpose(-1, -2) @ sw
    return f_new, torch.stack([_tile_sums_of_squares(f_new),
                               _tile_sums_of_squares(f)], -1)


def bam_apply(su, sw, f):
    """K7/K8's fat apply alone, shapes and outputs as
    ``bam_apply_reference``.  On the card one launch of ``apply_f32.cu``
    (``gsmvi_bam_apply``) for all replicas, counted in
    ``bam_apply.launches``; on the CPU ``bam_apply_reference``."""
    if _on_cpu(su, sw, f):
        return bam_apply_reference(su, sw, f)
    k2, d = su.shape[-2:]
    lead = tuple(su.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"su: (2(B+1), D) or (K, 2(B+1), D) required, got "
                         f"{tuple(su.shape)}")
    _require_dim_supported(d)
    for name, t, shape in (("su", su, (k2, d)), ("sw", sw, (k2, d)),
                           ("f", f, (d, d))):
        _require(name, t, lead + shape)
    f_new = torch.empty_like(f)
    partial = torch.empty((*lead, bam_apply_tiles(d), 2), dtype=torch.float32,
                          device=f.device)
    _launch_bam_apply(_library(), _stream(f.device), su, sw, f, f_new,
                      partial, None, lead[0] if lead else 1)
    return f_new, partial


bam_apply.launches = 0

# Registered beside K1-K3, so ``fused_step.launch_counts()`` and
# ``reset_launch_counts()`` cover every kernel of the package.
KERNEL_WRAPPERS.update({
    "bam_eps_update_fused": bam_eps_update_fused,
    "bam_eps_update_replicas": bam_eps_update_replicas,
    "make_fused_bam_multistep": make_fused_bam_multistep,
    "bam_smallspace_panel": bam_smallspace_panel,
    "bam_smallspace": bam_smallspace,
    "bam_apply": bam_apply,
})
