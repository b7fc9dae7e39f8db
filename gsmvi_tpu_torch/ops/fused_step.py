"""The eps-coordinate GSM step: plain torch versions and the Hopper kernel
wrappers.

Counterpart of ``gsmvi_tpu/ops/pallas/fused_step.py``.  Its TPU kernels
are ported here:

- K1 ``gsm_eps_update_fused`` (``method="ns"``): the eps-coordinate update
  after the score — row work, the two-phase Newton-Schulz small space with
  its residual gates, one fat (D, 2B) @ (2B, D) factor apply, and the
  accept/revert select.  Plain version: ``gsm_eps_update_ns_reference``
  (twin of ``gsm_eps_update_ns_xla``) over ``eps_smallspace_ns_reference``
  (twin of ``_eps_smallspace_ns``).  ``method="chol"`` (K4a) is the exact
  variant: two (2B)^2 Choleskys, a triangular inverse and the min-pivot PD
  check.  Plain version: ``gsm_eps_update_chol_reference`` over
  ``eps_update_core_reference`` (twin of ``_eps_update_core``).
- K2 ``make_fused_eps_multistep``: up to ``steps_per_call`` whole steps
  (sampling product, score, K1's math, select) per call, a full block one
  CUDA graph replay on the card (``FusedBlocks``).  Plain version:
  ``eps_multistep_reference``.
- K3 ``gaussian_score``: v = (mu_t - x) @ prec.  Plain version:
  ``gaussian_score_reference``.
- K11a ``funnel_score``, ``banana_score`` (``zoo_score.cu``),
  ``student_t_score`` (``zoo_student_t.cu``, one cluster launch on the
  split-k thin product): the zoo targets' analytic scores.  Plain
  versions: ``*_score_reference``.
- K11b ``mixture_score`` (``zoo_score_b.cu``), ``logreg_score``
  (``zoo_logreg.cu``, one cluster launch): the Gaussian-mixture and
  logistic-regression scores.  Plain versions:
  ``mixture_score_reference``, ``logreg_score_reference``.
- K4 ``make_fused_eps_step``: one whole step per call, on the ns or the
  chol update, its draw passed in (``external_eps=True``) or made on the
  card by a Philox4x32-10 generator (``philox_normal``, in place of the
  TPU's hardware PRNG, whose stream cannot be reproduced).  Plain versions:
  ``eps_step_reference`` and ``philox_normal_reference``.

K1 also takes a leading replica axis K (eps, vs (K, B, D), mean (K, D), f
(K, D, D)): the batched step of ``FactorGSM.fit_batch`` (the JAX package's
``gsm_eps_update_ns_xla`` under vmap).  On the card each of its launches
covers all K replicas; replica i's result equals, bit for bit, a call on
replica i alone.  K3 takes any row count, e.g. K replicas' B rows stacked.

K1 (ns), K2, K4 (ns) and K6 take ``precision`` ("highest" | "high" |
"bf16"), the JAX package's ``big_prec``: it reaches only the O(B D^2)
products ``ef``, ``vf``, ``t`` and the fat apply; the (2B)^2 small space
and its gates stay float32.  The plain versions define it
(``mm_prec``): "bf16" rounds both operands to bfloat16 (round to nearest
even) and forms the products and sums in float32, the TPU's 1-pass
``Precision.DEFAULT``; "high" is bf16x3, a_hi b_hi + a_hi b_lo + a_lo b_hi
with a_hi = bf16(a), a_lo = bf16(a - a_hi), the TPU's 3-pass
``Precision.HIGH``.  On the card those products run on hand-written
``mma.sync`` bf16 tensor-core kernels (``thin_mma.cu``: one block per
``thin_mma_tile(D)`` output tile, its warps splitting k; ``apply_mma.cu``
on the float32 apply's tiles) with the float32 kernels' epilogues;
"highest" runs the float32 kernels unchanged.

Every wrapper runs its plain version on CPU tensors and launches its CUDA
kernels on CUDA tensors (``ops/cuda/csrc``), raising on a dtype, shape,
device or contiguity the kernels do not take; it never falls back.  Each
wrapper counts its calls on the card in a plain integer attribute
``launches`` (one per wrapper call, however many CUDA launches it makes).

On the card a K1 call is four launches on the current stream: ``vf = v F``
and ``t = vf F^T`` on the split-k thin product (``thin_product``,
``thin_gemm.cu``: one cluster of ``thin_split(D)`` blocks per output tile),
the small space on a thread-block cluster (``eps_smallspace``,
``eps_smallspace_cluster.cu``: ``cluster_columns(D)`` blocks per replica,
which writes ``good`` and the new mean), and the fat apply
(``factor_apply``, ``apply_f32.cu``: ``apply_tile(D)`` output tiles, the
k rows staged by cp.async while F is read), whose epilogue reads ``good``
and writes F or F' (the select).
Above ``SHARED_SMALLSPACE_MAX_B``, up to ``PANEL_SMALLSPACE_MAX_B``, the
small space is ``eps_smallspace_panel``, one cluster of ``PANEL_RANKS``
blocks per replica with the (B, B) matrices in row panels over the
cluster's shared memory (``eps_smallspace_panel.cu``); above that,
``eps_smallspace_large``, one persistent cooperative launch over the card
with them in device memory (``eps_smallspace_grid.cu``): the schedule of
``grid_schedule.py``, 71 phases at the long NS profile, a grid barrier
between two.  A K4a call is four: ``vf`` and ``t`` on the thin product,
one cluster launch of ``thin_split(D)`` blocks (``ops/cuda/csrc/
eps_chol.cu``: the row scalars, Z^T and (F Z)^T rows and the Gram over the
blocks' columns, the Cholesky small space in block 0, then S2 Z^T and the
mean over the columns again) and the fat apply.  A whole step
(``_launch_step``) is the ``ef = e F^T`` / ``x = mu + ef`` thin product,
the score, then one update's launches: a K4 call is one whole step; a K2
(K6) call runs its sub-steps on persistent buffers (``FusedBlocks``), in
place on a working (mean, F), with the accepted count accumulated on the
device, a full block as one CUDA graph replay.  No launch waits for the
host.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import math
import time

import torch

from ..config import resolve_device
from . import grid_schedule

# Newton-Schulz sweep counts (sqrt1, inv1, inv2, sqrt2, inv3) of the small
# space.  The short profile is the JAX package's validated frontier for
# B <= 32; at B >= 64 the Grams' spectra widen and the short chains go
# silently biased, so larger batches take the long profile
# (gsmvi_tpu/ops/pallas/fused_step.py:58-78).  CAUTION: the residual gates
# catch catastrophic loss, not slow bias — cutting iters[2] below 6 biases the
# converged covariance with zero rejections.
NS_ITERS_DEFAULT = (5, 4, 6, 7, 4)
NS_ITERS_LARGE_B = (8, 6, 9, 10, 6)
NS_TOL = 3e-3
# G-jitter of the exact (chol) variant, relative to tr(G)/2B + 1.
CHOL_JITTER = 1e-6

# Philox4x32-10 (Salmon et al., SC'11): round multipliers, Weyl key bumps,
# and the fixed second key word of the on-card draw (the first is the seed).
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_KEY1 = 0xA4093822
_M32 = 0xFFFFFFFF

# Shapes the CUDA kernels take.  The NS small space runs one cluster per
# replica, each block with its twelve (B, B) matrices in shared memory, up to
# SHARED_SMALLSPACE_MAX_B (``eps_smallspace_cluster.cu``); one cluster of
# PANEL_RANKS blocks per replica, block r holding rows [r R, (r+1) R) of every
# (B, B) matrix (R = ceil(B / PANEL_RANKS) <= 8), up to
# PANEL_SMALLSPACE_MAX_B (``eps_smallspace_panel.cu``); and above, one
# cooperative launch over the card with them in device memory
# (``eps_smallspace_grid.cu``) up to 512, the JAX package's largest fused
# batch (its B sweep's top, ``bench.py:551-590``).  The
# Cholesky variant (K4a) keeps three (2B, 2B) matrices in the shared memory
# of its cluster's first block (198 KiB at B=64), so it stops at 64.  D is masked at the tile
# edges and needs no alignment; its ceiling is K5's (``ops/gsm_step.py``).
KERNEL_BATCH_RANGE = (1, 512)
KERNEL_DIM_RANGE = (1, 8192)
SHARED_SMALLSPACE_MAX_B = 64
PANEL_SMALLSPACE_MAX_B = 128
# The grid small space's 16 x 16 tiles up to this batch, 32 x 32 above
# (``grid_tile``).
GRID_TILE16_MAX_B = 256
# The panel small spaces' cluster: 16 blocks (PN_RANKS in
# ``smallspace_panel.cuh``, fixed at compile time), a non-portable size (at
# 8, the portable one, both small spaces took a fifth to a third longer on
# an H100; PERF.md).  Never a function of D or K, so a K-replica launch runs
# each replica as a launch on it alone.
PANEL_RANKS = 16
PANEL_SLAB = 128
SMEM_LIMIT_BYTES = 232448            # a block's shared memory on Hopper
CHOL_BATCH_RANGE = (1, 64)
# The mixture score keeps each of its block's 8 warps' K partial logits
# and norms, each row's K responsibilities and logmask in shared memory:
# 100 KiB at K = 1024.
MIXTURE_COMPONENT_RANGE = (1, 1024)
# The logreg score takes 16 rows of w a cluster; its blocks run
# LOGREG_GROUPS k walks at once (walk g over the k slabs g mod 8) and keep
# resid in their cluster's shared memory while a block's bytes fit in
# LOGREG_SHARED_BYTES (``logreg_plan``: N up to 14,848), else in an L2
# scratch.  The Student-t and logreg scores hold their scratch from call to
# call up to ZOO_SCRATCH_MAX_BYTES together (``_held_scratch``).
LOGREG_ROWS = 16
LOGREG_GROUPS = 8
LOGREG_SHARED_BYTES = SMEM_LIMIT_BYTES
ZOO_SCRATCH_MAX_BYTES = 1 << 24
_ZOO_SCRATCH = {}
# The banana score's block (ZOO_THREADS in ``zoo_score.cu``).
BANANA_THREADS = 256
# Thread-block clusters of the small space and the thin product: at most 8
# blocks (the portable cluster size), each over a share of D in whole
# 32-column slabs.
CLUSTER_MAX_BLOCKS = 8
SLAB = 32


def cluster_columns(d: int) -> tuple:
    """(C, cols): the small space's cluster for dimension ``d``, C =
    min(8, ceil(d/32)) blocks, block r owning columns [r cols, (r+1) cols)
    with cols = ceil(d/C), so that no block is empty.  A function of D
    alone: a K-replica launch runs each replica as a launch on it alone."""
    c = min(CLUSTER_MAX_BLOCKS, -(-d // SLAB))
    return c, -(-d // c)


def thin_split(d: int) -> tuple:
    """(S, k_per): the thin product's split of the k range [0, d) over a
    cluster of S <= 8 blocks, block r taking [r k_per, (r+1) k_per) in
    whole slabs, none empty.  A function of D alone, so an output row's sum
    does not depend on the row count M or the replica count K."""
    slabs = -(-d // SLAB)
    per = -(-slabs // CLUSTER_MAX_BLOCKS)
    return -(-slabs // per), per * SLAB


# The fat apply's tile plans (``apply.cuh``), shared by its float32 kernel
# (``apply_f32.cu``) and its tensor-core twin (``apply_mma.cu``): the
# (rows, columns) of F a block, by D alone (``apply_tile``); 2B sets only
# how many passes the k staging makes.
APPLY_TILE_SMALL = (16, 32)
APPLY_TILE_LARGE = (64, 64)
APPLY_LARGE_D = 768


def apply_tile(d: int) -> tuple:
    """(tile_m, tile_n): the fat apply's output tile of F a block at
    dimension ``d``, 16 x 32 below APPLY_LARGE_D (128 blocks at D=256),
    64 x 64 from it on; the grid is (ceil(d/tile_n), ceil(d/tile_m), K).
    Not a function of 2B or K: replica z of a K-replica launch runs the
    tiles and k order of a launch on it alone."""
    return APPLY_TILE_LARGE if d >= APPLY_LARGE_D else APPLY_TILE_SMALL


# The tensor-core thin product's plans (``thin_mma.cu``): output tiles of
# (rows, columns) a block, by D alone (``thin_mma_tile``); each block's
# warps (8 on 16 x 16 tiles, 4 on 32 x 32) take 32-deep chunks of k in
# turn.
THIN_MMA_TILE_SMALL = (16, 16)
THIN_MMA_TILE_LARGE = (32, 32)
THIN_MMA_LARGE_D = 768


def thin_mma_tile(d: int) -> tuple:
    """(tile_m, tile_n): the tensor-core thin product's output tile at
    dimension ``d``, 16 x 16 below THIN_MMA_LARGE_D (32 blocks at M=32,
    D=256), 32 x 32 from it on; the grid is (ceil(d/tile_n), ceil(M/tile_m),
    K).  The plan fixes each output's k chunks and sum order, so they are a
    function of D alone, not of M or K."""
    return THIN_MMA_TILE_LARGE if d >= THIN_MMA_LARGE_D else THIN_MMA_TILE_SMALL


def panel_rows(n: int) -> int:
    """Rows per block of an (n, n) matrix split into row panels over a
    cluster of ``PANEL_RANKS`` blocks: block r owns [r R, min(n, (r+1) R))."""
    return -(-n // PANEL_RANKS)


def panel_smem_bytes(n: int, nmat: int, extra: int) -> int:
    """Dynamic shared memory of a panel small space on (n, n) matrices
    (``pn_smem_floats`` in ``smallspace_panel.cuh``): ``nmat`` (R, ld)
    panels, the staging matrix, a Gram's A slab, ``extra`` floats of the
    kernel's own, the exchange slots and the reduction scratch."""
    r4 = lambda x: -(-x // 4) * 4
    ld = r4(n) if r4(n) // 4 % 2 else r4(n) + 4    # pn_ld: ld / 4 odd
    rows = panel_rows(n)
    fb = ld * max(ld, PANEL_SLAB + 4)
    return 4 * (nmat * rows * ld + fb + rows * (PANEL_SLAB + 4) + r4(extra)
                + 8 + 32)


def eps_panel_smem_bytes(b: int) -> int:
    """``eps_smallspace_panel``'s shared memory at batch ``b``: eleven
    panels, and three scalars of each own row plus two of every row."""
    return panel_smem_bytes(b, 11, 3 * panel_rows(b) + 2 * b)


# The precisions of the O(B D^2) products (``mm_prec``), and the mode number
# of the tensor-core kernels' entry points for the two that run there.
PRECISIONS = ("highest", "high", "bf16")
MMA_MODE = {"bf16": 1, "high": 2}
# The name of each tensor-core precision in the kernels' counters.
MMA_TAG = {"bf16": "bf16", "high": "bf16x3"}


def check_precision(precision: str) -> str:
    """``precision`` when it is one of PRECISIONS (the kernels' and
    ``FactorGSM``'s ``pallas_precision``), else ValueError."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision (pallas_precision) must be one of "
                         f"{PRECISIONS}, got {precision!r}")
    return precision


def bf16_round(x):
    """``x`` rounded to bfloat16 (round to nearest even) and back to its
    dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm_prec(a, b, precision: str = "highest"):
    """``a @ b`` in ``precision``, the plain version of the kernels' O(B D^2)
    products: "highest" the float32 product; "bf16" both operands rounded
    to bfloat16, products and sums in float32; "high" bf16x3, a_hi b_hi +
    (a_hi b_lo + a_lo b_hi) with x_hi = bf16(x), x_lo = bf16(x - x_hi).
    A product of two bfloat16 values is exact in float32, so only the sums
    round."""
    if precision == "highest":
        return a @ b
    a_hi, b_hi = bf16_round(a), bf16_round(b)
    if precision == "bf16":
        return a_hi @ b_hi
    check_precision(precision)
    a_lo, b_lo = bf16_round(a - a_hi), bf16_round(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def ns_iters_for_batch(b: int, override=None) -> tuple:
    """The NS profile for batch ``b``: ``override`` when given, else the
    short profile for B <= 32 and the long one above."""
    if override is not None:
        return tuple(override)
    return NS_ITERS_DEFAULT if b <= 32 else NS_ITERS_LARGE_B


def kernel_supports(b: int, d: int, method: str = "ns") -> bool:
    """True iff the CUDA kernels of ``method`` take batch ``b`` and
    dimension ``d``."""
    lo, hi = CHOL_BATCH_RANGE if method == "chol" else KERNEL_BATCH_RANGE
    return lo <= b <= hi and KERNEL_DIM_RANGE[0] <= d <= KERNEL_DIM_RANGE[1]


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _spd_norm_ub(a):
    """Row-sum (infinity) norm: a sharp upper bound on lambda_max of SPD a."""
    return torch.max(torch.sum(torch.abs(a), dim=-1)) + 1e-30


def ns_sqrt_both(a, iters: int):
    """Coupled Newton-Schulz (matmul only): (sqrt(a), a^{-1/2}) for small
    SPD ``a``, the Y and Z iterates on ``a`` over its row-sum norm."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    nrm = _spd_norm_ub(a)
    y = a / nrm
    z = eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    rt = torch.sqrt(nrm)
    return y * rt, z / rt


def _ns_sqrt(a, iters: int):
    """Newton-Schulz SPD square root (matmul only)."""
    return ns_sqrt_both(a, iters)[0]


def _newton_inv(a, iters: int):
    """Newton-Hotelling inverse of SPD a, seeded with I / lambda_max bound."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    x = eye * (1.0 / _spd_norm_ub(a))
    for _ in range(iters):
        x = x @ (2.0 * eye - a @ x)
    return x


def eps_smallspace_ns_reference(e, v, vf, mu, f, *, batch: int,
                                tol: float = NS_TOL, iters=None, ef_t=None,
                                precision: str = "highest"):
    """Two-phase (PSD update, then PSD downdate) factorisation of
    M = I + (eps^T eps - C^T C)/B with matmul-only small solves.

    e, v, vf = v F, ef_t = e F^T (optional): (B, D); mu (1, D); f (D, D).
    Returns the proposals (mu_new (1, D), f_new (D, D), good): ``good`` is
    both phase residuals under ``tol`` (NS cannot converge on an indefinite
    downdate, so this is also the PD test).  Scalar functions of the Grams:
        cu = (I + S1)^{-1}, cui = (I + S1 + Gu)^{-1}, S1 = sqrt(I + Gu)
        cv = -(I + S2)^{-1},                          S2 = sqrt(I - Gv)
    and F' = F + stack_u^T stack_w in one (D, 2B) @ (2B, D) product.
    ``precision`` is that of ``ef``, ``t`` and the fat apply (``mm_prec``).
    """
    ef = mm_prec(e, f.T, precision) if ef_t is None else ef_t
    mu_new, stack_u, stack_w, good = eps_smallspace_stacks_reference(
        e, v, vf, mm_prec(vf, f.T, precision), ef, mu, batch=batch, tol=tol,
        iters=iters)
    return mu_new, f + mm_prec(stack_u.T, stack_w, precision), good


def eps_smallspace_stacks_reference(e, v, vf, t, ef, mu, *, batch: int,
                                    tol: float = NS_TOL, iters=None):
    """The small space alone (the plain version of ``eps_smallspace``): from
    the rows e, v, vf = v F, t = vf F^T and ef = e F^T (B, D) and mu (1, D),
    the proposed mean (1, D), stack_u and stack_w (2B, D) of the fat apply
    F' = F + stack_u^T stack_w, and ``good``."""
    b = batch
    iters = ns_iters_for_batch(b, iters)
    a = -ef                                                # rows mu - x
    vsv = torch.sum(v * t, dim=1, keepdim=True)
    mv = torch.sum(a * v, dim=1, keepdim=True)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(v * eps0, dim=1, keepdim=True)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)) * inv1r
    dmu = torch.sum(dmu_b, dim=0, keepdim=True) / b
    gamma = 1.0 - (1.0 + w / den) * inv1r
    c = -e * gamma + vf * inv1r                            # downdate rows
    scale2 = 1.0 / b
    eye_b = torch.eye(b, dtype=e.dtype, device=e.device)

    # Phase 1: W1 = I + Zu cu Zu^T factors I + Zu Zu^T, Zu = eps^T/sqrt(B).
    gu = (e @ e.T) * scale2
    gu = 0.5 * (gu + gu.T)
    s1 = _ns_sqrt(eye_b + gu, iters[0])
    s1 = 0.5 * (s1 + s1.T)
    res1 = torch.sum((s1 @ s1 - (eye_b + gu)) ** 2) \
        / (torch.sum((eye_b + gu) ** 2) + 1e-30)
    cu = _newton_inv(eye_b + s1, iters[1])
    cui = _newton_inv(eye_b + s1 + gu, iters[2])

    # Xi~ = W1^{-1} Zc, carried transposed on rows.
    ec = (e @ c.T) * scale2
    zc = 1.0 / b ** 0.5
    cuiec = cui @ ec
    xim_t = (c - cuiec.T @ e) * zc

    # Phase 2: downdate by Xi~ Xi~^T.
    gv = xim_t @ xim_t.T
    gv = 0.5 * (gv + gv.T)
    i_gv = eye_b - gv
    s2 = _ns_sqrt(i_gv, iters[3])
    s2 = 0.5 * (s2 + s2.T)
    res2 = torch.sum((s2 @ s2 - i_gv) ** 2) / (torch.sum(i_gv ** 2) + 1e-30)
    cv = -_newton_inv(eye_b + s2, iters[4])
    good = (res1 < tol) & (res2 < tol)

    # F' = F + U1 W1row + (Fw1 Xi~)(cv Xi~^T), all from row objects.
    u1row = a * (-zc)
    w1row = (cu @ e) * zc
    ximf_t = (-gamma * ef + inv1r * t - cuiec.T @ ef) * zc
    fw1xi_t = ximf_t + (xim_t @ w1row.T) @ u1row
    w2row = cv @ xim_t
    stack_u = torch.cat([u1row, fw1xi_t], dim=0)           # (2B, D)
    stack_w = torch.cat([w1row, w2row], dim=0)             # (2B, D)
    return mu + dmu, stack_u, stack_w, good


def gsm_eps_update_ns_reference(eps, vs, mean, f, iters=None, ef_t=None,
                                precision: str = "highest"):
    """Update + select with the NS small space: (mean, f, good), the old
    values kept where ``good`` is false.  Twin of ``gsm_eps_update_ns_xla``
    (``precision`` its ``big_prec``)."""
    b, d = eps.shape
    vf = mm_prec(vs, f, precision)
    mu_new, f_new, good = eps_smallspace_ns_reference(
        eps, vs, vf, mean.reshape(1, d), f, batch=b, iters=iters, ef_t=ef_t,
        precision=precision)
    return (torch.where(good, mu_new[0], mean), torch.where(good, f_new, f),
            good)


def _cholt_reference(w):
    """Twin of ``_cholt_inplace``: the transposed Cholesky factor L^T
    (upper) of the (k, k) SPD ``w`` by the right-looking sweep, and the
    minimum pivot.  A NaN pivot makes the minimum NaN (``torch.minimum``
    and ``torch.maximum`` propagate it, as ``jnp.minimum``/``jnp.maximum``
    do), so ``minpiv > 0`` rejects it."""
    k = w.shape[-1]
    cols = torch.arange(k, device=w.device)
    lt = torch.zeros_like(w)
    minpiv = torch.full((), float("inf"), dtype=w.dtype, device=w.device)
    for j in range(k):
        row = w[j]
        piv = row[j]
        minpiv = torch.minimum(minpiv, piv)
        inv = torch.rsqrt(torch.maximum(piv, piv.new_tensor(1e-30)))
        lrow = torch.where(cols >= j, row * inv, torch.zeros_like(row))
        lt[j] = lrow
        w = w - torch.outer(lrow, lrow)
    return lt, minpiv


def _triu_inv_reference(lt):
    """Twin of ``_triu_inv_inplace``: the inverse of the (k, k) upper
    triangle ``lt`` by backward substitution, row k-1 first."""
    k = lt.shape[-1]
    cols = torch.arange(k, device=lt.device)
    m = torch.zeros_like(lt)
    for j in range(k - 1, -1, -1):
        ltrow = lt[j]
        acc = ltrow @ m
        m[j] = ((cols == j).to(lt.dtype) - acc) / ltrow[j]
    return m


def eps_update_core_reference(e, v, mu, f, *, batch: int,
                              jitter: float = CHOL_JITTER, ef_t=None):
    """Twin of ``_eps_update_core``: the exact eps-coordinate update with
    the in-block (2B)^2 Choleskys.  e, v (B, D); mu (1, D); f (D, D);
    ``ef_t`` optional ``e @ f.T``.  Returns the proposals (mu_new (1, D),
    f_new (D, D), good): ``good`` is the minimum pivot of the Cholesky of
    K = I + Lg^T J Lg above 0, the exact PD test of the proposal.

    Unlike ``ops/gsm_eps.apply_eps_step`` it has no 2B >= D branch: G is
    always jittered and factored in the (2B)^2 space, as the TPU kernel
    does."""
    b = batch
    k2 = 2 * b
    ef = e @ f.T if ef_t is None else ef_t
    a = -ef                                                # rows mu - x
    vf = v @ f
    t = vf @ f.T
    vsv = torch.sum(v * t, dim=1, keepdim=True)
    mv = torch.sum(a * v, dim=1, keepdim=True)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(v * eps0, dim=1, keepdim=True)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)) * inv1r
    dmu = torch.sum(dmu_b, dim=0, keepdim=True) / b
    bm = a + dmu_b
    gamma = 1.0 - (1.0 + w / den) * inv1r
    c = -e * gamma + vf * inv1r
    scale = 1.0 / b ** 0.5
    zt = torch.cat([-e, c], dim=0) * scale                 # (2B, D)
    fzt = torch.cat([a, bm], dim=0) * scale                # (2B, D)

    # Small space: G -> Lg^T -> K -> Ck^T -> S2, factors kept transposed.
    g = zt @ zt.T
    g = 0.5 * (g + g.T)
    eye = torch.eye(k2, dtype=e.dtype, device=e.device)
    tr = torch.sum(g * eye)
    lgt, _ = _cholt_reference(g + (jitter * (tr / k2 + 1.0)) * eye)
    jj_row = torch.where(torch.arange(k2, device=e.device) < b, 1.0, -1.0
                         ).to(e.dtype)
    kmat = eye + (lgt * jj_row) @ lgt.T                    # I + Lg^T J Lg
    kmat = 0.5 * (kmat + kmat.T)
    m_mat = _triu_inv_reference(lgt)                       # Lg^{-T}
    ckt, minpiv = _cholt_reference(kmat)
    good = minpiv > 0.0
    # S2 = Lg^{-T} (Ck - I) Lg^{-1} = M (Ck^T - I)^T M^T
    s2 = (m_mat @ (ckt - eye).T) @ m_mat.T
    return mu + dmu, f + fzt.T @ (s2 @ zt), good


def gsm_eps_update_chol_reference(eps, vs, mean, f, jitter=CHOL_JITTER,
                                  ef_t=None):
    """Update + select with the Cholesky small space: (mean, f, good), the
    old values kept where ``good`` is false."""
    b, d = eps.shape
    mu_new, f_new, good = eps_update_core_reference(
        eps, vs, mean.reshape(1, d), f, batch=b, jitter=jitter, ef_t=ef_t)
    return (torch.where(good, mu_new[0], mean), torch.where(good, f_new, f),
            good)


def eps_step_reference(score_fn, params, e, mean, f, *, method: str = "ns",
                       iters=None, jitter: float = CHOL_JITTER,
                       precision: str = "highest"):
    """One whole step: ``ef = e F^T``, ``x = mu + ef``, ``v = score_fn(x,
    *params)``, the ns or chol update and the select.  Returns (mean, f,
    good).  ``precision`` (ns only) is that of ``ef``, ``vf``, ``t`` and
    the fat apply."""
    _check_method(method, precision)
    ef = mm_prec(e, f.T, precision)
    v = score_fn(mean + ef, *params)
    if method == "ns":
        d = f.shape[-1]
        mu_new, f_new, good = eps_smallspace_ns_reference(
            e, v, mm_prec(v, f, precision), mean.reshape(1, d), f,
            batch=e.shape[0], iters=iters, ef_t=ef, precision=precision)
        return (torch.where(good, mu_new[0], mean),
                torch.where(good, f_new, f), good)
    return gsm_eps_update_chol_reference(e, v, mean, f, jitter=jitter,
                                         ef_t=ef)


def eps_multistep_reference(score_fn, params, nmax: int, eps_block, mean, f,
                            *, batch: int, iters=None,
                            precision: str = "highest"):
    """The first ``nmax`` whole ns steps of an eps block
    (``eps_step_reference`` on each sub-step's rows).  Returns (mean, f,
    n_accepted int32)."""
    acc = torch.zeros((), dtype=torch.int32, device=f.device)
    for j in range(int(nmax)):
        mean, f, good = eps_step_reference(
            score_fn, params, eps_block[j * batch:(j + 1) * batch], mean, f,
            iters=iters, precision=precision)
        acc = acc + good.to(torch.int32)
    return mean, f, acc


def _mulhilo32(a, m: int):
    """(hi, lo) 32-bit words of a * m, for an int64 tensor ``a`` of uint32
    values and a 32-bit constant ``m``.  The product can reach 2^64 and
    overflow int64, so ``m`` enters as two 16-bit limbs."""
    p0 = a * (m & 0xFFFF)                                  # < 2^48
    p1 = a * (m >> 16)                                     # < 2^48
    s = p0 + ((p1 & 0xFFFF) << 16)                         # < 2^49
    return (s >> 32) + (p1 >> 16), s & _M32


def philox4x32_reference(counters, key0: int, key1: int, rounds: int = 10):
    """Philox4x32-``rounds`` of the (N, 4) int64 counter words (uint32
    values) under key (key0, key1): (N, 4) int64 output words.  Counter 0
    under key 0 gives 6627e8d5 e169c58d bc57ac4c 9b00dbd8 (Random123's
    known answer)."""
    c0, c1, c2, c3 = counters.unbind(-1)
    k0, k1 = int(key0) & _M32, int(key1) & _M32
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _M32, (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo32(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _philox_counters(n_blocks: int, device):
    """Counter block i = (i mod 2^32, i >> 32, 0, 0), as the kernel forms it."""
    i = torch.arange(n_blocks, dtype=torch.int64, device=device)
    z = torch.zeros_like(i)
    return torch.stack([i & _M32, i >> 32, z, z], dim=-1)


def _box_muller_reference(bits1, bits2):
    """Twin of ``_uniform_from_bits`` and ``_boxmuller``: uniforms from the
    top 24 bits (never 0), then the cos branch of Box-Muller, in float32."""
    u1, u2 = ((b >> 8).to(torch.float32) * (1.0 / (1 << 24))
              + (0.5 / (1 << 24)) for b in (bits1, bits2))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def philox_normal_reference(seed: int, batch: int, d: int, device=None):
    """The (batch, d) float32 standard-normal draw of seed ``seed``:
    counter block i gives the row-major normals 2i (from words 0, 1) and
    2i + 1 (from words 2, 3), key (seed mod 2^32, PHILOX_KEY1)."""
    n = batch * d
    w = philox4x32_reference(_philox_counters((n + 1) // 2, device),
                             seed, PHILOX_KEY1)
    z = torch.stack([_box_muller_reference(w[:, 0], w[:, 1]),
                     _box_muller_reference(w[:, 2], w[:, 3])], dim=-1)
    return z.reshape(-1)[:n].reshape(batch, d)


def gaussian_score_reference(x, mu_t, prec):
    """Dense-Gaussian score v = (mu_t - x) @ prec; mu_t (1, D)."""
    return (mu_t - x) @ prec


def funnel_score_reference(x, sigma_d):
    """Neal's funnel score (twin of ``funnel_score_kernel``), sigma_d =
    [[sigma, D]]: g0 = -x0/sigma^2 + e^{-x0} sum(rest^2)/2 - (D-1)/2,
    g_rest = -rest e^{-x0}."""
    sigma, dd = sigma_d[0, 0], sigma_d[0, 1]
    x0, rest = x[:, :1], x[:, 1:]
    rest2 = torch.sum(rest * rest, dim=1, keepdim=True)
    e = torch.exp(-x0)
    g0 = -x0 / (sigma * sigma) + 0.5 * e * rest2 - 0.5 * (dd - 1.0)
    return torch.cat([g0, -rest * e], dim=1)


def banana_score_reference(x, cs):
    """Banana score (twin of ``banana_score_kernel``), cs = [[b, s]]: with
    h = x1 - b (x0^2 - s^2), g0 = -x0/s^2 + 2 b x0 h, g1 = -h, g_tail =
    -tail."""
    curv, s = cs[0, 0], cs[0, 1]
    x0, x1 = x[:, :1], x[:, 1:2]
    h = x1 - curv * (x0 * x0 - s * s)
    g0 = -x0 / (s * s) + 2.0 * curv * x0 * h
    return torch.cat([g0, -h, -x[:, 2:]], dim=1)


def student_t_score_reference(x, loc, prec, df_d):
    """Multivariate-t score (twin of ``student_t_score_kernel``), loc
    (1, D), prec (D, D) symmetric, df_d = [[df, D]]:
    -(df + D)/(df + maha) P with P = (x - loc) prec, maha = rowsum(P o
    (x - loc))."""
    df, dd = df_d[0, 0], df_d[0, 1]
    diff = x - loc
    p = diff @ prec
    maha = torch.sum(p * diff, dim=1, keepdim=True)
    return -(df + dd) / (df + maha) * p


def mixture_score_reference(x, means, logmask):
    """Equal-weight identity-covariance mixture score (twin of
    ``mixture_score_kernel``), means (K, D), logmask (1, K) 0 for a
    component and -1e30 for padding: r = softmax_k(x . m_k - ||m_k||^2/2 +
    logmask_k), v = r M - x."""
    logits = x @ means.T
    logits = logits - 0.5 * torch.sum(means * means, dim=1)[None, :] + logmask
    m = torch.max(logits, dim=1, keepdim=True).values
    e = torch.exp(logits - m)
    r = e / torch.sum(e, dim=1, keepdim=True)
    return r @ means - x


def logreg_score_reference(w, xdata, y_row, inv_ps2):
    """Logistic-regression posterior score (twin of ``logreg_score_kernel``),
    xdata (N, D), y_row (1, N), inv_ps2 = [[1/ps^2]]: (y - sigmoid(w X^T))
    X - w / ps^2, the sigmoid as 1 / (1 + e^{-z}), which saturates to 0 or 1
    without NaN."""
    z = w @ xdata.T
    resid = y_row - 1.0 / (1.0 + torch.exp(-z))
    return resid @ xdata - w * inv_ps2[0, 0]


# ---------------------------------------------------------------------------
# CUDA launch helpers
# ---------------------------------------------------------------------------

def _library():
    from .cuda._build import load_library

    return load_library()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain path); False for CUDA tensors (kernel
    path); raises for anything else, or for a mix of devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"operands on {dev} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    return False


def _require_shape(name: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} required, got "
                         f"{tuple(t.shape)}")


def _require(name: str, t, shape) -> None:
    """The kernels take contiguous float32 CUDA tensors of exact shapes."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")
    _require_shape(name, t, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def _require_dim_supported(d: int) -> None:
    if not KERNEL_DIM_RANGE[0] <= d <= KERNEL_DIM_RANGE[1]:
        raise ValueError(
            f"CUDA kernels take D in [{KERNEL_DIM_RANGE[0]}, "
            f"{KERNEL_DIM_RANGE[1]}], got D={d}")


def _require_shape_supported(b: int, d: int, method: str = "ns") -> None:
    if not kernel_supports(b, d, method):
        lo, hi = CHOL_BATCH_RANGE if method == "chol" else KERNEL_BATCH_RANGE
        raise ValueError(
            f"CUDA kernels ({method}) take B in [{lo}, {hi}] and D in "
            f"[{KERNEL_DIM_RANGE[0]}, {KERNEL_DIM_RANGE[1]}], got B={b}, "
            f"D={d}")


def _replicas(rows):
    """(K, replica stride in elements) of a (M, D) or (K, M, D) row tensor
    whose replicas may lie apart (a view into a larger block) but whose own
    rows are packed."""
    if rows.dim() == 2:
        return 1, rows.numel()
    m, d = rows.shape[1:]
    if rows.stride()[1:] != (d, 1) and m > 1:
        raise ValueError("rows: each replica's (M, D) rows must be packed")
    return rows.shape[0], rows.stride(0)


def _thin(lib, stream, rows, f, out, *, trans: bool, mu=None, x_out=None,
          halt=None, precision: str = "highest") -> None:
    """out = rows @ F^T (``trans``) or rows @ F on the split-k thin product
    (``thin_gemm.cu``), counted in ``thin_product.launches``; with ``x_out``
    also x_out = mu + out; a no-op while ``*halt`` is non-zero.  A leading
    replica axis K on rows (any replica stride), f, mu, out and x_out
    (packed) runs all K in one launch.  "high"/"bf16" ``precision`` runs the
    tensor-core variant (``thin_mma.cu``, one block per ``thin_mma_tile(D)``
    output tile, no halt), counted in
    ``thin_product_bf16x3``/``thin_product_bf16``."""
    k, stride = _replicas(rows)
    m, d = rows.shape[-2:]
    if precision == "highest":
        thin_product.launches += 1
        lib.call("gsmvi_thin_rows", _ptr(rows), _ptr(f), _ptr(mu), _ptr(out),
                 _ptr(x_out), _ptr(halt), m, d, int(trans), k, stride,
                 *thin_split(d), stream)
        return
    if halt is not None:
        raise ValueError("the tensor-core thin product takes no halt word")
    THIN_MMA[precision].launches += 1
    lib.call("gsmvi_thin_rows_mma", _ptr(rows), _ptr(f), _ptr(mu), _ptr(out),
             _ptr(x_out), m, d, int(trans), k, stride, *thin_mma_tile(d),
             MMA_MODE[precision], stream)


def _apply(lib, stream, su, sw, f_in, f_out, good, *, precision: str,
           reps: int = 1) -> None:
    """The fat apply with its select: f_out = f_in + su^T sw where
    ``good[z]``, else f_in (in place when f_out is f_in), su, sw (2B, D), on
    ``apply_f32.cu`` (counted in ``factor_apply``) or, at "high"/"bf16", its
    tensor-core twin (``apply_mma.cu``, counted in
    ``factor_apply_bf16x3``/``factor_apply_bf16``), both on
    ``apply_tile(D)``; ``reps`` replicas stored one after another."""
    k, d = su.shape[-2:]
    args = (_ptr(su), _ptr(sw), _ptr(f_in), _ptr(f_out), _ptr(good), k, d,
            reps)
    if precision == "highest":
        factor_apply.launches += 1
        lib.call("gsmvi_factor_apply", *args, *apply_tile(d), stream)
        return
    APPLY_MMA[precision].launches += 1
    lib.call("gsmvi_factor_apply_mma", *args, MMA_MODE[precision],
             *apply_tile(d), stream)


class _UpdateBuffers:
    """Scratch of one update on the card (of K replicas: a leading axis K,
    ns only), allocated once per call.  ``su``/``sw`` are the fat apply's
    (2B, D) operands: stack_u/stack_w (ns), (F Z)^T and S2 Z^T (chol)."""

    def __init__(self, b: int, d: int, device, k=None, method: str = "ns"):
        lead = () if k is None else (k,)
        empty = lambda *s: torch.empty((*lead, *s), dtype=torch.float32,
                                       device=device)
        self.method = method
        self.vf, self.t = empty(b, d), empty(b, d)
        self.su, self.sw = empty(2 * b, d), empty(2 * b, d)
        if method == "ns":
            self.c, self.xim = empty(b, d), empty(b, d)
            # The panel small space's mirrors of its panels, or the grid
            # small space's (B, B) matrices and scalars and its sync words
            # (0 before its first launch, and after every launch).
            ws = (None if b <= SHARED_SMALLSPACE_MAX_B else "gsmvi_eps_panel_ws"
                  if b <= PANEL_SMALLSPACE_MAX_B else "gsmvi_eps_large_ws")
            self.ws = None if ws is None else empty(_library().size(ws, b))
            self.sync = None if b <= PANEL_SMALLSPACE_MAX_B else torch.zeros(
                (*lead, _library().size("gsmvi_eps_large_sync", b)),
                dtype=torch.int32, device=device)
        else:
            self.zt = empty(2 * b, d)
        self.good = torch.zeros(lead or (1,), dtype=torch.int32,
                                device=device)


def _launch_smallspace(lib, stream, eps, vs, ef, mean_in, mean_out,
                       buf: _UpdateBuffers, iters, nacc=None) -> None:
    """The small space of one update (of K replicas), from ``buf.vf`` and
    ``buf.t``: the new mean, ``good`` (and ``nacc``), and the stacked rows
    ``buf.su``/``buf.sw``.  By batch alone: up to ``SHARED_SMALLSPACE_MAX_B``
    on a cluster per replica (counted in ``eps_smallspace.launches``), up to
    ``PANEL_SMALLSPACE_MAX_B`` on row panels over a cluster per replica
    (``eps_smallspace_panel``), above in one cooperative launch over the
    card (``eps_smallspace_large``)."""
    k, e_stride = _replicas(eps)
    b, d = eps.shape[-2:]
    args = (_ptr(eps), _ptr(vs), _ptr(buf.vf), _ptr(buf.t), _ptr(ef),
            _ptr(mean_in), _ptr(mean_out), _ptr(buf.good), _ptr(nacc),
            _ptr(buf.su), _ptr(buf.sw), _ptr(buf.c), _ptr(buf.xim))
    if b <= SHARED_SMALLSPACE_MAX_B:
        eps_smallspace.launches += 1
        lib.call("gsmvi_eps_smallspace_cluster", *args, b, d, *iters, NS_TOL,
                 k, e_stride, *cluster_columns(d), stream)
    elif b <= PANEL_SMALLSPACE_MAX_B:
        eps_smallspace_panel(lib, stream, args, buf.ws, b, d, iters, k,
                             e_stride)
    else:
        eps_smallspace_large(lib, stream, args, buf, b, d, iters, k,
                             e_stride)


def _launch_update(lib, stream, eps, vs, ef, mean_in, mean_out, f_in, f_out,
                   buf: _UpdateBuffers, iters, nacc=None,
                   precision: str = "highest") -> None:
    """K1's launches: vf and t (thin product), small space (mean + good),
    fat apply (F), the products in ``precision``.  With a leading replica
    axis every launch covers the K replicas; eps may be a view whose
    replicas lie apart, the other operands are packed."""
    k, _ = _replicas(eps)
    _thin(lib, stream, vs, f_in, buf.vf, trans=False, precision=precision)
    _thin(lib, stream, buf.vf, f_in, buf.t, trans=True, precision=precision)
    _launch_smallspace(lib, stream, eps, vs, ef, mean_in, mean_out, buf,
                       iters, nacc=nacc)
    _apply(lib, stream, buf.su, buf.sw, f_in, f_out, buf.good,
           precision=precision, reps=k)


def _launch_chol_update(lib, stream, eps, vs, ef, mean_in, mean_out, f_in,
                        f_out, buf: _UpdateBuffers, jitter: float,
                        nacc=None) -> None:
    """K4a's launches: vf and t (thin product), then ``gsmvi_eps_chol``,
    one cluster launch over ``thin_split(D)`` (row scalars, Z^T and (F Z)^T
    rows, the Gram, the Cholesky small space, S2 Z^T, the mean and
    ``good``), and the fat apply."""
    b, d = eps.shape
    _thin(lib, stream, vs, f_in, buf.vf, trans=False)
    _thin(lib, stream, buf.vf, f_in, buf.t, trans=True)
    lib.call("gsmvi_eps_chol", _ptr(eps), _ptr(vs), _ptr(buf.vf),
             _ptr(buf.t), _ptr(ef), _ptr(mean_in), _ptr(mean_out),
             _ptr(buf.good), _ptr(nacc), _ptr(buf.zt), _ptr(buf.su),
             _ptr(buf.sw), b, d, *thin_split(d), float(jitter), stream)
    _apply(lib, stream, buf.su, buf.sw, f_in, f_out, buf.good,
           precision="highest")


def _launch_step(lib, stream, e, score_fn, params, mean_in, mean_out, f_in,
                 f_out, ef, x, buf: _UpdateBuffers, iters,
                 jitter: float = CHOL_JITTER, nacc=None,
                 precision: str = "highest") -> None:
    """One whole step on the card: ``ef = e F^T`` and ``x = mu + ef`` (one
    thin product), the score on x's rows, then one update's launches (``buf.method``)
    from (mean_in, f_in) into (mean_out, f_out), which may be the same
    tensors.  K4 makes one such step per call, K2 and K6 one per sub-step;
    a leading replica axis (K6) stacks the K replicas' rows for the score.
    ``precision`` (ns only) is that of the four O(B D^2) products."""
    d = e.shape[-1]
    _thin(lib, stream, e, f_in, ef, trans=True, mu=mean_in, x_out=x,
          precision=precision)
    rows = x.reshape(-1, d)
    v = score_fn(rows, *params)
    _require("score", v, tuple(rows.shape))
    v = v.reshape(ef.shape)
    if buf.method == "ns":
        _launch_update(lib, stream, e, v, ef, mean_in, mean_out, f_in, f_out,
                       buf, iters, nacc=nacc, precision=precision)
    else:
        _launch_chol_update(lib, stream, e, v, ef, mean_in, mean_out, f_in,
                            f_out, buf, jitter, nacc=nacc)


def grid_tile(b: int) -> int:
    """The output tile side of the grid small space at batch ``b``: 32
    (4 x 4 outputs a thread) where a product has enough 32 x 32 tiles to
    spread over the card, else 16.  A function of B alone, like every sum
    order of the kernel."""
    return 32 if b > GRID_TILE16_MAX_B else 16


def grid_blocks(lib, b: int) -> int:
    """Blocks of the grid small space at batch ``b`` that the card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs), its
    cooperative launch's grid; read once per batch.  Raises
    ``RuntimeError``, naming the shape, when it is 0 or the query fails,
    and when the first read is inside a CUDA graph capture (the query sets
    the kernel's shared-memory attribute, which a capture does not allow)."""
    key = ("grid", b)
    if key not in _PLACEMENT:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the grid small space at B={b}: its first launch (the "
                "occupancy query) is inside a CUDA graph capture")
        n = lib.size("gsmvi_eps_grid_blocks", grid_tile(b))
        if n <= 0:
            why = (f"CUDA error {-n}" if n < 0 else
                   "cudaOccupancyMaxActiveBlocksPerMultiprocessor reads 0")
            raise RuntimeError(
                f"the grid small space at B={b} (tile {grid_tile(b)}) "
                f"cannot be placed on this card ({why})")
        _PLACEMENT[key] = n
    return _PLACEMENT[key]


def grid_table(b: int, iters, device) -> tuple:
    """(the schedule table on ``device``, its phases) of the grid small
    space at batch ``b`` and NS profile ``iters`` (``grid_schedule``),
    made at first use and held; raises inside a CUDA graph capture, which
    cannot take the table's copy to the card."""
    key = (str(device), b, tuple(iters))
    if key not in _GRID_TABLES:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"the grid small space at B={b}: its first launch (the "
                "schedule's copy to the card) is inside a CUDA graph capture")
        phases = grid_schedule.grid_schedule(b, iters)
        table = torch.tensor(grid_schedule.encode(phases), dtype=torch.int32)
        _GRID_TABLES[key] = (table.to(device), len(phases))
    return _GRID_TABLES[key]


def eps_smallspace_large(lib, stream, args, buf, b: int, d: int, iters,
                         k: int, e_stride: int) -> None:
    """Launch the grid NS small space (``eps_smallspace_grid.cu``) that K1,
    K2, K4 and K6 run above ``PANEL_SMALLSPACE_MAX_B``: one cooperative
    launch of ``grid_blocks(b)`` persistent blocks per update (of all K
    replicas), which runs the schedule ``grid_table(b, iters)``; ``args``
    are ``gsmvi_eps_smallspace_cluster``'s pointers, ``buf`` holds its
    workspace and sync words.  A refused launch raises, naming the shape.
    Its ``launches`` counts the updates that took it, beside the wrappers'
    counts, so a run shows which small space ran."""
    blocks = grid_blocks(lib, b)
    table, nphases = grid_table(b, iters, buf.ws.device)
    eps_smallspace_large.launches += 1
    try:
        lib.call("gsmvi_eps_smallspace_large", *args, _ptr(buf.ws),
                 _ptr(buf.sync), _ptr(table), nphases, b, d, NS_TOL, k,
                 e_stride, grid_tile(b), blocks, stream)
    except RuntimeError as err:
        raise RuntimeError(
            f"the grid small space at B={b}, D={d}, K={k} ({blocks} blocks "
            f"of tile {grid_tile(b)}): {err}") from err


eps_smallspace_large.launches = 0

# Clusters of each panel small space the card holds at once, per (kind, B)
# (the shared bytes are a function of these), and the grid small space's
# blocks per B, read at first use; the grid small space's schedule tables.
_PLACEMENT = {}
_GRID_TABLES = {}


def panel_clusters(lib, kind: str, b: int) -> int:
    """How many clusters of the panel small space ``kind`` ("eps" or
    "bam") at batch ``b`` the card can hold at once
    (``cudaOccupancyMaxActiveClusters``), read once per shape.  Raises
    ``RuntimeError``, naming the shape, when it is 0 (or the query fails):
    a cluster launch that cannot be placed is refused, never waited on.
    The query also sets the kernel's launch attributes, which a stream
    capture does not allow, so a first launch inside one raises too."""
    key = (kind, b)
    if key not in _PLACEMENT:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the {kind} panel small space at B={b}: its first launch "
                "(the placement query) is inside a CUDA graph capture")
        n = lib.size(f"gsmvi_{kind}_panel_clusters", b)
        if n <= 0:
            why = (f"CUDA error {-n}" if n < 0 else
                   "cudaOccupancyMaxActiveClusters reads 0")
            raise RuntimeError(
                f"the {kind} panel small space at B={b} on a cluster of "
                f"{PANEL_RANKS} blocks cannot be placed on this card ({why})")
        _PLACEMENT[key] = n
    return _PLACEMENT[key]


def eps_smallspace_panel(lib, stream, args, ws, b: int, d: int, iters,
                         k: int, e_stride: int) -> None:
    """Launch the row-panel NS small space (``eps_smallspace_panel.cu``)
    that K1, K2, K4 and K6 run at ``SHARED_SMALLSPACE_MAX_B`` < B <=
    ``PANEL_SMALLSPACE_MAX_B``: one cluster of ``PANEL_RANKS`` blocks per
    replica, ``args`` ``gsmvi_eps_smallspace_cluster``'s pointers, ``ws``
    the mirrors of its panels in device memory, through which the blocks
    exchange them.  Its placement is checked first (``panel_clusters``);
    ``launches`` counts the updates that took it."""
    panel_clusters(lib, "eps", b)
    eps_smallspace_panel.launches += 1
    lib.call("gsmvi_eps_smallspace_panel", *args, _ptr(ws), b, d, *iters,
             NS_TOL, k, e_stride, stream)


eps_smallspace_panel.launches = 0


def _check_method(method: str, precision: str = "highest") -> None:
    if method not in ("ns", "chol"):
        raise ValueError(f"method must be 'ns' or 'chol', got {method!r}")
    check_precision(precision)
    if method == "chol" and precision != "highest":
        raise ValueError(
            f"precision={precision!r}: the exact (chol) variant runs its "
            "products in float32 only, as the JAX package's does")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def over_replicas(fn, *args):
    """``fn`` applied to each replica of the (K, ...) ``args`` in turn, its
    outputs stacked: the plain version of a kernel's replica axis."""
    outs = [fn(*replica_args) for replica_args in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


def gsm_eps_update_replicas_reference(eps, vs, mean, f, iters=None,
                                      ef_t=None, precision: str = "highest"):
    """``gsm_eps_update_ns_reference`` with an optional leading replica
    axis, one replica at a time: (mean (K, D), f (K, D, D), good (K,))."""
    one = lambda e, v, m, f_, ef: gsm_eps_update_ns_reference(
        e, v, m, f_, iters=iters, ef_t=ef, precision=precision)
    if eps.dim() == 2:
        return one(eps, vs, mean, f, ef_t)
    efs = [None] * eps.shape[0] if ef_t is None else ef_t
    return over_replicas(one, eps, vs, mean, f, efs)


def gsm_eps_update_fused(eps, vs, mean, f, iters=None, ef=None,
                         jitter: float = CHOL_JITTER, method: str = "ns",
                         precision: str = "highest"):
    """K1 (``method="ns"``) and K4a (``method="chol"``): eps-coordinate GSM
    update + validity + select.

    eps, vs (B, D); mean (D,); f (D, D); ``ef`` optional ``eps @ f.T`` (the
    sampling product the caller already formed).  Returns (mean, f, good)
    with the old values kept where ``good`` is false.

    - "ns": the Newton-Schulz small space with its residual gates;
      ``iters=None`` resolves through ``ns_iters_for_batch(B)``.  With a
      leading replica axis K on every operand it updates K independent
      fits: (mean (K, D), f (K, D, D), good (K,)).
    - "chol": the exact variant, two (2B)^2 Choleskys with ``jitter`` on
      the Gram and the min-pivot PD check; (B, D) only.

    ``precision`` (ns only): that of ``vf``, ``t``, the fat apply and, when
    ``ef`` is not given, ``ef`` (``mm_prec``; the module docstring).
    """
    _check_method(method, precision)
    b, d = eps.shape[-2:]
    lead = tuple(eps.shape[:-2])
    if len(lead) > (1 if method == "ns" else 0):
        shapes = "(B, D) or (K, B, D)" if method == "ns" else "(B, D)"
        raise ValueError(f"eps: {shapes} required for method={method!r}, "
                         f"got {tuple(eps.shape)}")
    iters = ns_iters_for_batch(b, iters)
    tensors = [eps, vs, mean, f] + ([ef] if ef is not None else [])
    if _on_cpu(*tensors):
        if method == "chol":
            return gsm_eps_update_chol_reference(eps, vs, mean, f,
                                                 jitter=jitter, ef_t=ef)
        return gsm_eps_update_replicas_reference(
            eps, vs, mean, f, iters=iters, ef_t=ef, precision=precision)
    _require_shape_supported(b, d, method)
    for name, t, shape in (("eps", eps, (b, d)), ("vs", vs, (b, d)),
                           ("mean", mean, (d,)), ("f", f, (d, d))):
        _require(name, t, lead + shape)
    lib = _library()
    stream = _stream(eps.device)
    gsm_eps_update_fused.launches += 1
    if ef is None:
        ef = torch.empty_like(eps)
        _thin(lib, stream, eps, f, ef, trans=True, precision=precision)
    else:
        _require("ef", ef, lead + (b, d))
    buf = _UpdateBuffers(b, d, eps.device, *lead, method=method)
    mean_out = torch.empty_like(mean)
    f_out = torch.empty_like(f)
    if method == "ns":
        _launch_update(lib, stream, eps, vs, ef, mean, mean_out, f, f_out,
                       buf, iters, precision=precision)
    else:
        _launch_chol_update(lib, stream, eps, vs, ef, mean, mean_out, f,
                            f_out, buf, jitter)
    good = buf.good != 0
    return mean_out, f_out, good if lead else good[0]


gsm_eps_update_fused.launches = 0


def philox4x32(n_blocks: int, key0: int, key1: int, device=None):
    """Philox4x32-10 words of counter blocks 0 .. n_blocks-1 under key
    (key0, key1): (n_blocks, 4) int64 (uint32 values).  The kernel on a
    CUDA ``device`` (default: the card; ``ops/cuda/csrc/prng.cu``), the
    plain version ``philox4x32_reference`` on the CPU."""
    device = resolve_device(device)
    if _on_cpu(torch.empty(0, device=device)):
        return philox4x32_reference(_philox_counters(n_blocks, device),
                                    key0, key1)
    words = torch.empty((n_blocks, 4), dtype=torch.int32, device=device)
    philox4x32.launches += 1
    _library().call("gsmvi_philox", _ptr(words), _ptr(None), n_blocks, 0,
                    int(key0) & _M32, int(key1) & _M32, _stream(device))
    return words.to(torch.int64) & _M32


philox4x32.launches = 0


def philox_normal(seed: int, batch: int, d: int, device=None):
    """The (batch, d) standard-normal draw of ``seed``: the kernel on a
    CUDA ``device`` (default: the card), ``philox_normal_reference`` on the
    CPU."""
    device = resolve_device(device)
    if _on_cpu(torch.empty(0, device=device)):
        return philox_normal_reference(seed, batch, d, device)
    out = torch.empty((batch, d), dtype=torch.float32, device=device)
    n = batch * d
    philox_normal.launches += 1
    _library().call("gsmvi_philox", _ptr(None), _ptr(out), (n + 1) // 2, n,
                    int(seed) & _M32, PHILOX_KEY1, _stream(device))
    return out


philox_normal.launches = 0


def make_fused_eps_step(score_fn, n_params: int, batch: int, d: int,
                        jitter: float = CHOL_JITTER,
                        external_eps: bool = False, method: str = "ns",
                        iters=None, precision: str = "highest"):
    """K4: one whole GSM step per call.

    Returns ``step(first, mean, f, *params) -> (mean, f, good)``: the draw
    (``external_eps=True``: ``first`` is the (B, D) draw itself;
    ``external_eps=False``: ``first`` is an integer seed, which must differ
    per step, and the draw is ``philox_normal(first, B, D)`` on the card),
    ``ef = e F^T``, ``x = mu + ef``, ``v = score_fn(x, *params)``, the
    ``method`` update ("ns": K1's Newton-Schulz small space with ``iters``;
    "chol": K4a's Choleskys with ``jitter``) and the select; ``precision``
    (ns only) that of its four O(B D^2) products.
    """
    _check_method(method, precision)
    iters = ns_iters_for_batch(batch, iters)

    def step(first, mean, f, *params):
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        operands = (first, mean, f) if external_eps else (mean, f)
        if _on_cpu(*operands):
            e = first if external_eps else philox_normal(first, batch, d,
                                                         mean.device)
            return eps_step_reference(score_fn, params, e, mean, f,
                                      method=method, iters=iters,
                                      jitter=jitter, precision=precision)
        _require_shape_supported(batch, d, method)
        for name, t, shape in (("mean", mean, (d,)), ("f", f, (d, d))):
            _require(name, t, shape)
        dev = mean.device
        if external_eps:
            _require("eps", first, (batch, d))
            e = first
        else:
            e = philox_normal(first, batch, d, dev)
        lib = _library()
        stream = _stream(dev)
        make_fused_eps_step.launches += 1
        buf = _UpdateBuffers(batch, d, dev, method=method)
        ef = torch.empty((batch, d), dtype=torch.float32, device=dev)
        x = torch.empty_like(ef)
        mean_out, f_out = torch.empty_like(mean), torch.empty_like(f)
        _launch_step(lib, stream, e, score_fn, params, mean, mean_out, f,
                     f_out, ef, x, buf, iters, jitter=jitter,
                     precision=precision)
        return mean_out, f_out, buf.good[0] != 0

    return step


make_fused_eps_step.launches = 0


# K2 and K6 keep their buffers from block to block and replay a full block
# (nmax == spc) as one CUDA graph, one graph per score configuration, at
# most this many per ``FusedBlocks`` (least recently used goes first).
GRAPH_CACHE_SIZE = 16


def _param_key(p):
    """A score param's part of a graph's key: where a tensor lies and its
    layout (new contents at the same address need no new graph); any other
    param by value."""
    if torch.is_tensor(p):
        return (p.data_ptr(), tuple(p.shape), tuple(p.stride()), p.dtype)
    return ("value", p)


def _score_name(score_fn) -> str:
    return getattr(score_fn, "__qualname__", None) or repr(score_fn)


class _BlockBuffers:
    """A block's buffers on one device (the card), kept from call to call:
    the eps block, the working (mean, F) that the sub-steps update in place,
    the accepted count, the sampling rows ``ef``/``x`` and one update's
    scratch; with a leading replica axis for K6."""

    def __init__(self, eps, batch: int, d: int, k):
        lead = () if k is None else (k,)
        device = eps.device
        empty = lambda *s: torch.empty((*lead, *s), dtype=torch.float32,
                                       device=device)
        self.eps = eps
        self.mean, self.f = empty(d), empty(d, d)
        self.acc = torch.zeros(lead or (1,), dtype=torch.int32, device=device)
        self.ef, self.x = empty(batch, d), empty(batch, d)
        self.buf = _UpdateBuffers(batch, d, device, k)


def _capture_graph(body):
    """(graph, seconds, pool bytes) of ``body()`` captured on a side stream
    into a new CUDA graph with its own memory pool; nothing runs.  A body
    that synchronises with the host, or any launch the toolkit will not
    capture, raises.  Python's cycle collector is held off during the
    capture: collecting an unreachable object that owns a CUDA graph or
    event (a fitter and its runner hold each other) destroys it, which the
    toolkit refuses while a capture is open, and the capture then fails
    with "operation failed due to a previous error during capture"."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph()
    enabled = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            body()
    finally:
        if enabled:
            gc.enable()
    return (graph, time.perf_counter() - t0,
            torch.cuda.memory_reserved() - reserved)


class FusedBlocks:
    """K2 (``k=None``) and K6 (``k`` replicas): ``spc`` whole GSM steps of
    one fit, or of K replica fits sharing the score params, per call.

    ``step(nmax, eps_block, mean, f, *params, graph=True) -> (mean, f,
    n_acc)`` advances the first ``nmax`` (<= spc) sub-steps of the eps
    block ((spc*B, D), or (K, spc*B, D): sub-step j's draw in rows [j*B,
    (j+1)*B)); mean (D,) or (K, D), f (D, D) or (K, D, D); ``n_acc`` int32,
    () or (K,).  CPU tensors run the plain version (``reference``).

    On the card the buffers (``_BlockBuffers``) persist from call to call.
    A caller writes its draws straight into ``eps_block(device)`` (the fit
    runner does; another block is copied in), and (mean, f) are copied into
    the working pair before the block, on the stream.  A full block (nmax
    == spc) replays one CUDA graph (``torch.cuda.CUDAGraph``) whose body is
    ``acc.zero_()`` and the spc sub-steps' launches (``_launch_step``): the
    card's counterpart of the TPU's one ``pallas_call`` per block.  A graph
    is keyed on the params' addresses and layouts (the block's shape, spc,
    K, iters and score are the object's own): the first full block of a
    key runs eagerly, which warms up the library and the kernels' one-time
    attributes and is that block's result, and then the graph is captured;
    later blocks of the key replay it.  The launch counters run no Python
    in a replay, so each capture records every counter's increase and each
    replay adds it: the counts equal the eager path's.  A block with nmax
    < spc (a chunk's end), and any block with ``graph=False``, runs the same
    launches eagerly on the same buffers; the two routes give the same
    numbers bit for bit.  The returned tensors are copies (two or three
    asynchronous copies per block), so a later block never writes a tensor
    a caller holds.  A score that cannot be captured (one that synchronises
    with the host) raises, naming the score; it never runs eagerly instead.
    """

    def __init__(self, score_fn, n_params: int, batch: int, d: int,
                 steps_per_call: int, iters, k, counter, reference,
                 precision: str = "highest"):
        self.score_fn, self.n_params = score_fn, n_params
        self.precision = check_precision(precision)
        self.batch, self.d, self.spc = batch, d, int(steps_per_call)
        self.iters, self.k = tuple(iters), k
        self._lead = () if k is None else (k,)
        self._counter = counter
        self._reference = reference
        self._eps = {}
        self._bufs = {}
        self._graphs = {}
        # One record per capture: {"seconds", "pool_bytes"}.
        self.captures = []

    def eps_block(self, device) -> torch.Tensor:
        """The persistent float32 eps block on ``device``, for the caller
        to write its draws into in place."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._eps:
            self._eps[device] = torch.empty(
                (*self._lead, self.spc * self.batch, self.d),
                dtype=torch.float32, device=device)
        return self._eps[device]

    def _buffers(self, device) -> _BlockBuffers:
        bufs = self._bufs.get(device)
        if bufs is None:
            bufs = _BlockBuffers(self.eps_block(device), self.batch, self.d,
                                 self.k)
            self._bufs[device] = bufs
        return bufs

    def __call__(self, nmax, eps_block, mean, f, *params, graph: bool = True):
        nmax = int(nmax)
        if not 0 <= nmax <= self.spc:
            raise ValueError(f"nmax={nmax} outside [0, {self.spc}]")
        if len(params) != self.n_params:
            raise ValueError(f"expected {self.n_params} score params, got "
                             f"{len(params)}")
        b, d, lead = self.batch, self.d, self._lead
        eps_block = eps_block.reshape(*lead, self.spc * b, d)
        if _on_cpu(eps_block, mean, f):
            return self._reference(params, nmax, eps_block, mean, f)
        _require_shape_supported(b, d)
        for name, t, shape in (("eps_block", eps_block, (self.spc * b, d)),
                               ("mean", mean, (d,)), ("f", f, (d, d))):
            _require(name, t, lead + shape)
        bufs = self._buffers(eps_block.device)
        if eps_block.data_ptr() != bufs.eps.data_ptr():
            bufs.eps.copy_(eps_block)
        bufs.mean.copy_(mean)
        bufs.f.copy_(f)
        self._counter.launches += 1 if nmax else 0
        if graph and nmax == self.spc:
            self._replay(bufs, params)
        else:
            self._body(bufs, nmax, params)
        acc = bufs.acc.clone()
        return bufs.mean.clone(), bufs.f.clone(), acc if lead else acc[0]

    def _body(self, bufs: _BlockBuffers, nmax: int, params) -> None:
        """The block's launches on the current stream: ``acc`` to 0, then
        ``nmax`` sub-steps on the working (mean, F)."""
        lib = _library()
        stream = _stream(bufs.eps.device)
        bufs.acc.zero_()
        for j in range(nmax):
            _launch_step(lib, stream,
                         bufs.eps[..., j * self.batch:(j + 1) * self.batch, :],
                         self.score_fn, params, bufs.mean, bufs.mean, bufs.f,
                         bufs.f, bufs.ef, bufs.x, bufs.buf, self.iters,
                         nacc=bufs.acc, precision=self.precision)

    def _replay(self, bufs: _BlockBuffers, params) -> None:
        key = (bufs.eps.device, tuple(_param_key(p) for p in params))
        hit = self._graphs.pop(key, None)
        if hit is None:
            self._body(bufs, self.spc, params)
            hit = self._capture(bufs, params)
            if len(self._graphs) >= GRAPH_CACHE_SIZE:
                self._graphs.pop(next(iter(self._graphs)))
            self._graphs[key] = hit
            return
        self._graphs[key] = hit          # most recently used last
        graph, deltas = hit
        graph.replay()
        for fn, n in deltas:
            fn.launches += n

    def _capture(self, bufs: _BlockBuffers, params) -> tuple:
        """(graph, each counter's increase per block) of a full block."""
        before = {fn: fn.launches for fn in KERNEL_WRAPPERS.values()}
        try:
            graph, seconds, pool = _capture_graph(
                lambda: self._body(bufs, self.spc, params))
        except Exception as err:
            raise RuntimeError(
                f"{self._counter.__name__}: the block with score "
                f"{_score_name(self.score_fn)} could not be captured into a "
                f"CUDA graph ({type(err).__name__}: {err}).  A fused score "
                "must be capturable: no host synchronisation (.item(), "
                "printing a CUDA tensor, torch.cuda.synchronize()).") from err
        finally:
            deltas = tuple((fn, fn.launches - n) for fn, n in before.items()
                           if fn.launches != n)
            for fn, n in before.items():
                fn.launches = n
        self.captures.append({"seconds": seconds, "pool_bytes": pool})
        return graph, deltas


def make_fused_eps_multistep(score_fn, n_params: int, batch: int, d: int,
                             steps_per_call: int, iters=None,
                             precision: str = "highest"):
    """K2: ``steps_per_call`` whole GSM steps per call.

    Returns a ``FusedBlocks``, ``step(nmax, eps_block, mean, f, *params)
    -> (mean, f, n_acc)``, advancing the first ``nmax`` (<= spc) sub-steps
    of the ``(spc*B, D)`` eps block; ``n_acc`` is an int32 tensor on the
    operands' device.  ``score_fn(x, *params) -> (B, D)`` is the score,
    e.g. the port's ``gaussian_score`` (the counterpart of tracing it into
    the TPU kernel); on the card it must be capturable into a CUDA graph.
    ``precision`` is that of each sub-step's four O(B D^2) products.
    """
    iters = ns_iters_for_batch(batch, iters)
    return FusedBlocks(
        score_fn, n_params, batch, d, steps_per_call, iters, None,
        make_fused_eps_multistep,
        lambda params, nmax, e, m, f: eps_multistep_reference(
            score_fn, params, nmax, e, m, f, batch=batch, iters=iters,
            precision=precision), precision=precision)


make_fused_eps_multistep.launches = 0


def gaussian_score(x, mu_t, prec):
    """K3: dense-Gaussian score v = (mu_t - x) @ prec; x (M, D), mu_t (1, D),
    prec (D, D) symmetric.  The split-k thin product (``thin_gemm.cu``, the
    prologue forms mu_t - x): any row count M >= 1 (the K replicas' B rows
    of a batched step, stacked), D in ``KERNEL_DIM_RANGE``; a row's score
    does not depend on M."""
    if _on_cpu(x, mu_t, prec):
        return gaussian_score_reference(x, mu_t, prec)
    b, d = x.shape
    _require_dim_supported(d)
    for name, t, shape in (("x", x, (b, d)), ("mu_t", mu_t, (1, d)),
                           ("prec", prec, (d, d))):
        _require(name, t, shape)
    v = torch.empty_like(x)
    gaussian_score.launches += 1
    _library().call("gsmvi_thin_score", _ptr(x), _ptr(mu_t), _ptr(prec),
                    _ptr(v), b, d, *thin_split(d), _stream(x.device))
    return v


gaussian_score.launches = 0


def thin_product(rows, f, *, trans: bool, mu=None,
                 precision: str = "highest"):
    """The row products of K1, K2, K4 and K6: rows @ F^T (``trans``) or
    rows @ F, rows (M, D) or (K, M, D), F (D, D) or (K, D, D); with ``mu``
    ((D,) or (K, D); ``trans`` only) it returns (out, x = mu + out).  On the
    card the split-k thin product (``thin_gemm.cu``; at "high"/"bf16"
    ``precision`` its tensor-core variant ``thin_mma.cu``), one launch for
    all replicas; on the CPU the plain products (``mm_prec``)."""
    check_precision(precision)
    if mu is not None and not trans:
        raise ValueError("thin_product: mu (x = mu + out) needs trans=True")
    if _on_cpu(rows, f, *([] if mu is None else [mu])):
        out = mm_prec(rows, f.transpose(-1, -2) if trans else f, precision)
        return out if mu is None else (out, mu.unsqueeze(-2) + out)
    m, d = rows.shape[-2:]
    lead = tuple(rows.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"rows: (M, D) or (K, M, D) required, got "
                         f"{tuple(rows.shape)}")
    _require_dim_supported(d)
    _require("rows", rows, lead + (m, d))
    _require("f", f, lead + (d, d))
    out = torch.empty_like(rows)
    x = None
    if mu is not None:
        _require("mu", mu, lead + (d,))
        x = torch.empty_like(rows)
    _thin(_library(), _stream(rows.device), rows, f, out, trans=trans, mu=mu,
          x_out=x, precision=precision)
    return out if mu is None else (out, x)


thin_product.launches = 0


def factor_apply_reference(su, sw, f, good=None, precision: str = "highest"):
    """The fat apply's plain version: f + su^T sw (``mm_prec``) where
    ``good`` (default: everywhere), else f; su, sw (2B, D) or (K, 2B, D),
    f (D, D) or (K, D, D), good () or (K,), bool or int32 (0 rejects)."""
    f_new = f + mm_prec(su.transpose(-1, -2), sw, precision)
    if good is None:
        return f_new
    keep = good.reshape(f.shape[:-2] + (1, 1)) != 0
    return torch.where(keep, f_new, f)


def factor_apply(su, sw, f, good=None, *, precision: str = "highest"):
    """The fat apply of K1, K2, K4 and K6 with its select: f + su^T sw
    where ``good`` (default: everywhere), else f, at ``precision``; shapes
    as ``factor_apply_reference``.  On the card one launch for all
    replicas: "highest" on ``apply_f32.cu`` (float32 FFMA, counted in
    ``factor_apply.launches``), "high"/"bf16" on the ``mma.sync`` bf16 kernel
    ``apply_mma.cu`` (counted in ``factor_apply_bf16x3``/
    ``factor_apply_bf16``); on the CPU ``factor_apply_reference``."""
    check_precision(precision)
    tensors = [su, sw, f] + ([] if good is None else [good])
    if _on_cpu(*tensors):
        return factor_apply_reference(su, sw, f, good, precision)
    n, d = su.shape[-2:]
    lead = tuple(su.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"su: (2B, D) or (K, 2B, D) required, got "
                         f"{tuple(su.shape)}")
    _require_dim_supported(d)
    for name, t, shape in (("su", su, (n, d)), ("sw", sw, (n, d)),
                           ("f", f, (d, d))):
        _require(name, t, lead + shape)
    k = lead[0] if lead else 1
    if good is None:
        flags = torch.ones(k, dtype=torch.int32, device=f.device)
    elif good.dtype == torch.int32 and good.is_contiguous():
        flags = good.reshape(k)        # the kernel's own flag: no conversion
    else:
        flags = good.reshape(k).to(torch.int32).contiguous()
    out = torch.empty_like(f)
    _apply(_library(), _stream(f.device), su, sw, f, out, flags,
           precision=precision, reps=k)
    return out


factor_apply.launches = 0


def _mma_counter(fn, precision: str):
    """``fn`` at ``precision``: the wrapper of one tensor-core variant,
    whose ``launches`` counts that variant's launches wherever they run."""
    variant = functools.partial(fn, precision=precision)
    variant.__name__ = f"{fn.__name__}_{MMA_TAG[precision]}"
    variant.launches = 0
    return variant


# The tensor-core variants' wrappers and launch counts, by precision.
THIN_MMA = {p: _mma_counter(thin_product, p) for p in MMA_MODE}
APPLY_MMA = {p: _mma_counter(factor_apply, p) for p in MMA_MODE}


def eps_smallspace(e, v, vf, t, ef, mean, iters=None):
    """K1's small space alone: from the rows e, v, vf = v F, t = vf F^T and
    ef = e F^T ((B, D), or (K, B, D) for K replicas) and the mean ((D,) or
    (K, D)), returns (mean_out, stack_u, stack_w, good): the mean with its
    select, the fat apply's (2B, D) operands and the gates' verdict.  On the
    card the cluster kernel (``eps_smallspace_cluster.cu``) for B <=
    ``SHARED_SMALLSPACE_MAX_B``, the row-panel cluster kernel up to
    ``PANEL_SMALLSPACE_MAX_B``, the grid kernel above (one cooperative
    launch); on the CPU ``eps_smallspace_stacks_reference``."""
    b, d = e.shape[-2:]
    lead = tuple(e.shape[:-2])
    iters = ns_iters_for_batch(b, iters)
    if _on_cpu(e, v, vf, t, ef, mean):
        one = lambda e_, v_, vf_, t_, ef_, m_: _select_stacks(
            *eps_smallspace_stacks_reference(e_, v_, vf_, t_, ef_,
                                             m_.reshape(1, d), batch=b,
                                             iters=iters), m_)
        if not lead:
            return one(e, v, vf, t, ef, mean)
        return over_replicas(one, e, v, vf, t, ef, mean)
    if len(lead) > 1:
        raise ValueError(f"e: (B, D) or (K, B, D) required, got "
                         f"{tuple(e.shape)}")
    _require_shape_supported(b, d)
    for name, x in (("e", e), ("v", v), ("vf", vf), ("t", t), ("ef", ef)):
        _require(name, x, lead + (b, d))
    _require("mean", mean, lead + (d,))
    buf = _UpdateBuffers(b, d, e.device, *lead)
    buf.vf, buf.t = vf, t
    mean_out = torch.empty_like(mean)
    _launch_smallspace(_library(), _stream(e.device), e, v, ef, mean,
                       mean_out, buf, iters)
    good = buf.good != 0
    return mean_out, buf.su, buf.sw, good if lead else good[0]


eps_smallspace.launches = 0


def _select_stacks(mu_new, stack_u, stack_w, good, mean):
    """``eps_smallspace``'s plain outputs: the mean selected by ``good``."""
    return torch.where(good, mu_new[0], mean), stack_u, stack_w, good


def _held_scratch(key, make) -> tuple:
    """The device scratch of a zoo score call, ``key`` its score, device and
    shape: the tensors of ``make()``, made at the key's first call outside
    a CUDA graph capture and then held for the life of the process while
    the held scratch fits in ``ZOO_SCRATCH_MAX_BYTES`` together.  A held
    scratch is never freed, since a captured launch keeps its addresses;
    the fit paths run a block eagerly before they capture it, so their
    graphs find it held.  Made inside a capture, or past the cap, it is the
    call's own (its ticket zeroed by the capture or the call).  Calls reuse
    a held scratch in the order the device runs them: the port issues every
    launch on the current stream, and two score calls of one key must not
    run at once on two streams."""
    buf = _ZOO_SCRATCH.get(key)
    if buf is not None:
        return buf
    buf = make()
    nbytes = sum(t.numel() * t.element_size() for t in buf)
    held = sum(t.numel() * t.element_size()
               for b in _ZOO_SCRATCH.values() for t in b)
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    if held + nbytes <= ZOO_SCRATCH_MAX_BYTES and not capturing:
        _ZOO_SCRATCH[key] = buf
    return buf


def _zoo_operands(x, params, shape=(1, 2)) -> tuple:
    """(M, D) of the score rows x, after checking x and the scalar row of a
    zoo score's ``params`` (its last; (1, 2) unless ``shape`` says)."""
    if x.dim() != 2:
        raise ValueError(f"x: (M, D) required, got {tuple(x.shape)}")
    m, d = x.shape
    _require_dim_supported(d)
    _require("x", x, (m, d))
    _require("params", params, shape)
    return m, d


def _two_matrices(name: str, x, a) -> None:
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"{name}: two matrices required, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")


def funnel_score(x, sigma_d):
    """K11a: Neal's funnel score of the rows x (M, D), sigma_d = [[sigma,
    D]].  One launch (``ops/cuda/csrc/zoo_score.cu``): a row over the S
    warps of ``thin_split(D)`` in one block, warp r over its k_per columns,
    the row's parts of rest^2 added in warp order.  Any M >= 1, D in
    ``KERNEL_DIM_RANGE``; a row's score does not depend on M."""
    if _on_cpu(x, sigma_d):
        return funnel_score_reference(x, sigma_d)
    m, d = _zoo_operands(x, sigma_d)
    v = torch.empty_like(x)
    funnel_score.launches += 1
    _library().call("gsmvi_funnel_score", _ptr(x), _ptr(sigma_d), _ptr(v),
                    m, d, *thin_split(d), _stream(x.device))
    return v


funnel_score.launches = 0


def banana_plan(m: int, d: int) -> tuple:
    """(shift, blocks) of the banana kernel on (M, D) rows: 2^shift threads
    a row, the least power of two that covers the row's ceil(D/4) 4-column
    chunks, at most ``BANANA_THREADS`` (then each thread walks every
    2^shift-th chunk), and ``BANANA_THREADS >> shift`` rows a block."""
    chunks = -(-d // 4)
    shift = min(BANANA_THREADS.bit_length() - 1, (chunks - 1).bit_length())
    return shift, -(-m // (BANANA_THREADS >> shift))


def banana_score(x, cs):
    """K11a: banana score of the rows x (M, D), D >= 2, cs = [[curvature,
    scale]].  One launch (``ops/cuda/csrc/zoo_score.cu``) on the rows of
    ``banana_plan``: 4 columns a thread, float4 where D % 4 == 0, x0 and x1
    read once by the thread of their chunk."""
    if x.dim() != 2 or x.shape[1] < 2:
        raise ValueError(f"banana_score: x (M, D) with D >= 2 required, got "
                         f"{tuple(x.shape)}")
    if _on_cpu(x, cs):
        return banana_score_reference(x, cs)
    m, d = _zoo_operands(x, cs)
    v = torch.empty_like(x)
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    banana_score.launches += 1
    _library().call("gsmvi_banana_score", _ptr(x), _ptr(cs), _ptr(v), m, d,
                    banana_plan(m, d)[0], int(vec), _stream(x.device))
    return v


banana_score.launches = 0


def student_t_score(x, loc, prec, df_d):
    """K11a: multivariate-t score of the rows x (M, D); loc (1, D), prec
    (D, D) symmetric, df_d = [[df, D]].  One cluster launch
    (``ops/cuda/csrc/zoo_student_t.cu``): the product (x - loc) prec on
    K3's split-k partition, each tile's part of maha in its epilogue, and
    the row scale in the last of the blocks that write those rows, found
    by a ticket per (32-row block, rank); the scratch (maha's tile
    partials and the tickets) is held (``_held_scratch``).  Any row count
    M >= 1, D in ``KERNEL_DIM_RANGE``; a row's score does not depend on
    M."""
    if _on_cpu(x, loc, prec, df_d):
        return student_t_score_reference(x, loc, prec, df_d)
    m, d = _zoo_operands(x, df_d)
    _require("loc", loc, (1, d))
    _require("prec", prec, (d, d))
    split = thin_split(d)
    partial, ticket = _held_scratch(
        ("student_t", x.device, m, d),
        lambda: (torch.empty((-(-d // SLAB), m), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((-(-m // SLAB), split[0]), dtype=torch.int32,
                             device=x.device)))
    v = torch.empty_like(x)
    student_t_score.launches += 1
    _library().call("gsmvi_student_t_score", _ptr(x), _ptr(loc), _ptr(prec),
                    _ptr(df_d), _ptr(v), _ptr(partial), _ptr(ticket), m, d,
                    *split, _stream(x.device))
    return v


student_t_score.launches = 0


def mixture_score(x, means, logmask):
    """K11b: the equal-weight identity-covariance mixture's score of the
    rows x (M, D); means (K, D), logmask (1, K) 0 for a component and -1e30
    for padding (the JAX target's K padded to 8 is taken as it is).  One
    launch (``ops/cuda/csrc/zoo_score_b.cu``): a row over the S warps of
    ``thin_split(D)`` in one block, warp r reading its k_per columns of x
    and M once, the partial logits and norms added in warp order.  Any M
    >= 1, D in ``KERNEL_DIM_RANGE``, K in ``MIXTURE_COMPONENT_RANGE``; a
    row's score does not depend on M."""
    _two_matrices("mixture_score", x, means)
    (m, d), k = x.shape, means.shape[0]
    _require_shape("means", means, (k, d))
    _require_shape("logmask", logmask, (1, k))
    if _on_cpu(x, means, logmask):
        return mixture_score_reference(x, means, logmask)
    lo, hi = MIXTURE_COMPONENT_RANGE
    if not lo <= k <= hi:
        raise ValueError(f"mixture_score: the CUDA kernel takes K in [{lo}, "
                         f"{hi}] components, got K={k}")
    _zoo_operands(x, logmask, logmask.shape)
    _require("means", means, (k, d))
    v = torch.empty_like(x)
    mixture_score.launches += 1
    _library().call("gsmvi_mixture_score", _ptr(x), _ptr(means),
                    _ptr(logmask), _ptr(v), m, d, k, *thin_split(d),
                    _stream(x.device))
    return v


mixture_score.launches = 0


def logreg_plan(n: int, d: int) -> tuple:
    """(S, T, shared): the logreg launch's cluster of S = min(8,
    max(ceil(N/32), ceil(D/32))) blocks per 16 rows of w, each rank holding
    T = ceil(ceil(N/32)/S) of resid's 32-column tiles, in its shared memory
    (``shared``, while a block's bytes fit in ``LOGREG_SHARED_BYTES``) or in
    an L2 scratch.  No sum is split over the ranks (each output sums its
    ``LOGREG_GROUPS`` chains, chain g over the k slabs g mod 8), so the
    result depends on neither S nor the route."""
    ntn, ntd = -(-n // SLAB), -(-d // SLAB)
    s = min(CLUSTER_MAX_BLOCKS, max(ntn, ntd))
    t = -(-ntn // s)
    return s, t, logreg_smem_bytes(t) <= LOGREG_SHARED_BYTES


def logreg_smem_bytes(t: int) -> int:
    """A logreg block's shared memory with resid in it: each of its
    ``LOGREG_GROUPS`` walks' two staged slabs (A 16 x 36 floats, B 32 x 36,
    and 32 prologue floats) and its rank's T resid tiles, 16 rows of 32 T +
    4 floats."""
    slab = (LOGREG_ROWS + SLAB) * (SLAB + 4) + SLAB
    return 4 * (LOGREG_GROUPS * 2 * slab + LOGREG_ROWS * (t * SLAB + 4))


def logreg_score(w, xdata, y_row, inv_ps2):
    """K11b: the logistic-regression posterior's score of the weight rows w
    (M, D); xdata (N, D), y_row (1, N), inv_ps2 = [[1/ps^2]], all on the
    device.  One cluster launch per call (``ops/cuda/csrc/zoo_logreg.cu``,
    ``logreg_plan``): z = w X^T with resid = y - sigmoid(z) in its
    epilogue, kept in the cluster's shared memory, then resid X - w/ps^2;
    where resid does not fit there, in a held L2 scratch
    (``_held_scratch``).  Any M >= 1 and N >= 1, D in
    ``KERNEL_DIM_RANGE``; a row's score does not depend on M."""
    _two_matrices("logreg_score", w, xdata)
    (m, d), n = w.shape, xdata.shape[0]
    _require_shape("xdata", xdata, (n, d))
    _require_shape("y_row", y_row, (1, n))
    _require_shape("inv_ps2", inv_ps2, (1, 1))
    if _on_cpu(w, xdata, y_row, inv_ps2):
        return logreg_score_reference(w, xdata, y_row, inv_ps2)
    if n < 1:
        raise ValueError("logreg_score: the CUDA kernel takes N >= 1 rows of "
                         "data")
    _zoo_operands(w, inv_ps2, inv_ps2.shape)
    _require("xdata", xdata, (n, d))
    _require("y_row", y_row, (1, n))
    split, t, shared = logreg_plan(n, d)
    rows = -(-m // LOGREG_ROWS) * LOGREG_ROWS
    resid = None if shared else _held_scratch(
        ("logreg", w.device, m, n),
        lambda: (torch.empty((rows, -(-n // SLAB) * SLAB),
                             dtype=torch.float32, device=w.device),))[0]
    v = torch.empty_like(w)
    logreg_score.launches += 1
    _library().call("gsmvi_logreg_score", _ptr(w), _ptr(xdata), _ptr(y_row),
                    _ptr(inv_ps2), _ptr(resid), _ptr(v), m, d, n, split, t,
                    _stream(w.device))
    return v


logreg_score.launches = 0

KERNEL_WRAPPERS = {
    "gsm_eps_update_fused": gsm_eps_update_fused,
    "make_fused_eps_multistep": make_fused_eps_multistep,
    "gaussian_score": gaussian_score,
    "make_fused_eps_step": make_fused_eps_step,
    "philox_normal": philox_normal,
    "philox4x32": philox4x32,
    "eps_smallspace_large": eps_smallspace_large,
    "eps_smallspace_panel": eps_smallspace_panel,
    "eps_smallspace": eps_smallspace,
    "thin_product": thin_product,
    "factor_apply": factor_apply,
    **{fn.__name__: fn for fn in (*THIN_MMA.values(), *APPLY_MMA.values())},
    "funnel_score": funnel_score,
    "banana_score": banana_score,
    "student_t_score": student_t_score,
    "mixture_score": mixture_score,
    "logreg_score": logreg_score,
}


def launch_counts() -> dict:
    """Calls on the card per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
