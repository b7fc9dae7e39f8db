#!/usr/bin/env python3
"""Drive the PyTorch port's GSM, BaM and ADVI paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (one JSON object per phase on its own line, with ``t_s``, the
seconds since the start; any failure raises and the script exits
non-zero):

0. device: the card's name and power limit (``nvidia-smi``), and the build
   of the CUDA kernels from ``gsmvi_tpu_torch/ops/cuda/csrc``.
1. kernels: K1 ``gsm_eps_update_fused``, K2 ``make_fused_eps_multistep``
   (spc=8, and nmax < spc) and K3 ``gaussian_score`` against their plain
   torch versions on the same CUDA tensors, at the main path's shape
   (B=32, D=256) and a ragged one (B=8, D=200), plus an input whose update
   the residual gates reject; and K1's two kernels alone, the cluster small
   space ``eps_smallspace`` against ``eps_smallspace_stacks_reference`` and
   the split-k ``thin_product`` (both transposes, with x = mu + out)
   against the plain products.  A full K2 block is held as a CUDA graph
   (``graph_block``: the call that captures and the replay after it both
   equal the eager block bit for bit); so are K6's in phase 12 and K2's
   over phase 17's shapes, B=128 and B=512 included.
2. main path: ``GSM(D=256, ..., device="cuda").fit(seed, batch_size=32,
   niter=N)`` on the dense-Gaussian target; K1's launch count must rise by
   exactly N + 1 and the converged moment errors must be under the bound.
3. headline path: ``FactorGSM(..., fused_score=t.fused_score,
   device="cuda")`` (spc=8); K2 and K3 must launch, the moments converge,
   and its it/s is printed beside the plain version's on the same card.
   Then the same fit on eager blocks (``cuda_graph=False``) must give the
   same state bit for bit, and ``graph_report`` prints both it/s, the
   captures, host and wall us per block, and the
   runtime calls per block under ``torch.profiler``: one
   ``cudaGraphLaunch``, and besides it at most the block's draws and
   BLOCK_HOST_CALLS more (phases 13 and 20 the same for K6 and the zoo).
4. BaM kernels: K7 ``bam_eps_update_fused`` against
   ``bam_eps_update_ns_reference`` at (B=32, D=256) and (B=12, D=200) on a
   benign, two stiff (lmax and gu gate) and a rejected input, with and
   without ``ef``; K8 ``make_fused_bam_multistep`` against
   ``bam_multistep_reference`` at spc=8: full block, nmax < spc, a stiff
   stop, a rejected sub-step with and without ``stop_on_reject``.  Flags
   and counts must be equal.  Then the cluster small space alone,
   ``bam_smallspace`` against ``bam_smallspace_stacks_reference``, on the
   K7 cases at (32, 256), (12, 200), (2, 10) and (56, 257): flags equal,
   stacked rows, ``vec`` and trace sums where the update is good.
5. BaM main path: ``BaM(D=256, ..., device="cuda").fit(seed,
   regf=Regularizers().linear(100.0), batch_size=32, niter=N_BAM,
   retries=0)`` (the factor route in update mode); K7 launches exactly once
   per step, the replays and the NS-tier histogram are printed, and the
   converged moments must be under the BaM bound.
6. BaM headline path: ``FactorBaM(..., fused_score=t.fused_score,
   device="cuda")`` (spc=8); K8 and K3 must launch, the moments converge,
   and its it/s is printed beside the plain version's on the same blocks.
7. ADVI kernels: K9 ``make_fused_advi_multistep`` and K10
   ``make_fused_advi_stl_multistep`` against ``advi_multistep_reference``
   and ``advi_stl_multistep_reference`` at (B=32, D=256) and (B=8, D=200),
   spc=8: the first sub-step's gradient (through the first moments), a
   full block, nmax < spc, a varying learning rate, a K10 gate trip at
   sub-step 3 and a K10 nonfinite-gradient freeze.  ``n_done`` and
   ``stiff`` must be equal.  Every full block is held as a CUDA graph
   (``advi_graph_block``: the call that captures and the replay after it
   equal the eager block bit for bit, K10's report included); so are phase
   17's K9/K10 blocks.
8. ADVI main path: ``ADVI(D=256, ..., device="cuda").fit(seed,
   Adam(1e-2), batch_size=32, niter=N_ADVI)`` (autograd, plain torch, no
   kernel); ``N_ADVI + 1`` finite losses and moments under the ADVI bound.
9. ADVI headline path: ``ADVI(..., fused_score=t.fused_score,
   device="cuda").fit_fused`` (spc=8): an analytic leg of N_ADVI steps (K9
   and K3 launch, K10 does not), then an STL polish leg of N_STL steps from
   its state at lr 3e-3 (K10 launches); replays and it/s are printed, the
   plain versions' it/s on the same blocks beside them, and both legs'
   moments must be under their bounds.  Each leg again on eager blocks
   (``cuda_graph=False``) must give the same state bit for bit, and
   ``advi_graph`` prints both it/s, the captures, host and wall us per
   block, the runtime calls and device allocations per block
   (``advi_graph_report``: one ``cudaGraphLaunch`` a full block, besides it
   at most the draws, the scalar table's copy, K10's report read and the
   chunk's state copies; no allocation in a K9 block), then the two-phase
   recipe's rate (``advi_two_phase``).

10. dense kernels: K5 ``gsm_update_fused`` against ``gsm_update`` at
    (B=32, D=256), (B=512, D=256), (B=8, D=200), B 1, 129 and 2048 at
    D=256, and batched at K=4: the max-abs error, S symmetric bit for bit,
    and the batched call equal to its single calls bit for bit.
11. dense paths: ``GSM(D=256, ..., use_factor=False, device="cuda")
    .fit(seed, batch_size=32, niter=N_ITER)`` (K5 exactly N_ITER + 1
    times, moments under the GSM bound), and ``GSM(D=256, ...,
    device="cuda").fit(seed, batch_size=512, niter=N_HUGE)``, which the
    huge-batch guard sends to the dense route (K5 N_HUGE + 1 times, moments
    under the huge-batch bound); each with its it/s and wall time per
    step, and the device busy and host wall time per step of one
    DENSE_WINDOW-step profiled fit with the idle share of that window
    (1 - busy / wall; the profiler slows the host, so it reads above the
    unprofiled share).
12. batch kernels: K6 ``make_fused_eps_batch_multistep`` against
    ``eps_batch_multistep_reference`` at K=4, B=32, D=256, spc=8: a full
    block, nmax < spc, and one replica whose sub-step the gates reject;
    counts equal, and every replica equal to a single K2 call bit for bit.
13. fit_batch paths at D=256, B=32, K=8 seeds 0..7: ``FactorGSM(...,
    fused_score=...).fit_batch(..., small_solver="fused")`` (K6 and K3;
    replicas 0 and 1 equal the single ``fit(0)``/``fit(1)`` on K2 bit for
    bit), ``GSM.fit_batch`` (batched K1) and ``GSM(use_factor=False)
    .fit_batch`` (batched K5); every replica under the GSM bound.  Then
    per-replica and aggregate it/s of the "fused" and "ns" routes at
    K in {8, 32} and D in {64, 256} (the bench's fit_batch cells) beside
    the single-fit K2 rate on the same card; K=32 runs fewer steps and
    checks finiteness only.
14. eps-step kernels: K4 ``make_fused_eps_step`` (ns, external draw)
    against ``eps_step_reference``; K4a through ``gsm_eps_update_fused(
    method="chol")`` and ``make_fused_eps_step(method="chol")`` against
    ``eps_update_core_reference``, plus an input whose K is indefinite in
    float32 and a NaN score (flags equal, old state kept); all at (B, D) =
    (32, 256), (8, 200) and (64, 256).  The Philox draw: its words equal the
    plain version's bit for bit, its normals within 4 ulp, and over 2^20
    draws |mean| < 5e-3, |var - 1| < 1e-2 and the KS distance to N(0, 1)
    < 3e-3; two seeds give other draws; the on-card-draw K4 step against
    the plain step on the plain draw.  The draw's times at (32, 256) and
    (512, 1024) beside ``torch.randn`` of the same shape (its yardstick:
    another stream, the same distribution), CUDA events and device time.
15. eps-step path: ``FactorGSM(..., fused_score=..., steps_per_call=1)
    .fit(seed, batch_size=32, niter=N_ITER)``: K4 exactly N_ITER + 1 times,
    K2 never, and the final state equals phase 3's spc=8 state bit for bit.
16. audit paths: phase 3's fit with ``audit_every=500`` (six records, all
    valid, no warning at tol 1e-3, K4 exactly six times, the state equal to
    phase 3's bit for bit) and phase 6's BaM fit with ``audit_every=500``
    (four records, K7 four times, no warning on a valid record, the state
    equal to phase 6's bit for bit).
17. ranges: K1 and K2 against their plain versions at (B, D) = (1, 1),
    (2, 10), (3, 5), (7, 16), at B 65, 96, 127 (the row panels' ragged
    edges) x D 1, 33, 256, and at (128, 256), (129, 33), (200, 1), (256,
    256), (512, 256), (128, 1024), (512, 1024): at B 65-128 on the
    row-panel small space (``eps_smallspace_panel``), above on the grid one
    (``eps_smallspace_large``, one cooperative launch, its 16 x 16 and
    32 x 32 tiles), each checked to run exactly there; K6 at
    K=4, B=128 equal to the single K2 fits bit for bit; K7/K8 at B=2 and
    B=128 (``bam_smallspace_panel``, checked) and K9/K10 at (1, 16) and
    (512, 1024), flags and counts equal to the plain version's;
    ``GSM(2048, ...).fit`` at B=32 on K1 (finite moments); the large-B
    small spaces' per-call and device times beside their bounds (the grid
    one at B=256 and 512, checked to run as its one kernel).
18. examples: the reference examples' configurations with the fitters'
    defaults, ``GSM(10)`` at B=2 (K1 exactly niter + 1 times),
    ``BaM(5, use_lowrank=True)`` at B=2 and ``GSM(16)`` at B=1, under
    1.5 x the worst JAX CPU fit of the same arrays
    (``tools/jax_example_bound.py``); ``FactorGSM(fused_score)`` at B=128
    to convergence on the row-panel small space, bounded the same way;
    a ``FactorBaM(fused_score)`` run at B=128 on BaM's row-panel small
    space; a short ``FactorGSM(fused_score)`` run at B=256 on the grid
    small space.
19. zoo kernels: ``funnel_score``, ``banana_score``, ``student_t_score``
    (K11a), ``mixture_score`` and ``logreg_score`` (K11b) against their
    plain versions at (32, 256), (3, 10) and (512, 1024); the mixture also
    with the JAX target's padded K=8 (five -1e30 rows), at K=1024 and at
    separation 0.3 (blended responsibilities), logreg at N=1, N=4096 and on
    rows with |z| > 100 (saturated, finite); per-call times at (32, 256),
    by CUDA events and on the device (each score must run its one kernel
    alone), beside its library yardsticks (``zoo_yardsticks``: ``addmm``
    for the Student-t's product, ``mm`` for the mixture's first product and
    for each of logreg's two, the second as ``library_second_ms`` and
    ``library_second_device_ms``), and the launch floor: the device time of
    a one-element ``fill_``, the smallest kernel PyTorch launches
    (``launch_floor_device_ms`` in ``zoo_times``).
20. zoo path: ``FactorGSM(fused_score=t.fused_score)`` on ``funnel(256)``,
    ``banana(256)``, ``student_t(0, 256, df=6)``, ``gaussian_mixture(0,
    256)`` and ``logistic_regression(0, 256)`` at B=32, niter=3000, spc=8
    (K2 and the zoo kernel must launch, K1 and K3 not; banana, Student-t,
    the mixture (against the component it lands in) and logreg (against
    the Laplace approximation) under 1.5 x the worst JAX CPU fit, funnel
    finite and PD), its it/s beside the card; one ``FactorBaM(fused_score)``
    and one ``ADVI.fit_fused`` run per target, equal bit for bit to the
    same run on eager blocks, its K9 block with the zoo score captured.

21. surface: the flow of ``examples/example_initializers.py`` at D=256 on
    ``dense_gaussian(0, 256)``: ``lbfgs_init(ones(256), t.lp, t.lp_g)``,
    then ``GSM.fit`` from its (mean, cov) at B=32, N_ITER steps under
    ``KLMonitor(batch_size_kl=32, checkpoint=10, offset_evals=res.nfev)``
    (K1 exactly N_ITER + 1 times, under the GSM bound), then ``ADVI.fit``
    under a second monitor; each monitor's ``rkl``/``fkl``/``nevals`` of
    the JAX package's cadence length, ``rkl`` finite and falling, ``nevals``
    from the L-BFGS cost.  ``Posterior.from_fit`` of the GSM fit: its
    float32 ``log_prob`` against float64 on the same (mean, chol), its
    ``save``/``load`` bit for bit.  A ``FactorGSM(fused_score)`` fit saved
    (``save_state``) after CKPT_STEP steps, loaded (``load_state``) and
    resumed equals phase 3's state bit for bit.
22. replicas: K7 over stacked replicas (``bam_eps_update_replicas``, one
    launch sequence for K replicas, the small spaces' clusters on
    blockIdx.y, each replica on its own NS tier from a tier table) against
    its plain version and against K7 on each replica alone (bit for bit) at
    (B, D) = (2, 10), (32, 256), (56, 256), (128, 256) (the row panels)
    for K = 1 and 8, the eight on mixed tiers with a rejecting and a stiff
    replica; ``FactorBaM.fit_batch(range(8), linear(100.0), B=32,
    niter=N_BAM)`` on it (one replica launch a step; replicas 0 and 1
    equal to ``fit(0)``/``fit(1)`` bit for bit; every replica under the
    BaM bound; per-replica and aggregate it/s beside the single fits');
    ``BaM.fit_batch`` and ``ADVI.fit_batch`` over seeds 0..3, 500 steps
    (replicas 0, 1 equal to their single fits, losses (K, niter + 1), under
    1.5 x the worst JAX CPU fit_batch replica);
    per-call times of the replica K7 at K=8 beside eight single K7 calls.
23. host callables: ``GSM(256, None, lp_np)`` on dense_gaussian(0, 256)'s
    numpy score (the dense eager host loop: K5 exactly N_ITER + 1 times
    and nothing else, under the GSM bound), its it/s and profiled idle
    share beside the tensor dense route's; a numpy wrapper of the tensor
    score equal to the tensor dense fit bit for bit (N_HOST_EQUAL steps);
    ``BaM(jit_compile=False)`` on the numpy score (no kernel, under phase
    22's dense BaM bound); ``FactorGSM``/``FactorBaM`` on it raise
    ``TypeError``.
24. precision: the bf16 and bf16x3 tensor-core thin product (both
    transposes, x = mu + out) and fat apply (its select) against their
    plain versions (``mm_prec``) and float64 at (32, 256), (8, 200),
    (128, 256) and (512, 1024) (the apply also at D=1 and D=33,
    APPLY_EDGES), within the bounds of PREC_SUM and
    PREC_REL, and K=3 replica launches against single launches bit for
    bit; K1, K4, K2 and K6 at "high" and "bf16" against their plain
    versions at (32, 256) and (8, 200); the products' device times beside
    ``torch.mm`` on bf16 operands (converted ahead) and, for the apply,
    the whole function by library calls (both operands' bf16 round trips
    and ``addmm``); the thin product's three products (vf, t, ef with x)
    at every PREC_SHAPES shape and both precisions beside ``torch.mm`` on
    bf16 operands, each on ``thin_mma_kernel`` alone; K1, K4, K2 and K6 per call at each
    precision beside their bounds; ``FactorGSM(fused_score,
    pallas_precision=p)`` at D=256, B=32, N_ITER steps for each p (three
    tensor-core row products and one tensor-core apply a sub-step, finite
    and PD, under 1.5 x the worst plain CPU fit of ``tools/
    option_bounds.py``), and on K1 for N_PREC_K1 steps.
25. methods: ``FactorGSM(method=m)`` for m in twophase and qr at D=256,
    B=32, N_ITER steps on the card (no kernel, Finv refreshed exactly 3
    times at refresh_every=1000), under 1.5 x the worst JAX CPU fit of the
    same method (``tools/option_bounds.py``).
26. float32 fat apply: ``factor_apply`` (``apply_f32.cu``) against the
    32x32 template it replaced (``gsmvi_factor_apply_oracle``, gemm.cu),
    bit for bit (``same_bits``) over 2B in APPLY_K2, D in APPLY_D, K in
    (1, 8), good 0 and 1, in place and out of place, and each replica of a
    K=8 launch against a launch on it alone; against its plain version on
    F = 0 within PREC_SUM 2B 2^-24 |su|^T |sw|; K1, batched K1, K4a, K4
    (ns and chol), K2 and K6 each on ``apply_f32_kernel`` and none on the
    template (profiler kernel names); device times beside the template's,
    ``torch.addmm`` (TF32 off; partial: no select) and addmm with
    ``torch.where`` at APPLY_TIMES.
27. BaM's fat apply: ``bam_apply`` (``apply_f32.cu``, ``gsmvi_bam_apply``:
    F + su^T sw and each tile's (sum F'^2, sum F^2)) against the 32x32
    template it replaced (``gsmvi_bam_apply_oracle``, gemm.cu) over
    2(B+1) for B in BAM_APPLY_B x D in BAM_APPLY_D x K in (1, 3): F' bit
    for bit, each tile's pair within (n - 1) 2^-24 of its exact sums and
    the totals within (n + 32^2) 2^-24 of the oracle's, replica z of K=3
    equal to a launch on it alone, a signed-zero case, the halt word (set:
    nothing written; cleared: it runs); against its plain version on F = 0
    at BAM_APPLY_PLAIN; device times of the kernel, the template and
    ``torch.addmm`` + the two sums at BAM_APPLY_TIMES.  K7 and K8 (phase
    4's times) and the replica K7 (phase 22's) are checked there to run
    ``apply_f32_kernel`` and never ``gemm_kernel``.
28. Philox: the redesigned draw (``prng.cu``) against
    ``philox4x32_reference``/``philox_normal_reference`` bit for bit, words
    and normals, and against the replaced design (``gsmvi_philox_oracle``)
    at (32, 256), (512, 1024) and an odd count (37, 201); device and event
    times at (32, 256) and (512, 1024) beside the replaced design's,
    ``torch.randn``'s (another stream, the same distribution) and the
    bytes-or-operations bound (``philox_bound``, on the instructions per
    normal that ``tools/philox_sass.py`` counts in this build's SASS; the
    new kernels' products checked to be one IMAD.WIDE.U32 each).
29. mesh: ``initialize_distributed`` on a ``file://`` store, a one-rank
    NCCL group; ``make_mesh(1)``; ``FactorGSM(mesh=)`` (K1, N_ITER steps),
    ``FactorBaM(mesh=)`` (K7, N_BAM steps, ``linear(100.0)``) and
    ``GSM(use_factor=False, mesh=)`` (K5, N_ITER steps), each equal bit
    for bit to the same fit without a mesh in phase 2, 5 or 11, under its
    bound, its kernel launched;
    ``ADVI(mesh=).fit`` equal to ``ADVI.fit`` (MESH_ADVI_ITER steps);
    ``ADVI.fit_fused`` and out-of-range shapes under a mesh raise;
    ``blocked_cholesky`` at D=512, b=128 against float64 (and on a 1 x 1
    mesh's column-sharded DTensor, bit for bit; NaN from the failing block
    of a matrix that is not PD); the configuration of
    ``examples/example_large_d_torch.py`` (D=512, B=32, 4000 steps,
    ``chol_block=128``) under its JAX-derived bound; then the group is
    destroyed.

Launch counts are set to 0 just before each path (2, 3, 5, 6, 8, each leg
of 9, both fits of 11, the three fits of 13, 15, both fits of 16, the
D=2048 fit of 17, each fit of 18 and of 20, the monitored GSM fit and the
checkpointed fit of 21, the FactorBaM replica fit of 22, the numpy-score
GSM fit of 23, each fit of 24, each mesh fit of 29) and read just after
it; every kernel of the
``kernels`` line must have launched on those paths.
Then the card's name and power limit, the kernel table (each kernel's
bound, from this run's shapes: the larger of its bytes over 3.35 TB/s and
its matrix-product FLOPs over 67 TFLOP/s, float32 outside the tensor cores,
or, for the bf16 and bf16x3 variants, over 989 TFLOP/s, the dense bf16
tensor-core peak, three passes at bf16x3;
the time of one PyTorch call computing the same function where there is
one; ``device_ms`` and ``library_device_ms``, the kernel's and that call's
device time per call under ``torch.profiler`` for K1, its small space and
thin product, K2, K3, K4, K6, K7, K8 (spc=8), the BaM small space and the
zoo scores at D=256, B=32 (K6 at K=8; the BaM kernels at tier 0, with
``ms_tier3`` and ``device_ms_tier3`` at the most benign tier beside; K2,
K6, K9 and K10 with ``ms_eager`` and ``device_ms_eager``, their blocks
enqueued eagerly, beside the graph's ``ms``; K9 and K10 per 8-step block chained through the
working state as the fit runs them, bound on the FLOPs of lower-triangular
L and A, ``advi_flops``), null elsewhere; the
profiler's kernel names must show K1 on the cluster small space, the
thin product and ``apply_f32_kernel``, K3 on the thin product, K7, K8 and
the BaM small space on the BaM cluster kernel, with every BaM row product
on the thin product and the fat apply on ``apply_f32_kernel``,
and each zoo score on its one kernel, ``ZOO_KERNELS``),
and as the last line ``{"ok": true, "device": {...}}`` with
``count`` ``torch.cuda.device_count()``: everything runs on device 0.  Without a CUDA device it exits 1
before printing any result.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

B, D = 32, 256                # the repo's headline cell (bench.py:39-40)
RAGGED = (8, 200)
TARGET_SEED, FIT_SEED = 0, 0
N_ITER = 3000
# Converged-moment bounds at D=256, B=32, niter=3000 (errors as in
# bench.py:207-211): 1.5 x the largest error of the JAX package's own CPU
# fits of the same target (numpy seed 0, float32) at the same niter and
# batch — 9 dense-route and 9 exact-eps-route fits (PRNG keys 0..8) and 3
# fits on its NS eps step ``gsm_eps_update_ns_xla`` (keys 0..2):
# mean_err <= 1.9887e-3, cov_err <= 5.0331e-4.
MEAN_ERR_BOUND = 1.5 * 1.9887e-3
COV_ERR_BOUND = 1.5 * 5.0331e-4
# Kernel vs plain version (both float32 on the card, sums in other orders):
# the JAX package's kernel-vs-twin bounds, 1e-5 on the mean and
# 1e-5 * max|F| on the factor, for one update; spc=8 chained sub-steps
# compound the rounding, so the multistep comparison allows 1e-4.
MEAN_TOL, F_TOL, MULTI_TOL = 1e-5, 1e-5, 1e-4
SCORE_TOL = 1e-5
# BaM at D=256, B=32, Regularizers().linear(100.0), retries=0: the errors of
# the JAX package's own CPU fits flatten by niter 1000-2000 (PERF.md), so
# N_BAM = 2000, and the bound is 1.5 x the worst of its 20 fits at that
# niter — 8 on the XLA factor route (FactorBaM(use_pallas=False),
# solver="auto", keys 0..7) and 4 on the NS route (its K8 kernel body in
# interpret mode, keys 0..3): mean_err <= 4.3438e-3, cov_err <= 4.8058e-4.
N_BAM = 2000
BAM_MEAN_ERR_BOUND = 1.5 * 4.3438e-3
BAM_COV_ERR_BOUND = 1.5 * 4.8058e-4
BAM_REGF0 = 100.0
# K7/K8 vs their plain versions (float32 on the card, sums in other orders
# and q_t/qf/fom_t assembled from vf/t/ef rows): one update within
# 1e-5 * max(1, scale) on the mean and the factor (the JAX package's
# interpret-vs-core bound); eight chained sub-steps within 1e-4; the gate
# statistics within 1e-3 relative (they are read against gates with a 0.7
# margin).
BAM_TOL, BAM_MULTI_TOL, BAM_STATS_RTOL = 1e-5, 1e-4, 1e-3

# ADVI at D=256, B=32 on the same target.  Single-phase ADVI there is
# limited by the method (bench.py:332-346), so the bounds test that the
# port computes what JAX computes, not convergence: 1.5 x the worst of the
# JAX package's own CPU runs (float32, the numpy-seed-0 arrays via
# _gaussian_target, PRNGKey(k) for k = 0..7): ``fit`` with optax.adam(1e-2)
# for N_ADVI steps, then ``fit(estimator="stl")`` with optax.adam(3e-3) for
# N_STL steps from its moments (PERF.md): fit mean_err <= 1.22289 (k=3),
# cov_err <= 0.98784 (k=6); then STL mean_err <= 1.26452, cov_err <=
# 0.98184 (both k=0).
N_ADVI, N_STL = 3000, 2000
ADVI_LR, STL_LR = 1e-2, 3e-3
ADVI_MEAN_ERR_BOUND = 1.5 * 1.22289
ADVI_COV_ERR_BOUND = 1.5 * 0.98784
STL_MEAN_ERR_BOUND = 1.5 * 1.26452
STL_COV_ERR_BOUND = 1.5 * 0.98184
# K9/K10 vs their plain versions (float32 on the card, GEMM sums in other
# orders; the Adam arithmetic rounds identically): the first sub-step's
# gradient within 1e-5 * max(1, scale); after a block, every state tensor
# within 1e-5 * max(1, |x|) on at least 99.99 % of its entries (Adam
# turns a gradient at rounding level into a step of up to lr either way;
# above B=32 the 1e-5 grows as sqrt(B/32), the rounding of the B-row sums
# behind the gradient), and loc and L within 2 * sum(lr) everywhere.
ADVI_GRAD_TOL, ADVI_RTOL, ADVI_FRAC = 1e-5, 1e-5, 0.9999
ADVI_RAGGED = (8, 200)

# The dense route (K5).  N_HUGE = 3000: at B=512 the JAX dense fits need
# as many steps as at B=32 (the covariance grows from I at a rate set by
# the step count; errors 0.94 / 0.39 / 0.057 after 200 / 500 / 1000 steps,
# tools/jax_dense_bound.py).  The huge-batch bound is 1.5 x the worst of 4
# JAX CPU dense fits (float32, PRNGKey(k), k = 0..3) of the same target at
# B=512, niter=N_HUGE (PERF.md): mean_err <= HUGE_MEAN_REF, cov_err <=
# HUGE_COV_REF.
HUGE_B, N_HUGE = 512, 3000
HUGE_MEAN_REF, HUGE_COV_REF = 3.4940e-4, 3.7933e-4
HUGE_MEAN_ERR_BOUND = 1.5 * HUGE_MEAN_REF
HUGE_COV_ERR_BOUND = 1.5 * HUGE_COV_REF
# K5 vs gsm_update (float32 on the card, sums in other orders): the JAX
# package's kernel-vs-XLA bound, 1e-5 * max(1, |x|) on mu and S.
DENSE_TOL = 1e-5
DENSE_SHAPES = ((B, D), (HUGE_B, D), (8, 200), (1, D), (129, D), (2048, D))
# K5 on the card: two launches (the thin product with the rows' dot
# products, then the Gram) and two allocations (mu and S) per call.
K5_KERNELS = ("thin_kernel", "gram_kernel")
DENSE_WINDOW = 64
# fit_batch: K=8 replicas on the main path; the rate cells of bench.py:514.
FIT_BATCH_K = 8
RATE_CELLS = ((64, 8), (64, 32), (256, 8), (256, 32))
N_RATE = {8: 800, 32: 400}
# The card's published peaks (NVIDIA H100 SXM data sheet) behind bound_ms.
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

SOURCES = {
    "gsm_eps_update_fused": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:461"),
    "eps_smallspace": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:231"),
    "thin_product": (
        "gsmvi_tpu_torch/ops/cuda/csrc/thin_gemm.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:622"),
    "make_fused_eps_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:685"),
    "gaussian_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/thin_gemm.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:778"),
    "bam_eps_update_fused": (
        "gsmvi_tpu_torch/ops/cuda/csrc/bam_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:380"),
    "bam_smallspace": (
        "gsmvi_tpu_torch/ops/cuda/csrc/bam_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:195"),
    "bam_eps_update_replicas": (
        "gsmvi_tpu_torch/ops/cuda/csrc/bam_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:407"),
    "make_fused_bam_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/bam_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:425"),
    "make_fused_advi_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/advi.cu",
        "gsmvi_tpu/ops/pallas/advi_fused.py:121"),
    "make_fused_advi_stl_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/advi.cu",
        "gsmvi_tpu/ops/pallas/advi_fused.py:249"),
    "gsm_update_fused": (
        "gsmvi_tpu_torch/ops/cuda/csrc/gsm_step.cu",
        "gsmvi_tpu/ops/pallas/gsm_step.py:76"),
    "make_fused_eps_batch_multistep": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_cluster.cu",
        "gsmvi_tpu/ops/pallas/batch_fused.py:54"),
    "make_fused_eps_step": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_chol.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:586"),
    "eps_smallspace_large": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_grid.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:461"),
    "eps_smallspace_panel": (
        "gsmvi_tpu_torch/ops/cuda/csrc/eps_smallspace_panel.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:231"),
    "bam_smallspace_panel": (
        "gsmvi_tpu_torch/ops/cuda/csrc/bam_smallspace_panel.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:195"),
    "funnel_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/zoo_score.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:788"),
    "banana_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/zoo_score.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:810"),
    "student_t_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/zoo_student_t.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:831"),
    "mixture_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/zoo_score_b.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:848"),
    "logreg_score": (
        "gsmvi_tpu_torch/ops/cuda/csrc/zoo_logreg.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:869"),
    "thin_product_bf16": (
        "gsmvi_tpu_torch/ops/cuda/csrc/thin_mma.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:622"),
    "thin_product_bf16x3": (
        "gsmvi_tpu_torch/ops/cuda/csrc/thin_mma.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:622"),
    "factor_apply": (
        "gsmvi_tpu_torch/ops/cuda/csrc/apply_f32.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:346"),
    "factor_apply_bf16": (
        "gsmvi_tpu_torch/ops/cuda/csrc/apply_mma.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:346"),
    "factor_apply_bf16x3": (
        "gsmvi_tpu_torch/ops/cuda/csrc/apply_mma.cu",
        "gsmvi_tpu/ops/pallas/fused_step.py:346"),
    "bam_apply": (
        "gsmvi_tpu_torch/ops/cuda/csrc/apply_f32.cu",
        "gsmvi_tpu/ops/pallas/bam_fused.py:319"),
}
# K4: the shapes of phase 14.  A whole step carries the score's GEMM
# rounding into the update, as K2's sub-steps do, so the ns step is held to
# K2's 1e-4.  The exact (chol) variant factors the jittered Gram G of the
# Z^T rows, whose condition on this target from (0, I) is 1e8-1e12 before
# the jitter (c rows nearly parallel to the draws), so its float32 rounding
# depends on the input: it is held to the larger of the JAX package's own
# chol-kernel bound, 1e-4 on the mean and 2e-4 * max|S| on S = F F^T
# (tests/test_pallas.py:98-101), and CHOL_FLOOR x the plain float32
# version's own distance from the plain version in float64 on the same
# input (the rounding floor of that input).
STEP_SHAPES = ((B, D), RAGGED, (64, D))
STEP_TOL = MULTI_TOL
CHOL_MEAN_TOL, CHOL_COV_TOL, CHOL_FLOOR = 1e-4, 2e-4, 4.0
# The Philox draw: 2^20 normals; bounds as in tests/test_torch_eps_step.py.
PRNG_SHAPE = (1024, 1024)
PRNG_ULP = 4
PRNG_MEAN_TOL, PRNG_VAR_TOL, PRNG_KS_TOL = 5e-3, 1e-2, 3e-3
PHILOX_LARGE = (512, 1024)
AUDIT_EVERY, AUDIT_TOL = 500, 1e-3


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 2)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call between CUDA events (device timeline)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, calls: int = 50, warmup: int = 5) -> tuple:
    """(device milliseconds per call, names of the kernels it ran):
    ``torch.profiler``'s kernel intervals over ``calls`` back-to-back calls,
    summed (one stream: the sum is the device's busy time)."""
    import torch

    from tools.profile_gpu import profile_window

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    _, kernels, _ = profile_window(window)
    us = sum(k.time_range.end - k.time_range.start for k in kernels)
    return 1e-3 * us / calls, sorted({k.name for k in kernels})


def busy_per_step(run, steps: int) -> tuple:
    """(busy, wall): device busy and host wall microseconds per step of
    ``run()`` (a fit of ``steps`` steps) in one profiled window, busy the
    union of its kernels' intervals under ``torch.profiler``."""
    import torch

    from tools.profile_gpu import busy_us, profile_window

    torch.cuda.synchronize()

    def window():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0)

    _, kernels, wall = profile_window(window)
    return busy_us(kernels) / steps, wall / steps


def graph_block(step, nmax, block, mean, f, params, torch):
    """A K2/K6 block (``FusedBlocks``) that, when full, is held to the
    graph: the first call captures, the second replays, and both must
    equal the same block enqueued eagerly (``graph=False``) bit for bit.
    Returns the replayed (or, for nmax < spc, the eager) result."""
    eager = step(nmax, block, mean, f, *params, graph=False)
    if nmax < step.spc:
        return eager
    outs = [step(nmax, block, mean, f, *params) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for out in outs for x, y in zip(out, eager)),
          f"a {type(step).__name__} graph block differs from the eager block "
          f"(B={step.batch}, D={step.d}, K={step.k})")
    check(step.captures >= 1, "no CUDA graph was captured")
    return outs[1]


def host_block_us(runner, state, blocks, spc, torch) -> tuple:
    """(host us per block, wall us per block) of ``blocks`` full blocks of
    a fit's chunk runner: the host clock around the enqueue alone, then
    around enqueue and ``synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = runner(state, spc)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e6 * (t1 - t0) / blocks, 1e6 * (t2 - t0) / blocks


def host_api_per_block(runner, state, blocks, spc, torch) -> dict:
    """The CUDA runtime calls the host makes per full block of a fit's
    chunk runner (``torch.profiler``'s host events), by name, and the
    kernels the device ran per block."""
    from torch.autograd import DeviceType

    from tools.profile_gpu import profile_window

    runner(state, spc)
    torch.cuda.synchronize()

    def window(state=state):
        for _ in range(blocks):
            state = runner(state, spc)
        torch.cuda.synchronize()

    prof = profile_window(window)[0]
    api, kernels = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
        elif e.name.startswith("cuda") and e.name != "cudaDeviceSynchronize":
            api[e.name] = api.get(e.name, 0) + 1
    return {"api": {k: v / blocks for k, v in sorted(api.items())},
            "kernel_nodes": kernels / blocks}


# The host's calls per graph block besides its draws' launches: the copies
# of (mean, F) in and of (mean, F, n_acc) out, and the runner's three count
# updates (eight), with room for two more.
BLOCK_HOST_CALLS = 10


def graph_report(fitter, runner, state, spc, torch, blocks=16) -> dict:
    """Phases 3, 13 and 20: a fit runner's captures (a count),
    host and wall us per full block on the graph and on eager blocks
    (``cuda_graph`` off), and the runtime calls per graph block.  Fails
    unless a full block is one graph launch and the host's other calls
    per block are at most its draws (spc per replica) and
    BLOCK_HOST_CALLS more."""
    rec = {"captures": runner.blocks.captures}
    for graph in (True, False):
        fitter.cuda_graph = graph
        runner(state, spc)
        host, wall = host_block_us(runner, state, blocks, spc, torch)
        rec["graph" if graph else "eager"] = {"host_us_per_block": host,
                                              "wall_us_per_block": wall}
    fitter.cuda_graph = True
    rec["per_graph_block"] = calls = host_api_per_block(runner, state,
                                                        blocks, spc, torch)
    api = calls["api"]
    launches = sum(v for k, v in api.items() if k.startswith(
        "cudaLaunchKernel"))
    check(api.get("cudaGraphLaunch") == 1.0,
          f"a full block must be one graph launch: {calls}")
    draws = spc * (len(state.seed) if isinstance(state.seed, tuple) else 1)
    check(launches + api.get("cudaMemcpyAsync", 0)
          <= draws + BLOCK_HOST_CALLS,
          f"the host issues more than the draws and a handful of calls per "
          f"block: {calls}")
    return rec


def _tensors(obj):
    import torch

    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def bound(plain, inputs, flops=None, peak=None) -> dict:
    """The least time the card could take for the work of ``plain()``:
    the larger of its bytes (each tensor of ``inputs`` read once, each
    output written once) over HBM_BYTES_PER_S and its matrix-product FLOPs
    over ``peak`` (default F32_FLOPS_PER_S; the tensor-core variants take
    BF16_FLOPS_PER_S, their plain version forming each bf16x3 pass as a
    product): ``flops`` where the function needs fewer than its plain
    version forms, else torch's FlopCounterMode over ``plain()`` (counted
    on this run's inputs, so a block that stops early counts what it
    did)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = plain()
    flops = counter.get_total_flops() if flops is None else flops
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*_tensors(inputs), *_tensors(out)))
    t_ops = flops / (F32_FLOPS_PER_S if peak is None else peak)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def moment_errs(mean, cov, true_mean, true_cov) -> tuple:
    """(mean_err, cov_err) as bench.py:207-211 defines them, on numpy
    arrays."""
    import numpy as np

    scale = max(1.0, float(np.abs(true_cov).max()))
    return (float(np.abs(mean - true_mean).max()),
            float(np.abs(cov - true_cov).max()) / scale)


def errs(mean, cov, t):
    """``moment_errs`` of a fit's tensors against the target's moments."""
    return moment_errs(*(a.detach().cpu().numpy()
                         for a in (mean, cov, t.mean, t.cov)))


def nearest_component_errs(mean, cov, means) -> tuple:
    """``errs`` of a fit of the identity-covariance mixture with the means
    (K, D) against its component nearest the fit's mean, N(m_k*, I): at
    separation 3 and D=256 the components lie ~68 apart, the other
    responsibilities underflow to 0 near a mode, and GSM's fixed point is
    that component."""
    import numpy as np

    k = int(np.argmin(((means - mean) ** 2).sum(axis=1)))
    return moment_errs(mean, cov, means[k], np.eye(means.shape[1]))


def laplace_moments(x, y, prior_scale: float, iters: int = 30) -> tuple:
    """(MAP, inverse Hessian at the MAP) of the logistic-regression
    posterior with data x (N, D), labels y (N,) and prior N(0, ps^2 I), by
    Newton's method in float64 from w = 0: the Laplace approximation, the
    reference the logreg fits are measured against (it has no analytic
    moments)."""
    import numpy as np

    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    prec0 = np.eye(x.shape[1]) / prior_scale ** 2

    def newton(w):
        """(the negative Hessian, the gradient) of the log-posterior at w."""
        p = 1.0 / (1.0 + np.exp(-(x @ w)))
        return (x.T @ (x * (p * (1.0 - p))[:, None]) + prec0,
                x.T @ (y - p) - prec0 @ w)

    w = np.zeros(x.shape[1])
    for _ in range(iters):
        w = w + np.linalg.solve(*newton(w))
    return w, np.linalg.inv(newton(w)[0])


def phase_kernels(fs, dense_gaussian, torch, np):
    """Each kernel against its plain version on the same CUDA tensors."""
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in SOURCES}
    for b, d in ((B, D), RAGGED):
        rng = np.random.default_rng(1000 + d)
        a = rng.standard_normal((d, d))
        f = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
        mu = rng.standard_normal(d).astype(np.float32)
        eps = rng.standard_normal((b, d)).astype(np.float32)
        v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
        cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        eps_t, v_t, mu_t, f_t = cu(eps), cu(v), cu(mu), cu(f)
        fmax = float(np.abs(f).max())

        # Draw rows scaled over three decades make I + Gu so ill-conditioned
        # (~1e6) that the short Newton-Schulz chains cannot converge: the
        # residual gates must reject that update.
        ladder = np.logspace(0.0, 3.0, b, dtype=np.float32)[:, None]
        cases = {"update": eps_t, "update_reject": cu(ladder * eps)}
        for case, e in cases.items():
            for with_ef in (False, True):
                ef = e @ f_t.T if with_ef else None
                m_k, f_k, g_k = fs.gsm_eps_update_fused(e, v_t, mu_t, f_t,
                                                        ef=ef)
                m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(
                    e, v_t, mu_t, f_t, ef_t=ef)
                torch.cuda.synchronize()
                em = float((m_k - m_p).abs().max())
                ef_ = float((f_k - f_p).abs().max())
                rec = {"kernel": "gsm_eps_update_fused", "case": case,
                       "B": b, "D": d, "with_ef": with_ef,
                       "good": [bool(g_k), bool(g_p)], "mean_err": em,
                       "f_err": ef_, "f_tol": F_TOL * fmax,
                       "mean_tol": MEAN_TOL}
                emit({"phase": "kernels", **rec})
                check(bool(g_k) == bool(g_p) == (case == "update"),
                      f"K1 accept flag {rec}")
                if case == "update_reject":
                    check(torch.equal(m_k, mu_t) and torch.equal(f_k, f_t),
                          "K1 rejected update must return the old state")
                check(em <= MEAN_TOL and ef_ <= F_TOL * fmax,
                      f"K1 disagrees with its plain version: {rec}")
                worst["gsm_eps_update_fused"] = max(
                    worst["gsm_eps_update_fused"], em, ef_)

            # K1's two kernels alone: the cluster small space (its stacked
            # rows held through F + su^T sw) and the thin product.
            vf, ef = v_t @ f_t, e @ f_t.T
            vft = vf @ f_t.T
            m_k, su_k, sw_k, g_k = fs.eps_smallspace(e, v_t, vf, vft, ef,
                                                     mu_t)
            m_p, su_p, sw_p, g_p = fs.eps_smallspace_stacks_reference(
                e, v_t, vf, vft, ef, mu_t[None], batch=b)
            torch.cuda.synchronize()
            em = float((m_k - torch.where(g_p, m_p[0], mu_t)).abs().max())
            ef_ = float(((f_t + su_k.T @ sw_k) - (f_t + su_p.T @ sw_p))
                        .abs().max()) if bool(g_p) else 0.0
            rec = {"kernel": "eps_smallspace", "case": case, "B": b, "D": d,
                   "good": [bool(g_k), bool(g_p)], "mean_err": em,
                   "f_err": ef_, "f_tol": F_TOL * fmax, "mean_tol": MEAN_TOL}
            emit({"phase": "kernels", **rec})
            check(bool(g_k) == bool(g_p) == (case == "update"),
                  f"small space accept flag {rec}")
            check(em <= MEAN_TOL and ef_ <= F_TOL * fmax,
                  f"the small space disagrees with its plain version: {rec}")
            worst["eps_smallspace"] = max(worst["eps_smallspace"], em, ef_)
            for trans in (False, True):
                got = fs.thin_product(e, f_t, trans=trans, mu=mu_t if trans
                                      else None)
                want = e @ (f_t.T if trans else f_t)
                got, x_k = got if trans else (got, None)
                torch.cuda.synchronize()
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                if trans:
                    err = max(err, float((x_k - (mu_t + got)).abs().max()))
                rec = {"kernel": "thin_product", "case": case, "B": b,
                       "D": d, "trans": trans, "err": err,
                       "tol": SCORE_TOL * scale}
                emit({"phase": "kernels", **rec})
                check(err <= SCORE_TOL * scale,
                      f"the thin product disagrees with its plain version: "
                      f"{rec}")
                worst["thin_product"] = max(worst["thin_product"], err)

        t = dense_gaussian(TARGET_SEED, d, device=dev)
        score_fn, params = t.fused_score
        spc = 8
        block = cu(rng.standard_normal((spc * b, d)).astype(np.float32))
        step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
        mean0 = torch.zeros(d, device=dev)
        f0 = torch.eye(d, device=dev)
        for nmax in (spc, 3):
            # A full block: the first call runs eagerly and captures its
            # CUDA graph, the second replays it; both equal the eager
            # block bit for bit.  nmax < spc runs eagerly.
            m_k, f_k, n_k = graph_block(step, nmax, block, mean0, f0, params,
                                        torch)
            m_p, f_p, n_p = fs.eps_multistep_reference(
                fs.gaussian_score_reference, params, nmax, block, mean0, f0,
                batch=b)
            torch.cuda.synchronize()
            em = float((m_k - m_p).abs().max())
            ef_ = float((f_k - f_p).abs().max())
            fscale = float(f_p.abs().max())
            rec = {"kernel": "make_fused_eps_multistep", "B": b, "D": d,
                   "spc": spc, "nmax": nmax, "n_acc": [int(n_k), int(n_p)],
                   "mean_err": em, "f_err": ef_,
                   "f_tol": MULTI_TOL * fscale, "mean_tol": MULTI_TOL,
                   "graphs_captured": step.captures,
                   "graph_equals_eager": True}
            emit({"phase": "kernels", **rec})
            check(int(n_k) == int(n_p) == nmax, f"K2 accepted counts {rec}")
            check(em <= MULTI_TOL and ef_ <= MULTI_TOL * fscale,
                  f"K2 disagrees with its plain version: {rec}")
            worst["make_fused_eps_multistep"] = max(
                worst["make_fused_eps_multistep"], em, ef_)

        x = mu_t + eps_t @ f_t.T
        v_k = fs.gaussian_score(x, *params)
        v_p = fs.gaussian_score_reference(x, *params)
        torch.cuda.synchronize()
        vscale = float(v_p.abs().max())
        ev = float((v_k - v_p).abs().max())
        rec = {"kernel": "gaussian_score", "B": b, "D": d, "v_err": ev,
               "v_tol": SCORE_TOL * max(1.0, vscale)}
        emit({"phase": "kernels", **rec})
        check(ev <= SCORE_TOL * max(1.0, vscale),
              f"K3 disagrees with its plain version: {rec}")
        worst["gaussian_score"] = max(worst["gaussian_score"], ev)
    return worst


BAM_RAGGED = (12, 200)
_SHORT_ITERS = (2, 2, 2, 2, 2)


def bam_k7_cases(np, shapes=None):
    """K7 inputs (numpy float32) and the flags (keep, stiff) each is built
    to give: [(name, b, d, (eps, v, mu, f), reg, gate overrides, flags)]."""
    cases = []
    for b, d in shapes or ((B, D), BAM_RAGGED):
        def inputs(seed, score_scale=1.0, v_scale=None):
            rng = np.random.default_rng(seed)
            e = rng.standard_normal((b, d)).astype(np.float32)
            f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))
                 ).astype(np.float32)
            mu = rng.standard_normal(d).astype(np.float32)
            v = score_scale * -(mu + e @ f.T - rng.standard_normal(d))
            if v_scale is not None:
                v = v_scale * rng.standard_normal((b, d))
            return e, v.astype(np.float32), mu, f

        opened = {"lmax_gate": float("inf"), "gu_gate": float("inf")}
        cases += [
            ("benign", b, d, inputs(b + d, v_scale=0.05), 0.5, {},
             (True, False)),
            # lmax(G) over its gate.
            ("stiff_lmax", b, d, inputs(b + d + 1, 300.0), 20.0, {},
             (False, True)),
            # gu over its gate with a benign Y.
            ("stiff_gu", b, d, inputs(b + d + 2, v_scale=0.02), 1e4,
             {"lmax_gate": float("inf")}, (False, True)),
            # Gates opened: the cu chain cannot converge; residual reject.
            ("reject", b, d, inputs(b + d + 3), 3e5, opened, (False, False)),
        ]
    return cases


def bam_k8_cases(np, b, d, spc):
    """K8 cases on a benign target (identity covariance):
    [(name, regs, nmax, stop_on_reject, iters or None, (n_done, n_acc,
    stopped))] and the (mean_t, prec) arrays."""
    mean_t = np.linspace(-1.0, 1.0, d).astype(np.float32)
    prec = np.eye(d, dtype=np.float32)
    late = [0.05] * spc
    stiff = [0.05] * spc
    stiff[3] = 1e9
    rej = [1e-4] * spc
    rej[2] = 2.0
    cases = [
        ("full", late, spc, 0, None, (spc, spc, 0)),
        ("nmax_lt_spc", late, 3, 0, None, (3, 3, 0)),
        ("stiff_stop", stiff, spc, 0, None, (3, 3, 1)),
        ("reject_consumed", rej, spc, 0, _SHORT_ITERS, (spc, spc - 1, 0)),
        ("stop_on_reject", rej, spc, 1, _SHORT_ITERS, (2, 2, 2)),
    ]
    return cases, mean_t, prec


def _bam_close(got, want, tol):
    """max |got - want| and its bound tol * max(1, max |want|)."""
    err = float((got - want).abs().max())
    return err, tol * max(1.0, float(want.abs().max()))


def phase_bam_kernels(bf, fs, torch, np, shapes=None, designed=True,
                      phase="bam_kernels"):
    """K7 and K8 against their plain versions on the same CUDA tensors at
    ``shapes`` (default: the main path's and a ragged one).  Flags and
    counts must equal the plain version's and, with ``designed``, those
    each case is built to give."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = {"bam_eps_update_fused": 0.0, "make_fused_bam_multistep": 0.0}
    shapes = shapes or ((B, D), BAM_RAGGED)
    for name, b, d, arrays, reg, gates, flags in bam_k7_cases(np, shapes):
        e, v, mu, f = (cu(x) for x in arrays)
        for with_ef in (False, True):
            ef = e @ f.T if with_ef else None
            k = bf.bam_eps_update_fused(e, v, mu, f, reg, ef=ef, **gates)
            p = bf.bam_eps_update_ns_reference(e, v, mu, f, reg, ef=ef,
                                               **gates)
            torch.cuda.synchronize()
            em, tm = _bam_close(k[0], p[0], BAM_TOL)
            ef_, tf = _bam_close(k[1], p[1], BAM_TOL)
            ns_k, ns_p = k[4].tolist(), p[4].tolist()
            rec = {"kernel": "bam_eps_update_fused", "case": name, "B": b,
                   "D": d, "with_ef": with_ef,
                   "keep": [bool(k[2]), bool(p[2])],
                   "stiff": [bool(k[3]), bool(p[3])],
                   "ns_stats": [ns_k, ns_p], "mean_err": em, "mean_tol": tm,
                   "f_err": ef_, "f_tol": tf, "designed": flags}
            emit({"phase": phase, **rec})
            check((bool(k[2]), bool(k[3])) == (bool(p[2]), bool(p[3])),
                  f"K7 flags {rec}")
            check(not designed or (bool(p[2]), bool(p[3])) == flags,
                  f"K7 flags {rec}")
            check(np.allclose(ns_k, ns_p, rtol=BAM_STATS_RTOL, atol=0),
                  f"K7 stats {rec}")
            check(em <= tm and ef_ <= tf,
                  f"K7 disagrees with its plain version: {rec}")
            if not k[2]:
                check(torch.equal(k[0], mu) and torch.equal(k[1], f),
                      "K7 must return the old state unless it keeps")
            worst["bam_eps_update_fused"] = max(
                worst["bam_eps_update_fused"], em, ef_)

    spc = 8
    for b, d in shapes:
        cases, mean_t, prec = bam_k8_cases(np, b, d, spc)
        params = (cu(mean_t[None]), cu(prec))
        rng = np.random.default_rng(2000 + d)
        block = cu(rng.standard_normal((spc * b, d)).astype(np.float32))
        mean0 = torch.zeros(d, device=dev)
        f0 = torch.eye(d, device=dev)
        for name, regs, nmax, sor, iters, counts in cases:
            kw = {} if iters is None else {"iters": iters}
            step = bf.make_fused_bam_multistep(fs.gaussian_score, 2, b, d,
                                               spc, **kw)
            k = step(regs, nmax, sor, block, mean0, f0, *params)
            p = bf.bam_multistep_reference(
                fs.gaussian_score_reference, params, regs, nmax, sor, block,
                mean0, f0, batch=b, **kw)
            torch.cuda.synchronize()
            em, tm = _bam_close(k[0], p[0], BAM_MULTI_TOL)
            ef_, tf = _bam_close(k[1], p[1], BAM_MULTI_TOL)
            ck = [int(x) for x in k[2:5]]
            cp = [int(x) for x in p[2:5]]
            ns_k, ns_p = k[5].tolist(), p[5].tolist()
            rec = {"kernel": "make_fused_bam_multistep", "case": name,
                   "B": b, "D": d, "spc": spc, "nmax": nmax,
                   "stop_on_reject": sor, "done_acc_stopped": [ck, cp],
                   "ns_stats": [ns_k, ns_p], "mean_err": em, "mean_tol": tm,
                   "f_err": ef_, "f_tol": tf, "designed": counts}
            emit({"phase": phase, **rec})
            check(tuple(ck) == tuple(cp), f"K8 counts {rec}")
            check(not designed or tuple(cp) == counts, f"K8 counts {rec}")
            check(np.allclose(ns_k, ns_p, rtol=BAM_STATS_RTOL, atol=0),
                  f"K8 stats {rec}")
            check(em <= tm and ef_ <= tf,
                  f"K8 disagrees with its plain version: {rec}")
            worst["make_fused_bam_multistep"] = max(
                worst["make_fused_bam_multistep"], em, ef_)
    return worst


BAM_SMALL_SHAPES = ((B, D), BAM_RAGGED, (2, 10), (56, 257))


def phase_bam_smallspace(bf, torch, np):
    """The BaM cluster small space alone (``bam_smallspace``) against
    ``bam_smallspace_stacks_reference`` on the K7 cases at
    BAM_SMALL_SHAPES: the flags (res_ok, stiff) equal, the gate statistics
    within BAM_STATS_RTOL, and where the plain update is good and not stiff
    the stacked rows, ``vec`` and the trace sums within BAM_TOL of
    max(1, scale)."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = 0.0
    for name, b, d, arrays, reg, gates, _ in bam_k7_cases(np,
                                                          BAM_SMALL_SHAPES):
        e, v, mu, f = (cu(x) for x in arrays)
        vf = v @ f
        rows = (e, v, vf, vf @ f.T, e @ f.T)
        k = bf.bam_smallspace(*rows, mu, reg, **gates)
        p = bf.bam_smallspace_stacks_reference(*rows, mu, reg, batch=b,
                                               **gates)
        torch.cuda.synchronize()
        flags = [k[3][2:4].tolist(), p[3][2:4].tolist()]
        rec = {"kernel": "bam_smallspace", "case": name, "B": b, "D": d,
               "res_ok_stiff": flags, "ss": [k[3].tolist(), p[3].tolist()]}
        check(flags[0] == flags[1], f"BaM small space flags {rec}")
        check(np.allclose(k[3][:2].tolist(), p[3][:2].tolist(),
                          rtol=BAM_STATS_RTOL, atol=0),
              f"BaM small space stats {rec}")
        if flags[1] == [1.0, 0.0]:
            errs_tols = [_bam_close(x, y, BAM_TOL) for x, y in
                         zip((k[0], k[1], k[2], k[3][4:]),
                             (p[0], p[1], p[2], p[3][4:]))]
            rec["errs_tols"] = errs_tols
            check(all(err <= tol for err, tol in errs_tols),
                  f"BaM small space disagrees with its plain version: {rec}")
            worst = max([worst] + [err for err, _ in errs_tols])
        emit({"phase": "bam_smallspace", **rec})
    return {"bam_smallspace": worst}


def phase_times(fs, dense_gaussian, torch, np):
    """Per-call times at the main path's shapes, kernel vs plain version
    (CUDA events; launches here are not counted toward the main path)."""
    dev = torch.device("cuda")
    t = dense_gaussian(TARGET_SEED, D, device=dev)
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(7)
    eps = torch.randn((B, D), generator=gen, device=dev)
    f = torch.eye(D, device=dev)
    mean = torch.zeros(D, device=dev)
    ef = eps @ f.T
    v = t.lp_g(mean + ef)
    spc = 8
    block = torch.randn((spc * B, D), generator=gen, device=dev)
    step = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)
    x = mean + ef
    vf = v @ f
    vft = vf @ f.T
    small = lambda: fs.eps_smallspace(eps, v, vf, vft, ef, mean)
    small_plain = lambda: fs.eps_smallspace_stacks_reference(
        eps, v, vf, vft, ef, mean[None], batch=B)
    thin = lambda: fs.thin_product(vf, f, trans=True)
    thin_plain = lambda: vf @ f.T
    times = {
        "gsm_eps_update_fused": (
            cuda_ms(lambda: fs.gsm_eps_update_fused(eps, v, mean, f, ef=ef)),
            cuda_ms(lambda: fs.gsm_eps_update_ns_reference(eps, v, mean, f,
                                                           ef_t=ef))),
        "eps_smallspace": (cuda_ms(small), cuda_ms(small_plain)),
        "thin_product": (cuda_ms(thin, reps=200),
                         cuda_ms(thin_plain, reps=200)),
        "make_fused_eps_multistep": (
            cuda_ms(lambda: step(spc, block, mean, f, *params), reps=20),
            cuda_ms(lambda: fs.eps_multistep_reference(
                fs.gaussian_score_reference, params, spc, block, mean, f,
                batch=B), reps=20)),
        "gaussian_score": (
            cuda_ms(lambda: fs.gaussian_score(x, *params), reps=200),
            cuda_ms(lambda: fs.gaussian_score_reference(x, *params),
                    reps=200)),
    }
    ref = fs.gaussian_score_reference
    work = {
        "gsm_eps_update_fused": (
            lambda: fs.gsm_eps_update_ns_reference(eps, v, mean, f, ef_t=ef),
            (eps, v, mean, f, ef)),
        "make_fused_eps_multistep": (
            lambda: fs.eps_multistep_reference(ref, params, spc, block, mean,
                                               f, batch=B),
            (block, mean, f, *params)),
        "gaussian_score": (lambda: ref(x, *params), (x, *params)),
        "eps_smallspace": (small_plain, (eps, v, vf, vft, ef, mean)),
        "thin_product": (thin_plain, (vf, f)),
    }
    # K3's one-call yardstick: addmm with the row mu_t @ prec formed ahead;
    # the thin product's: mm.
    mp = params[0] @ params[1]
    lib_fns = {"gaussian_score": lambda: torch.addmm(mp, x, params[1],
                                                     alpha=-1.0),
               "thin_product": lambda: torch.mm(vf, f.T)}
    library = {k: cuda_ms(fn, reps=200) for k, fn in lib_fns.items()}
    # Device time (torch.profiler) of K1, its two kernels, K2 and K3, and of
    # the library calls; the kernels each ran, by name.
    dev_fns = {
        "gsm_eps_update_fused": lambda: fs.gsm_eps_update_fused(
            eps, v, mean, f, ef=ef),
        "eps_smallspace": small, "thin_product": thin,
        "make_fused_eps_multistep": lambda: step(spc, block, mean, f,
                                                 *params),
        "gaussian_score": lambda: fs.gaussian_score(x, *params)}
    device = {k: device_ms(fn, calls=20 if k.startswith("make") else 50)
              for k, fn in dev_fns.items()}
    library_device = {k: device_ms(fn)[0] for k, fn in lib_fns.items()}
    names = {k: n for k, (_, n) in device.items()}
    # K2 per call as one graph replay (``ms``) and on eager blocks.
    eager = lambda: step(spc, block, mean, f, *params, graph=False)
    k2_eager = {"ms_eager": cuda_ms(eager, reps=20),
                "device_ms_eager": device_ms(eager, calls=20)[0]}
    emit({"phase": "times", "B": B, "D": D, "ms_per_call": {
        k: {"kernel": a, "plain": b, "library": library.get(k),
            "device": device[k][0] if k in device else None,
            "library_device": library_device.get(k)}
        for k, (a, b) in times.items()}, "device_kernels": names,
        "make_fused_eps_multistep_eager": k2_eager})
    # The main path's K1 runs the cluster small space, the thin product and
    # the float32 fat apply (apply_f32.cu), never the 32x32 template; K3
    # runs the thin product alone.
    k1 = " ".join(names["gsm_eps_update_fused"])
    check("eps_cluster_kernel" in k1 and "thin_kernel" in k1
          and "apply_f32_kernel" in k1 and "gemm_kernel" not in k1
          and "eps_smallspace_kernel" not in k1,
          f"K1 runs other kernels: {names['gsm_eps_update_fused']}")
    k3 = " ".join(names["gaussian_score"])
    check("thin_kernel" in k3 and "gemm_kernel" not in k3,
          f"K3 runs other kernels: {names['gaussian_score']}")
    return times, work, library, {k: ms for k, (ms, _) in device.items()}, \
        library_device, {"make_fused_eps_multistep": k2_eager}


def phase_bam_paths(BaM, FactorBaM, Regularizers, bf, fs, t, torch):
    """Phases 5 and 6: BaM.fit on the K7 path and FactorBaM(fused_score) on
    the K8 + K3 path at D=256, B=32; then K8 blocks against the plain
    version on the same blocks from the converged state."""
    dev = torch.device("cuda")
    regf = Regularizers().linear(BAM_REGF0)

    fs.reset_launch_counts()
    g = BaM(D, t.lp, t.lp_g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, cov = g.fit(FIT_SEED, regf, batch_size=B, niter=N_BAM,
                      verbose=False, retries=0)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    c5 = fs.launch_counts()
    fc5 = dict(g._get_factor_fitter().fit_counts)
    em5, ec5 = errs(mean, cov, t)
    emit({"phase": "bam_main_path", "fitter": "BaM", "D": D, "B": B,
          "niter": N_BAM, "regf": f"linear({BAM_REGF0})", "retries": 0,
          "k7_launches": c5["bam_eps_update_fused"], "fit_counts": fc5,
          "mean_err": em5, "cov_err": ec5,
          "mean_err_bound": BAM_MEAN_ERR_BOUND,
          "cov_err_bound": BAM_COV_ERR_BOUND,
          "iters_per_s": (N_BAM + 1) / wall5})
    check(g._factor_route() and g._get_factor_fitter()._fused_mode(B)
          == "update", "BaM on CUDA must run the factor route's K7 mode")
    check(c5["bam_eps_update_fused"] == N_BAM + 1
          and fc5["report_reads"] == N_BAM + 1,
          "K7 must launch once per step, with one report read per step")
    check(c5["make_fused_bam_multistep"] == 0, "K8 launched in BaM.fit")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
          and tuple(cov.shape) == (D, D), "BaM.fit output shape/finiteness")
    check(em5 < BAM_MEAN_ERR_BOUND and ec5 < BAM_COV_ERR_BOUND,
          "BaM.fit did not converge under the BaM bound")

    fb = FactorBaM(D, t.lp, t.lp_g, fused_score=t.fused_score, device=dev)
    check(fb._fused_mode(B) == "step" and fb.steps_per_call == 8,
          "BaM headline path must run the whole-step kernel at spc=8")
    fs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st6 = fb.fit(FIT_SEED, regf, batch_size=B, niter=N_BAM, verbose=False,
                 retries=0, return_state=True)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    c6 = fs.launch_counts()
    fc6 = dict(fb.fit_counts)
    em6, ec6 = errs(st6.mean, st6.cov, t)
    emit({"phase": "bam_headline_path", "fitter": "FactorBaM(fused_score)",
          "D": D, "B": B, "niter": N_BAM, "spc": fb.steps_per_call,
          "launches": c6, "fit_counts": fc6,
          "n_accepted": int(st6.n_accepted), "ns_stats": list(st6.ns_stats),
          "mean_err": em6, "cov_err": ec6,
          "iters_per_s": (N_BAM + 1) / wall6})
    check(c6["make_fused_bam_multistep"] > 0 and c6["gaussian_score"] > 0,
          "K8/K3 not launched")
    check(c6["bam_eps_update_fused"] == 0, "K7 launched in the K8 path")
    check(bool(torch.isfinite(st6.mean).all()
               and torch.isfinite(st6.cov).all()), "FactorBaM not finite")
    check(em6 < BAM_MEAN_ERR_BOUND and ec6 < BAM_COV_ERR_BOUND,
          "FactorBaM(fused_score) did not converge under the BaM bound")

    # it/s of K8 vs its plain version on the same blocks, from the converged
    # state, on the tier the fitter's carried stats pick there.
    score_fn, params = t.fused_score
    tiers = fb._ns_tiers()
    it, gg, lm = tiers[bf.ns_tier_from_stats(*st6.ns_stats, tiers)]
    spc, nblk = fb.steps_per_call, 20
    gen = torch.Generator(device=dev).manual_seed(12)
    blocks = [torch.randn((spc * B, D), generator=gen, device=dev)
              for _ in range(nblk)]
    regs = [regf(N_BAM + j) for j in range(spc)]
    multi = bf.make_fused_bam_multistep(score_fn, len(params), B, D, spc,
                                        iters=it, lmax_gate=lm, gu_gate=gg)

    def run_blocks(fn):
        m, f = st6.mean, st6.factor
        done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks:
            m, f, n_done = fn(blk, m, f)[:3]
            done += int(n_done)
        torch.cuda.synchronize()
        return done / (time.perf_counter() - t0), done

    kern = lambda blk, m, f: multi(regs, spc, 0, blk, m, f, *params)
    plain = lambda blk, m, f: bf.bam_multistep_reference(
        fs.gaussian_score_reference, params, regs, spc, 0, blk, m, f,
        batch=B, iters=it, lmax_gate=lm, gu_gate=gg)
    rates = [run_blocks(kern), run_blocks(plain), run_blocks(plain),
             run_blocks(kern)]
    emit({"phase": "bam_rates", "D": D, "B": B, "spc": spc, "tier_iters": it,
          "fit_iters_per_s": (N_BAM + 1) / wall6,
          "kernel_iters_per_s": [rates[0][0], rates[3][0]],
          "plain_iters_per_s": [rates[1][0], rates[2][0]],
          "steps_done": [r[1] for r in rates]})
    return (c5, c6), st6, fb, (mean, cov)


def phase_bam_times(bf, fs, fb, t, st, torch):
    """Per-call times of K7 and K8 (spc=8) at D=256, B=32 from the converged
    BaM state, kernel vs plain version, at the long profile (tier 0, the
    kernels' default) and at the most benign tier (CUDA events)."""
    dev = torch.device("cuda")
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(13)
    eps = torch.randn((B, D), generator=gen, device=dev)
    ef = eps @ st.factor.T
    v = t.lp_g(st.mean + ef)
    spc = fb.steps_per_call
    block = torch.randn((spc * B, D), generator=gen, device=dev)
    reg = BAM_REGF0 / (N_BAM + 1.0)
    regs = [reg] * spc
    vf = v @ st.factor
    rows = (eps, v, vf, vf @ st.factor.T, ef)
    out, dev_ms, names = {}, {}, {}
    for label, (it, gg, lm) in (("tier0", bf.BAM_NS_TIERS[0]),
                                ("tier3", bf.BAM_NS_TIERS[-1])):
        kw = dict(iters=it, lmax_gate=lm, gu_gate=gg)
        multi = bf.make_fused_bam_multistep(score_fn, len(params), B, D, spc,
                                            **kw)
        fns = {
            "bam_eps_update_fused": lambda: bf.bam_eps_update_fused(
                eps, v, st.mean, st.factor, reg, ef=ef, **kw),
            "make_fused_bam_multistep": lambda: multi(
                regs, spc, 0, block, st.mean, st.factor, *params),
            "bam_smallspace": lambda: bf.bam_smallspace(*rows, st.mean, reg,
                                                        **kw)}
        out[label] = {
            "bam_eps_update_fused": (
                cuda_ms(fns["bam_eps_update_fused"], reps=20),
                cuda_ms(lambda: bf.bam_eps_update_ns_reference(
                    eps, v, st.mean, st.factor, reg, ef=ef, **kw), reps=20)),
            "make_fused_bam_multistep": (
                cuda_ms(fns["make_fused_bam_multistep"], reps=10),
                cuda_ms(lambda: bf.bam_multistep_reference(
                    fs.gaussian_score_reference, params, regs, spc, 0, block,
                    st.mean, st.factor, batch=B, **kw), reps=10)),
            "bam_smallspace": (
                cuda_ms(fns["bam_smallspace"], reps=50),
                cuda_ms(lambda: bf.bam_smallspace_stacks_reference(
                    *rows, st.mean, reg, batch=B, **kw), reps=20)),
        }
        # Device time per call (torch.profiler) and the kernels each ran.
        for k, fn in fns.items():
            ms, kn = device_ms(fn, calls=10 if k.startswith("make") else 30)
            dev_ms[(k, label)], names[(k, label)] = ms, kn
    emit({"phase": "bam_times", "B": B, "D": D, "spc": spc, "ms_per_call": {
        label: {k: {"kernel": a, "plain": b, "device": dev_ms[(k, label)]}
                for k, (a, b) in tt.items()}
        for label, tt in out.items()},
        "device_kernels": {f"{k} {label}": n for (k, label), n in
                           names.items()}})
    # K7 and K8 at B <= 56 run the cluster small space, every row product
    # on the thin product and the fat apply on apply_f32_kernel: never the
    # 32x32 template, never a one-block small space.
    for (k, label), kn in names.items():
        joined = " ".join(kn)
        check("bam_cluster_kernel" in joined
              and "bam_smallspace_kernel" not in joined
              and "gemm_kernel" not in joined
              and (k == "bam_smallspace"
                   or ("thin_kernel" in joined
                       and "apply_f32_kernel" in joined)),
              f"{k} ({label}) runs other kernels: {kn}")
    it, gg, lm = bf.BAM_NS_TIERS[0]
    kw = dict(iters=it, lmax_gate=lm, gu_gate=gg)
    work = {
        "bam_eps_update_fused": (
            lambda: bf.bam_eps_update_ns_reference(
                eps, v, st.mean, st.factor, reg, ef=ef, **kw),
            (eps, v, st.mean, st.factor, ef)),
        "make_fused_bam_multistep": (
            lambda: bf.bam_multistep_reference(
                fs.gaussian_score_reference, params, regs, spc, 0, block,
                st.mean, st.factor, batch=B, **kw),
            (block, st.mean, st.factor, *params)),
        "bam_smallspace": (
            lambda: bf.bam_smallspace_stacks_reference(
                *rows, st.mean, reg, batch=B, **kw), (*rows, st.mean)),
    }
    device = {k: dev_ms[(k, "tier0")] for k in out["tier0"]}
    tier3 = {k: {"device_ms_tier3": dev_ms[(k, "tier3")],
                 "ms_tier3": out["tier3"][k][0]} for k in out["tier3"]}
    return out["tier0"], work, device, tier3


def _advi_problem(np, b, d, spc, seed):
    """K9/K10 inputs at (b, d): a benign Gaussian target's score params, a
    start state near the identity with its exact inverse, and an eps block
    (numpy float32)."""
    rng = np.random.default_rng(seed)
    mean_t = np.linspace(-1.0, 1.0, d).astype(np.float32)[None]
    prec = np.eye(d, dtype=np.float32)
    loc = (0.1 * rng.standard_normal(d)).astype(np.float32)
    l = np.tril(np.eye(d) + 0.02 * rng.standard_normal((d, d)))
    ainv = np.tril(np.linalg.inv(l)).astype(np.float32)
    block = rng.standard_normal((spc * b, d)).astype(np.float32)
    return (mean_t, prec), loc, l.astype(np.float32), ainv, block


def advi_cases(np, spc):
    """[(kernel, name, nmax, lrs, warm moments, poisoned sub-step,
    (n_done, stiff) or None)].  The lrs keep K10's tracking residual
    (about D * lr per row on a factor near I) under its gate except where
    a case trips it: a step of 0.05 at sub-step 2 stops the block at 3."""
    base = [1e-3] * spc
    sched = [1e-3 * (1 + (j % 3)) for j in range(spc)]
    trip = list(base)
    trip[2] = 0.05
    return [
        ("k9", "first_step_grad", 1, base, False, None, None),
        ("k9", "full", spc, [1e-2] * spc, False, None, None),
        ("k9", "nmax_lt_spc", 3, [1e-2] * spc, False, None, None),
        ("k9", "lr_schedule", spc, [2e-2, 1e-2, 5e-3, 2e-2, 1e-2, 5e-3,
                                    2e-2, 1e-2][:spc], True, None, None),
        ("k10", "first_step_grad", 1, base, False, None, (1, 0)),
        ("k10", "full", spc, base, False, None, (spc, 0)),
        ("k10", "nmax_lt_spc", 3, base, False, None, (3, 0)),
        ("k10", "lr_schedule", spc, sched, True, None, (spc, 0)),
        ("k10", "gate_trip_at_3", spc, trip, False, None, (3, 1)),
        ("k10", "nonfinite_gradient", spc, base, False, 2, (2, 1)),
    ]


def phase_advi_kernels(af, fs, torch, np, shapes=None, designed=True,
                       phase="advi_kernels"):
    """K9 and K10 against their plain versions on the same CUDA tensors at
    ``shapes`` (default: the main path's and a ragged one); above D=256 the
    cases' learning rates scale by 256/D, which keeps K10's tracking
    residual (about D * lr per row) where the cases put it.  (n_done,
    stiff) must equal the plain version's and, with ``designed``, what each
    case is built to give."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = {"make_fused_advi_multistep": 0.0,
             "make_fused_advi_stl_multistep": 0.0}
    spc = 8
    for b, d in shapes or ((B, D), ADVI_RAGGED):
        (mean_t, prec), loc, l, ainv, block = _advi_problem(np, b, d, spc,
                                                            3000 + d)
        params = (cu(mean_t), cu(prec))
        k9 = af.make_fused_advi_multistep(fs.gaussian_score, 2, b, d, spc)
        k10 = af.make_fused_advi_stl_multistep(fs.gaussian_score, 2, b, d,
                                               spc)
        for kern, name, nmax, lrs, warm, poison, counts in advi_cases(np,
                                                                      spc):
            lrs = [lr * min(1.0, D / d) for lr in lrs]
            rng = np.random.default_rng(d + nmax)
            z = np.zeros(d, np.float32)
            zz = np.zeros((d, d), np.float32)
            moments = ([0.1 * rng.standard_normal(d), 0.01 + rng.random(d),
                        np.tril(0.1 * rng.standard_normal((d, d))),
                        np.tril(0.01 + rng.random((d, d)))] if warm
                       else [z, z, zz, zz])
            moments = [cu(np.asarray(m, np.float32)) for m in moments]
            blk = block.copy()
            if poison is not None:
                blk[poison * b:(poison + 1) * b] = 1e30
            # Bias corrections of the first steps (zero moments) or of
            # steps 100.. (warm moments).
            step0 = 100 if warm else 0
            _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
                lambda s: 0.0, 0.9, 0.999,
                torch.arange(step0, step0 + spc, dtype=torch.int32)))
            if kern == "k9":
                state = [cu(loc), cu(l), *moments]
                got = advi_graph_block(k9, (lrs, bc1s, bc2s, nmax, cu(blk),
                                            *state, *params), torch)
                want = af.advi_multistep_reference(
                    fs.gaussian_score_reference, params, lrs, bc1s, bc2s,
                    nmax, cu(blk), *state, batch=b)
                names = ("loc", "l", "mloc", "vloc", "ml", "vl")
                flags = None
            else:
                state = [cu(loc), cu(l), cu(ainv), *moments]
                *got, rep = advi_graph_block(k10, (lrs, bc1s, bc2s, nmax,
                                                   cu(blk), *state, *params),
                                             torch)
                nd_k, st_k = rep[af.REP_NDONE], rep[af.REP_STIFF]
                *want, nd_p, st_p = af.advi_stl_multistep_reference(
                    fs.gaussian_score_reference, params, lrs, bc1s, bc2s,
                    nmax, cu(blk), *state, batch=b)
                names = ("loc", "l", "ainv", "mloc", "vloc", "ml", "vl")
                flags = [(int(nd_k), int(st_k)), (int(nd_p), int(st_p))]
            torch.cuda.synchronize()
            key = ("make_fused_advi_multistep" if kern == "k9"
                   else "make_fused_advi_stl_multistep")
            rec = {"kernel": key, "case": name, "B": b, "D": d, "spc": spc,
                   "nmax": nmax, "done_stiff": flags}
            bound = 2.0 * sum(lrs[:nmax])
            # The gradients sum B rows: their rounding grows as sqrt(B).
            rtol = ADVI_RTOL * max(1.0, (b / B) ** 0.5)
            for nm, g, w in zip(names, got, want):
                diff = (g - w).abs()
                frac = float((diff <= rtol * w.abs().clamp(min=1.0))
                             .double().mean())
                rec[nm] = {"max_abs_err": float(diff.max()), "frac": frac}
                check(bool(torch.isfinite(g).all()), f"{key} {name}: {nm} "
                      "not finite")
                check(frac >= ADVI_FRAC, f"{key} {name}: {nm} {rec[nm]}")
                if nm in ("loc", "l"):
                    check(float(diff.max()) <= bound,
                          f"{key} {name}: {nm} beyond 2 sum(lr) {rec[nm]}")
                    worst[key] = max(worst[key], float(diff.max()))
            if name == "first_step_grad":
                # Zero moments: m = (1 - b1) g after one step.
                for nm in ("mloc", "ml"):
                    g, w = got[names.index(nm)], want[names.index(nm)]
                    err = float((g - w).abs().max())
                    tol = ADVI_GRAD_TOL * max(1.0, float(w.abs().max()))
                    rec[nm]["grad_tol"] = tol
                    check(err <= tol, f"{key} first-step gradient {nm}: "
                          f"{err} > {tol}")
            emit({"phase": phase, **rec})
            if flags is not None:
                check(flags[0] == flags[1] and (not designed
                                                or flags[1] == counts),
                      f"{key} {name}: (n_done, stiff) {flags} != {counts}")
    return worst


def advi_graph_block(step, args, torch):
    """A K9/K10 block (``AdviBlocks``, ``step.packed(*args)``) that, when
    full, is held to the graph: the call that captures and the replay after
    it both equal the same block enqueued eagerly (``graph=False``) bit for
    bit, K10's report included.  Returns the replayed (or, for nmax < spc,
    the eager) result."""
    eager = step.packed(*args, graph=False)
    if args[3] < step.spc:
        return eager
    outs = [step.packed(*args) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for out in outs for x, y in zip(out, eager)),
          f"a K{10 if step.stl else 9} graph block differs from the eager "
          f"block (B={step.batch}, D={step.d})")
    check(step.captures >= 1, "no CUDA graph was captured")
    return outs[1]


def advi_flops(b: int, d: int, nsub: int, stl: bool,
               sweeps: int = 2) -> int:
    """The FLOPs ``nsub`` K9 (K10) sub-steps need on a lower-triangular L
    and A, with the dense Gaussian score (2 B D^2): x = loc + e L^T and
    dL's lower triangle (B D (D + 1) each), for K10 also P = E A' and the
    2 ``sweeps`` triangular (D, D, D) products (D (D + 1) (D + 2) / 3
    each); not the full products' 2 B D^2 and 2 D^3 that the plain version
    forms."""
    per = 2 * b * d * (d + 1) + 2 * b * d * d
    if stl:
        per += b * d * (d + 1) + 2 * sweeps * d * (d + 1) * (d + 2) // 3
    return nsub * per


# Host calls a full ADVI block may make besides its one graph launch: its
# spc draws' launches and the scalar table's copy (K10: and the report's
# read); a chunk's two state copies, in and out, spread over its blocks.
ADVI_CHUNK_BLOCKS = 64


def advi_graph_report(gf, est, lr, state, torch) -> dict:
    """Phase 9: the runner of ``fit_fused(estimator=est)`` from ``state``:
    its captures, host and wall us per block on graph and eager blocks
    (one chunk of ADVI_CHUNK_BLOCKS blocks), the runtime calls and device
    kernels per block under ``torch.profiler``, and the device allocations
    per block (two chunks, their difference over the extra blocks).  Fails
    unless a full block is one graph launch (K9: every block), the host's
    other calls are at most the draws, the table's copy, K10's report read
    and the chunk's state copies, and a K9 block allocates nothing (K10:
    none without a replay)."""
    from torch.autograd import DeviceType

    from tools.profile_gpu import profile_window

    runner = gf._fused_runner(B, lr, 0.9, 0.999, 1e-8, est)
    spc, nb = gf.steps_per_call, ADVI_CHUNK_BLOCKS
    rec = {"captures": runner.blocks.captures, "chunk_blocks": nb}
    for graph in (True, False):
        gf.cuda_graph = graph
        runner(state, 2 * spc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(state, nb * spc)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec["graph" if graph else "eager"] = {
            "host_us_per_block": 1e6 * (t1 - t0) / nb,
            "wall_us_per_block": 1e6 * (t2 - t0) / nb}
    gf.cuda_graph = True
    allocs = []
    for n in (nb, 2 * nb):
        gf._reset_counts()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        runner(state, n * spc)
        torch.cuda.synchronize()
        allocs.append(torch.cuda.memory_stats()["allocation.all.allocated"]
                      - before)
    replays = gf.fit_counts["replays"]
    rec["allocations_per_block"] = (allocs[1] - allocs[0]) / nb

    def window():
        gf._reset_counts()
        runner(state, nb * spc)
        torch.cuda.synchronize()

    prof = profile_window(window)[0]
    api, kernels = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
        elif e.name.startswith("cuda") and e.name != "cudaDeviceSynchronize":
            api[e.name] = api.get(e.name, 0) + 1
    blocks = gf.fit_counts["kernel_calls"]
    rec["per_block"] = {"api": {k: v / blocks for k, v in sorted(api.items())},
                        "kernel_nodes": kernels / blocks, "blocks": blocks,
                        "replays": gf.fit_counts["replays"]}
    launches = sum(v for k, v in api.items()
                   if k.startswith("cudaLaunchKernel"))
    copies = api.get("cudaMemcpyAsync", 0)
    graphs = api.get("cudaGraphLaunch", 0)
    stl = est == "stl"
    n_state = 7 if stl else 6
    check(graphs <= blocks and (graphs == blocks if not stl
                                else graphs >= blocks - 1
                                - 2 * gf.fit_counts["replays"]),
          f"ADVI {est}: a full block must be one graph launch: {rec}")
    check(launches <= spc * blocks + (
        0 if not stl else 16 * gf.fit_counts["replays"] + spc)
        and copies <= (2 if stl else 1) * blocks + 2 * n_state + 2
        + 8 * gf.fit_counts["replays"],
          f"ADVI {est}: the host issues more than the draws, the scalar "
          f"copy and the report read per block: {rec}")
    check(rec["allocations_per_block"] == 0 or (stl and replays),
          f"ADVI {est}: a block allocates on the device: {rec}")
    return rec


def _errs_bounded(em, ec, bounds, what):
    check(em < bounds[0] and ec < bounds[1],
          f"{what}: errors {em}, {ec} not under {bounds}")


def phase_advi_paths(ADVI, Adam, af, fs, t, torch):
    """Phases 8 and 9: ADVI.fit (autograd on the card) and ADVI.fit_fused's
    analytic (K9 + K3) and STL polish (K10) legs at D=256, B=32; then the
    kernels' and plain versions' it/s on the same blocks from each leg's
    final state."""
    dev = torch.device("cuda")
    fs.reset_launch_counts()
    g = ADVI(D, t.lp, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, cov, losses = g.fit(FIT_SEED, Adam(ADVI_LR), batch_size=B,
                              niter=N_ADVI, verbose=False)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    c8 = fs.launch_counts()
    em8, ec8 = errs(mean, cov, t)
    emit({"phase": "advi_main_path", "fitter": "ADVI.fit", "D": D, "B": B,
          "niter": N_ADVI, "lr": ADVI_LR, "launches": c8,
          "losses": [len(losses), float(losses[0]), float(losses[-1])],
          "mean_err": em8, "cov_err": ec8,
          "mean_err_bound": ADVI_MEAN_ERR_BOUND,
          "cov_err_bound": ADVI_COV_ERR_BOUND,
          "iters_per_s": (N_ADVI + 1) / wall8})
    check(len(losses) == N_ADVI + 1
          and bool(torch.isfinite(torch.from_numpy(losses)).all()),
          "ADVI.fit losses: length or finiteness")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
          and tuple(cov.shape) == (D, D), "ADVI.fit output shape/finiteness")
    check(sum(c8.values()) == 0, "ADVI.fit launched a kernel")
    _errs_bounded(em8, ec8, (ADVI_MEAN_ERR_BOUND, ADVI_COV_ERR_BOUND),
                  "ADVI.fit")

    gf = ADVI(D, t.lp, fused_score=t.fused_score, device=dev)
    check(gf.steps_per_call == 8, "ADVI headline path must run spc=8")
    legs = {}
    for leg, est, lr, n in (("analytic", "analytic", ADVI_LR, N_ADVI),
                            ("stl", "stl", STL_LR, N_STL)):
        fs.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = gf.fit_fused(FIT_SEED, learning_rate=lr, batch_size=B,
                             niter=n, verbose=False, return_state=True,
                             estimator=est,
                             state=legs["analytic"][0] if est == "stl"
                             else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = fs.launch_counts()
        em, ec = errs(st.loc, gf.scales_to_cov(st.l), t)
        legs[leg] = (st, c, (n + 1) / wall)
        emit({"phase": "advi_headline_path", "leg": leg,
              "fitter": "ADVI.fit_fused", "estimator": est, "D": D, "B": B,
              "niter": n, "lr": lr, "spc": gf.steps_per_call,
              "launches": c, "fit_counts": dict(gf.fit_counts),
              "step": st.step, "mean_err": em, "cov_err": ec,
              "iters_per_s": (n + 1) / wall})
        check(bool(torch.isfinite(st.loc).all()
                   and torch.isfinite(st.l).all()),
              f"fit_fused {leg} leg not finite")
        check(c["gaussian_score"] > 0, f"K3 not launched in the {leg} leg")
        if est == "analytic":
            check(c["make_fused_advi_multistep"] > 0
                  and c["make_fused_advi_stl_multistep"] == 0,
                  "the analytic leg must launch K9 and not K10")
            _errs_bounded(em, ec, (ADVI_MEAN_ERR_BOUND, ADVI_COV_ERR_BOUND),
                          "fit_fused analytic leg")
        else:
            check(c["make_fused_advi_stl_multistep"] > 0
                  and c["make_fused_advi_multistep"] == 0,
                  "the STL leg must launch K10 and not K9")
            check(gf.fit_counts["report_reads"]
                  == gf.fit_counts["kernel_calls"],
                  "K10: one report read per block")
            _errs_bounded(em, ec, (STL_MEAN_ERR_BOUND, STL_COV_ERR_BOUND),
                          "fit_fused STL leg")

    # Each leg again on eager blocks: the same state bit for bit; then the
    # runner's graph report from the leg's final state.
    for leg, est, lr, n in (("analytic", "analytic", ADVI_LR, N_ADVI),
                            ("stl", "stl", STL_LR, N_STL)):
        gf.cuda_graph = False
        try:
            (st_e, _), wall_e = _timed(lambda: gf.fit_fused(
                FIT_SEED, learning_rate=lr, batch_size=B, niter=n,
                verbose=False, return_state=True, estimator=est,
                state=legs["analytic"][0] if est == "stl" else None), torch)
        finally:
            gf.cuda_graph = True
        st = legs[leg][0]
        same = all(torch.equal(x, y) for x, y in zip(st[:-2], st_e[:-2]))
        check(same and st.step == st_e.step, f"fit_fused {leg}: the fit on "
              "graph blocks differs from the fit on eager blocks")
        emit({"phase": "advi_graph", "leg": leg, "estimator": est,
              "graph_iters_per_s": legs[leg][2],
              "eager_iters_per_s": (n + 1) / wall_e,
              "graph_equals_eager": same,
              **advi_graph_report(gf, est, lr, st, torch)})
    # The two-phase recipe (bench.py:378-461) as one rate.
    two = (N_ADVI + 1 + N_STL + 1) / ((N_ADVI + 1) / legs["analytic"][2]
                                      + (N_STL + 1) / legs["stl"][2])
    emit({"phase": "advi_two_phase", "iters_per_s": two})

    # it/s of each kernel vs its plain version on the same blocks, from the
    # leg's final state at the leg's learning rate.
    score_fn, params = t.fused_score
    ref = fs.gaussian_score_reference
    spc, nblk = gf.steps_per_call, 20
    gen = torch.Generator(device=dev).manual_seed(14)
    blocks = [torch.randn((spc * B, D), generator=gen, device=dev)
              for _ in range(nblk)]
    rates = {}
    for leg, lr in (("analytic", ADVI_LR), ("stl", STL_LR)):
        st = legs[leg][0]
        lrs, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
            lambda s: lr, 0.9, 0.999,
            torch.arange(st.step, st.step + spc, dtype=torch.int32)))
        if leg == "analytic":
            multi = af.make_fused_advi_multistep(score_fn, len(params), B, D,
                                                 spc)
            kern = lambda blk, s: (*multi(lrs, bc1s, bc2s, spc, blk, *s,
                                          *params), spc)
            plain = lambda blk, s: (*af.advi_multistep_reference(
                ref, params, lrs, bc1s, bc2s, spc, blk, *s, batch=B), spc)
            s0 = (st.loc, st.l, st.mloc, st.vloc, st.ml, st.vl)
        else:
            multi = af.make_fused_advi_stl_multistep(score_fn, len(params),
                                                     B, D, spc)
            kern = lambda blk, s: multi(lrs, bc1s, bc2s, spc, blk, *s,
                                        *params)[:-1]
            plain = lambda blk, s: af.advi_stl_multistep_reference(
                ref, params, lrs, bc1s, bc2s, spc, blk, *s, batch=B)[:-1]
            s0 = (st.loc, st.l, st.ainv, st.mloc, st.vloc, st.ml, st.vl)

        def run_blocks(fn):
            s, done = s0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for blk in blocks:
                *s, n_done = fn(blk, s)
                done += int(n_done)
            torch.cuda.synchronize()
            return done / (time.perf_counter() - t0), done

        r = [run_blocks(kern), run_blocks(plain), run_blocks(plain),
             run_blocks(kern)]
        rates[leg] = {"fit_iters_per_s": legs[leg][2],
                      "kernel_iters_per_s": [r[0][0], r[3][0]],
                      "plain_iters_per_s": [r[1][0], r[2][0]],
                      "steps_done": [x[1] for x in r]}
    emit({"phase": "advi_rates", "D": D, "B": B, "spc": spc, **rates})
    return c8, legs["analytic"][1], legs["stl"][1]


def phase_advi_times(af, fs, torch, np):
    """Per-block times of K9 and K10 (spc=8) at D=256, B=32 on a benign
    state, kernel vs plain version, on full blocks chained through the
    working state as the fit runner chains them (``load`` once, then
    ``run`` on the persistent eps block): ``ms`` and ``device_ms`` on the
    graph, ``ms_eager`` and ``device_ms_eager`` on eager blocks (CUDA
    events; ``torch.profiler``).  Returns (times, work with each bound's
    FLOPs counted on lower-triangular L and A, device ms, extra fields)."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    spc = 8
    (mean_t, prec), loc, l, ainv, block = _advi_problem(np, B, D, spc, 77)
    params = (cu(mean_t), cu(prec))
    z, zz = torch.zeros(D, device=dev), torch.zeros((D, D), device=dev)
    # A small rate keeps K10's tracking residual far under its gate over
    # the ~90 chained blocks timed.
    lrs = [1e-4] * spc
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    blk, loc, l, ainv = cu(block), cu(loc), cu(l), cu(ainv)
    ref = fs.gaussian_score_reference
    k9_in = (blk, loc, l, z, z, zz, zz, *params)
    k10_in = (blk, loc, l, ainv, z, z, zz, zz, *params)
    times, device, extra, work = {}, {}, {}, {}
    for name, make, inputs, plain, stl in (
            ("make_fused_advi_multistep", af.make_fused_advi_multistep,
             k9_in, af.advi_multistep_reference, False),
            ("make_fused_advi_stl_multistep",
             af.make_fused_advi_stl_multistep, k10_in,
             af.advi_stl_multistep_reference, True)):
        k = make(fs.gaussian_score, 2, B, D, spc)
        state = inputs[1:-2]
        k.load(*state)
        k.eps_block(dev).copy_(blk)
        run = lambda graph, k=k: k.run(lrs, bc1s, bc2s, spc, *params,
                                       graph=graph)
        run(True)
        if stl:
            n_done = int(k.report()[af.REP_NDONE])
            check(n_done == spc, f"K10 timing block stopped at {n_done}")
        ms = cuda_ms(lambda: run(True), reps=20)
        ms_eager = cuda_ms(lambda: run(False), reps=20)
        dev_ms = device_ms(lambda: run(True), calls=20)[0]
        dev_eager = device_ms(lambda: run(False), calls=20)[0]
        if stl:
            n_done = int(k.report()[af.REP_NDONE])
            check(n_done == spc, f"K10 timing block stopped at {n_done}")
        plain_ms = cuda_ms(lambda: plain(
            ref, params, lrs, bc1s, bc2s, spc, *inputs[:-2], batch=B),
            reps=20)
        times[name] = (ms, plain_ms)
        device[name] = dev_ms
        extra[name] = {"ms_eager": ms_eager, "device_ms_eager": dev_eager,
                       "bound_flops": "lower-triangular L and A"}
        work[name] = (lambda plain=plain, inputs=inputs: plain(
            ref, params, lrs, bc1s, bc2s, spc, *inputs[:-2], batch=B),
            inputs, advi_flops(B, D, spc, stl))
    emit({"phase": "advi_times", "B": B, "D": D, "spc": spc,
          "ms_per_block": {k: {"kernel": a, "plain": b, "device": device[k],
                               **extra[k]} for k, (a, b) in times.items()}})
    return times, work, device, extra


def _dense_inputs(np, b, d, seed, k=None):
    """(samples, vs, mu0, S0) of a dense GSM step (numpy float32), S0
    exactly symmetric; a leading replica axis with ``k``."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    a = rng.standard_normal((*lead, d, d))
    s0 = (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)
    s0 = 0.5 * (s0 + np.swapaxes(s0, -1, -2))
    mu = rng.standard_normal((*lead, d))
    x = mu[..., None, :] + rng.standard_normal((*lead, b, d))
    v = -(x - rng.standard_normal((*lead, 1, d)))
    return [np.ascontiguousarray(z, np.float32) for z in (x, v, mu, s0)]


def phase_dense_kernels(gs, torch, np):
    """Phase 10: K5 against its plain version on the same CUDA tensors."""
    dev = torch.device("cuda")
    cu = lambda z: torch.from_numpy(z).to(dev)
    worst = 0.0
    cases = [(b, d, None) for b, d in DENSE_SHAPES] + [(B, D, 4)]
    for b, d, k in cases:
        x, v, mu, s0 = (cu(z) for z in _dense_inputs(np, b, d, 4000 + b + d,
                                                     k))
        m_k, s_k = gs.gsm_update_fused(x, v, mu, s0)
        m_p, s_p = gs.gsm_update_replicas_reference(x, v, mu, s0)
        torch.cuda.synchronize()
        em, tm = _bam_close(m_k, m_p, DENSE_TOL)
        es, ts = _bam_close(s_k, s_p, DENSE_TOL)
        sym = bool(torch.equal(s_k, s_k.mT))
        rec = {"kernel": "gsm_update_fused", "B": b, "D": d, "K": k,
               "mean_err": em, "mean_tol": tm, "s_err": es, "s_tol": ts,
               "s_symmetric_bitwise": sym}
        if k is not None:
            singles = [gs.gsm_update_fused(x[i], v[i], mu[i], s0[i])
                       for i in range(k)]
            rec["replicas_equal_single_calls"] = all(
                torch.equal(m_k[i], m) and torch.equal(s_k[i], s_)
                for i, (m, s_) in enumerate(singles))
            check(rec["replicas_equal_single_calls"],
                  f"batched K5 differs from its single calls: {rec}")
        emit({"phase": "dense_kernels", **rec})
        check(em <= tm and es <= ts,
              f"K5 disagrees with its plain version: {rec}")
        check(sym, f"K5's S is not symmetric bit for bit: {rec}")
        worst = max(worst, em, es)
    return worst


def _timed(fn, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_vs_eager(fitter, run, st, wall, steps, runner, torch) -> dict:
    """A fit ``run()`` on K2/K6 graph blocks (state ``st`` in ``wall``
    seconds), run again on eager blocks (``cuda_graph=False``): the same
    state bit for bit, both it/s, and ``graph_report`` of its runner."""
    fitter.cuda_graph = False
    try:
        st_e, wall_e = _timed(run, torch)
    finally:
        fitter.cuda_graph = True
    same = bool(torch.equal(st.mean, st_e.mean)
                and torch.equal(st.factor, st_e.factor)
                and torch.equal(st.n_accepted, st_e.n_accepted))
    check(same, "the fit on graph blocks differs from the fit on eager "
          "blocks")
    return {"graph_iters_per_s": steps / wall,
            "eager_iters_per_s": steps / wall_e,
            "graph_equals_eager": same,
            **graph_report(fitter, runner, st, fitter.steps_per_call, torch)}


def phase_dense_paths(GSM, fs, t, torch):
    """Phase 11: the dense route on K5 at B=32 (use_factor=False) and at
    B=512 (the huge-batch guard).  Returns the launch counts and the
    (mean, cov) of the B=32 fit."""
    counts, fits = [], {}
    for label, b, niter, kw, bounds in (
            ("dense", B, N_ITER, {"use_factor": False},
             (MEAN_ERR_BOUND, COV_ERR_BOUND)),
            ("huge_batch", HUGE_B, N_HUGE, {},
             (HUGE_MEAN_ERR_BOUND, HUGE_COV_ERR_BOUND))):
        g = GSM(D, t.lp, t.lp_g, device="cuda", **kw)
        check(not g._factor_route(b) and g._dense_fused(b),
              f"{label}: GSM must run the dense route on K5")
        fs.reset_launch_counts()
        (mean, cov), wall = _timed(lambda: g.fit(
            FIT_SEED, batch_size=b, niter=niter, verbose=False), torch)
        c = fs.launch_counts()
        counts.append(c)
        fits[label] = (mean, cov)
        em, ec = errs(mean, cov, t)
        busy, wall_prof = busy_per_step(lambda: g.fit(
            FIT_SEED, batch_size=b, niter=DENSE_WINDOW - 1, verbose=False),
            DENSE_WINDOW)
        emit({"phase": "dense_path", "path": label, "fitter": "GSM",
              "D": D, "B": b, "niter": niter, "launches": c,
              "mean_err": em, "cov_err": ec, "mean_err_bound": bounds[0],
              "cov_err_bound": bounds[1], "iters_per_s": (niter + 1) / wall,
              "wall_us_per_step": 1e6 * wall / (niter + 1),
              "device_busy_us_per_step": busy,
              "wall_us_per_step_profiled": wall_prof,
              "device_idle_share_profiled": 1.0 - busy / wall_prof})
        check(c["gsm_update_fused"] == niter + 1,
              f"{label}: K5 launches {c['gsm_update_fused']} != niter+1")
        check(sum(c.values()) == niter + 1, f"{label}: other kernels ran")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
              and tuple(cov.shape) == (D, D), f"{label}: shape/finiteness")
        _errs_bounded(em, ec, bounds, f"GSM {label} route")
    return counts, fits["dense"]


def phase_batch_kernels(bfm, fs, t, torch):
    """Phase 12: K6 against its plain version at K=4, B=32, D=256, spc=8,
    and each replica against a single K2 call on it."""
    dev = torch.device("cuda")
    k, spc = 4, 8
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(15)
    blocks = torch.randn((k, spc * B, D), generator=gen, device=dev)
    means = torch.zeros((k, D), device=dev)
    factors = torch.eye(D, device=dev).repeat(k, 1, 1)
    # Draw rows of replica 2 at sub-step 4 scaled over three decades: the
    # residual gates reject that sub-step (as in phase 1).
    rejected = blocks.clone()
    rejected[2, 4 * B:5 * B] *= torch.logspace(0.0, 3.0, B, device=dev)[:, None]
    step = bfm.make_fused_eps_batch_multistep(score_fn, len(params), B, D, k,
                                              spc)
    single = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)
    worst = 0.0
    for case, blk, nmax, want in (
            ("full", blocks, spc, [spc] * k),
            ("nmax_lt_spc", blocks, 3, [3] * k),
            ("one_rejected", rejected, spc, [spc, spc, spc - 1, spc])):
        m_k, f_k, n_k = graph_block(step, nmax, blk, means, factors, params,
                                    torch)
        m_p, f_p, n_p = bfm.eps_batch_multistep_reference(
            fs.gaussian_score_reference, params, nmax, blk, means, factors,
            batch=B)
        singles = [single(nmax, blk[i], means[i], factors[i], *params)
                   for i in range(k)]
        torch.cuda.synchronize()
        em = float((m_k - m_p).abs().max())
        ef_ = float((f_k - f_p).abs().max())
        fscale = float(f_p.abs().max())
        same = all(torch.equal(m_k[i], s[0]) and torch.equal(f_k[i], s[1])
                   and int(s[2]) == int(n_k[i])
                   for i, s in enumerate(singles))
        rec = {"kernel": "make_fused_eps_batch_multistep", "case": case,
               "K": k, "B": B, "D": D, "spc": spc, "nmax": nmax,
               "n_acc": [n_k.tolist(), n_p.tolist()], "mean_err": em,
               "f_err": ef_, "f_tol": MULTI_TOL * fscale,
               "mean_tol": MULTI_TOL, "replicas_equal_single_k2": same,
               "graphs_captured": step.captures}
        emit({"phase": "batch_kernels", **rec})
        check(n_k.tolist() == n_p.tolist() == want, f"K6 counts {rec}")
        check(em <= MULTI_TOL and ef_ <= MULTI_TOL * fscale,
              f"K6 disagrees with its plain version: {rec}")
        check(same, f"a K6 replica differs from its single K2 call: {rec}")
        worst = max(worst, em, ef_)
    return worst


def _replica_errs(means, covs, t):
    return [errs(m, c, t) for m, c in zip(means, covs)]


def phase_fit_batch_paths(GSM, FactorGSM, fs, t, st_single, torch):
    """Phase 13a: the three fit_batch routes at D=256, B=32, K=8."""
    seeds = range(FIT_BATCH_K)
    fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    runs = (
        ("fused", "FactorGSM(fused_score).fit_batch(small_solver='fused')",
         lambda: fg.fit_batch(seeds, batch_size=B, niter=N_ITER,
                              return_state=True, small_solver="fused"),
         "make_fused_eps_batch_multistep"),
        ("ns", "GSM.fit_batch (batched K1)",
         lambda: GSM(D, t.lp, t.lp_g, device="cuda").fit_batch(
             seeds, batch_size=B, niter=N_ITER, return_state=True),
         "gsm_eps_update_fused"),
        ("dense", "GSM(use_factor=False).fit_batch (batched K5)",
         lambda: GSM(D, t.lp, t.lp_g, device="cuda", use_factor=False)
         .fit_batch(seeds, batch_size=B, niter=N_ITER, return_state=True),
         "gsm_update_fused"))
    counts, states, walls = [], {}, {}
    for route, fitter, run, kernel in runs:
        fs.reset_launch_counts()
        st, wall = _timed(run, torch)
        c = fs.launch_counts()
        counts.append(c)
        states[route], walls[route] = st, wall
        e = _replica_errs(st.mean, st.cov, t)
        emit({"phase": "fit_batch_path", "route": route, "fitter": fitter,
              "K": FIT_BATCH_K, "D": D, "B": B, "niter": N_ITER,
              "launches": c, "n_accepted": st.n_accepted.tolist(),
              "mean_err": [x[0] for x in e], "cov_err": [x[1] for x in e],
              "iters_per_s_per_replica": (N_ITER + 1) / wall,
              "aggregate_iters_per_s": FIT_BATCH_K * (N_ITER + 1) / wall})
        check(c[kernel] > 0, f"fit_batch {route}: {kernel} not launched")
        if route == "fused":
            check(c["gaussian_score"] > 0
                  and c["make_fused_eps_multistep"] == 0
                  and c["gsm_eps_update_fused"] == 0,
                  "fit_batch fused: K3 must launch, K1/K2 must not")
        else:
            check(c[kernel] == N_ITER + 1,
                  f"fit_batch {route}: {kernel} launches != niter+1")
        check(bool(torch.isfinite(st.mean).all()
                   and torch.isfinite(st.cov).all()),
              f"fit_batch {route}: not finite")
        for i, (em, ec) in enumerate(e):
            _errs_bounded(em, ec, (MEAN_ERR_BOUND, COV_ERR_BOUND),
                          f"fit_batch {route} replica {i}")
    # The K6 fit on eager blocks: the same state, its it/s, the host's cost.
    fused = states["fused"]
    emit({"phase": "fit_batch_graph", "K": FIT_BATCH_K, **graph_vs_eager(
        fg, runs[0][2], fused, walls["fused"], N_ITER + 1,
        fg._get_runner(B, "step", FIT_BATCH_K), torch)})
    # Replicas 0 and 1 of the K6 fit against the single K2 fits.
    st1 = fg.fit(1, batch_size=B, niter=N_ITER, verbose=False,
                 return_state=True)
    same = [bool(torch.equal(fused.mean[i], s.mean)
                 and torch.equal(fused.factor[i], s.factor)
                 and int(fused.n_accepted[i]) == int(s.n_accepted))
            for i, s in enumerate((st_single, st1))]
    emit({"phase": "fit_batch_identity", "replicas_equal_single_fit": same})
    check(all(same), "K6 replicas 0/1 differ from the single K2 fits")
    return counts


def phase_fit_batch_rates(FactorGSM, dense_gaussian, torch):
    """Phase 13b: it/s of the bench's fit_batch cells beside the single
    K2 fit on the same card (host clock around each fit + synchronize)."""
    dev = torch.device("cuda")
    out = {}
    for d in sorted({d for d, _ in RATE_CELLS}):
        t = dense_gaussian(TARGET_SEED, d, device=dev)
        fg = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                       device=dev)
        fg.fit(1, batch_size=B, niter=20, verbose=False)            # warm up
        _, wall = _timed(lambda: fg.fit(0, batch_size=B, niter=N_RATE[8],
                                        verbose=False), torch)
        out[f"D{d}_single_k2"] = {"iters_per_s": (N_RATE[8] + 1) / wall}
        for dd, k in RATE_CELLS:
            if dd != d:
                continue
            for solver in ("fused", "ns"):
                g = fg if solver == "fused" else FactorGSM(
                    d, t.lp, t.lp_g, device=dev)
                n = N_RATE[k]
                g.fit_batch(range(k), batch_size=B, niter=20,
                            small_solver=solver)                  # warm up
                (m, c), wall = _timed(lambda: g.fit_batch(
                    range(k), batch_size=B, niter=n, small_solver=solver),
                    torch)
                ips = (n + 1) / wall
                rec = {"iters_per_s_per_replica": ips,
                       "aggregate_iters_per_s": k * ips, "niter": n}
                if k == FIT_BATCH_K:
                    rec["worst_err"] = [max(x) for x in zip(
                        *_replica_errs(m, c, t))]
                out[f"D{d}_K{k}_{solver}"] = rec
                check(bool(torch.isfinite(m).all()
                           and torch.isfinite(c).all()),
                      f"fit_batch D{d} K{k} {solver}: not finite")
    emit({"phase": "fit_batch_rates", "B": B, "cells": out})
    return out


def phase_dense_batch_times(gs, bfm, fs, t, torch, np):
    """Per-call times of K5 (B=32 and B=512, D=256) and K6 (K=8, B=32,
    D=256, spc=8), kernel vs plain version (CUDA events), and their
    bound inputs."""
    dev = torch.device("cuda")
    cu = lambda z: torch.from_numpy(z).to(dev)
    times, work, k5 = {}, {}, {}
    for b, kk in ((B, None), (HUGE_B, None), (B, FIT_BATCH_K)):
        name = f"gsm_update_fused_B{b}" + (f"_K{kk}" if kk else "")
        x, v, mu, s0 = (cu(z) for z in
                        _dense_inputs(np, b, D, 4100 + b, kk))
        call = (lambda x=x, v=v, mu=mu, s0=s0:
                gs.gsm_update_fused(x, v, mu, s0))
        times[name] = (
            cuda_ms(call, reps=50),
            cuda_ms(lambda: gs.gsm_update_replicas_reference(x, v, mu, s0),
                    reps=50))
        work[name] = (
            lambda x=x, v=v, mu=mu, s0=s0:
            gs.gsm_update_replicas_reference(x, v, mu, s0), (x, v, mu, s0),
            k5_flops(kk or 1, b, D))
        k5[name] = k5_per_call(call, torch)
    k, spc = FIT_BATCH_K, 8
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(16)
    blocks = torch.randn((k, spc * B, D), generator=gen, device=dev)
    means = torch.zeros((k, D), device=dev)
    factors = torch.eye(D, device=dev).repeat(k, 1, 1)
    step = bfm.make_fused_eps_batch_multistep(score_fn, len(params), B, D, k,
                                              spc)
    plain = lambda: bfm.eps_batch_multistep_reference(
        fs.gaussian_score_reference, params, spc, blocks, means, factors,
        batch=B)
    k6 = lambda: step(spc, blocks, means, factors, *params)
    times["make_fused_eps_batch_multistep"] = (
        cuda_ms(k6, reps=10), cuda_ms(plain, reps=3, warmup=1))
    work["make_fused_eps_batch_multistep"] = (
        plain, (blocks, means, factors, *params))
    device = {"make_fused_eps_batch_multistep": device_ms(k6, calls=10)[0]}
    # K6 per call as one graph replay (``ms``) and on eager blocks.
    eager = lambda: step(spc, blocks, means, factors, *params, graph=False)
    k6_eager = {"ms_eager": cuda_ms(eager, reps=10),
                "device_ms_eager": device_ms(eager, calls=10)[0]}
    device.update({n: r["device_ms"] for n, r in k5.items()})
    emit({"phase": "dense_batch_times", "D": D, "K": k, "spc": spc,
          "ms_per_call": {n: {"kernel": a, "plain": p,
                              "device": device.get(n)}
                          for n, (a, p) in times.items()},
          "gsm_update_fused_per_call": k5,
          "make_fused_eps_batch_multistep_eager": k6_eager})
    times["gsm_update_fused"] = times[f"gsm_update_fused_B{B}"]
    work["gsm_update_fused"] = work[f"gsm_update_fused_B{B}"]
    device["gsm_update_fused"] = device[f"gsm_update_fused_B{B}"]
    more = {"make_fused_eps_batch_multistep": k6_eager,
            "gsm_update_fused": {
                "device_ms_B512": device[f"gsm_update_fused_B{HUGE_B}"],
                f"device_ms_K{FIT_BATCH_K}":
                    device[f"gsm_update_fused_B{B}_K{FIT_BATCH_K}"],
                **{key: k5[f"gsm_update_fused_B{B}"][key] for key in (
                    "host_launches_per_call", "device_launches_per_call",
                    "profiler_dropped", "allocations_per_call")}}}
    return times, work, device, more


def k5_flops(k: int, b: int, d: int) -> int:
    """The products K5 needs: T = V S0 (2 B D^2 a replica) and the upper
    triangle, diagonal included, of A^T A - Bm^T Bm (2 B D (D + 1)); its
    plain version forms both whole Grams (6 B D^2 in all)."""
    return k * (2 * b * d * d + 2 * b * d * (d + 1))


def k5_per_call(call, torch, calls: int = 50) -> dict:
    """K5 on the card, per call, from ``tools.profile_gpu.profile_calls``:
    the host's kernel launches and the device allocations per call, the
    profiler's device records of each kernel over ``calls`` calls (it may
    drop one; ``profiler_dropped`` counts them) and the device
    milliseconds (the sum of the kernels' means per launch, robust to a
    drop).  Fails unless a call is K5's two kernels, launched once each,
    and two allocations (mu, S)."""
    from tools.profile_gpu import profile_calls

    rec = profile_calls("K5", call, calls, torch, quiet=True)
    per = rec["launches_by_kernel"]
    out = {"device_ms":
           1e-3 * sum(rec["device_us_per_launch_by_kernel"].values()),
           "host_launches_per_call": rec["host_launches_per_call"],
           "device_launches_per_call": rec["kernel_launches_per_call"],
           "profiler_dropped": len(K5_KERNELS) * calls - sum(per.values()),
           "allocations_per_call": rec["allocations_per_call"],
           "kernels": per, "calls": calls}
    check(rec["host_launches_per_call"] == len(K5_KERNELS)
          and rec["allocations_per_call"] == 2 and len(per) == 2
          and all(sum(k in n for n in per) == 1 for k in K5_KERNELS)
          and all(0.9 * calls <= n <= calls for n in per.values()),
          f"K5 must be two launches ({K5_KERNELS}) and two allocations a "
          f"call: {out}")
    return out


def _cov(f):
    f = f.double()
    return f @ f.T


def _chol_close(k, p, p64):
    """Kernel (mean, F) vs the plain float32 version: (mean_err, mean_tol,
    cov_err, cov_tol), the tolerances as CHOL_* state them, from the plain
    float64 version ``p64`` on the same input."""
    s_p = _cov(p[1])
    floor_m = float((p[0].double() - p64[0]).abs().max())
    floor_s = float((s_p - _cov(p64[1])).abs().max())
    return (float((k[0] - p[0]).abs().max()),
            max(CHOL_MEAN_TOL, CHOL_FLOOR * floor_m),
            float((_cov(k[1]) - s_p).abs().max()),
            max(CHOL_COV_TOL * max(1.0, float(s_p.abs().max())),
                CHOL_FLOOR * floor_s))


def _f64(xs):
    return [x.double() for x in xs]


def _ulps(a, b, torch):
    """Largest distance in units in the last place between float32 a, b."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def phase_eps_step_kernels(fs, dense_gaussian, torch, np):
    """Phase 14: K4 (ns and chol, external and on-card draw), K4a and the
    Philox draw against their plain versions on the same CUDA tensors."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ref = fs.gaussian_score_reference
    worst = 0.0
    for b, d in STEP_SHAPES:
        rng = np.random.default_rng(5000 + b + d)
        t = dense_gaussian(TARGET_SEED, d, device=dev)
        score_fn, params = t.fused_score
        e = cu(rng.standard_normal((b, d)).astype(np.float32))
        mean0, f0 = torch.zeros(d, device=dev), torch.eye(d, device=dev)
        recs = []
        for method in ("ns", "chol"):
            step = fs.make_fused_eps_step(score_fn, len(params), b, d,
                                          external_eps=True, method=method)
            k = step(e, mean0, f0, *params)
            p = fs.eps_step_reference(ref, params, e, mean0, f0,
                                      method=method)
            p64 = (fs.eps_step_reference(ref, _f64(params), *_f64(
                (e, mean0, f0)), method=method) if method == "chol" else None)
            recs.append((f"step_{method}", k, p, p64))
        # K4a alone on given scores (phase 1's kind of input).
        a = rng.standard_normal((d, d))
        f = cu(np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32))
        mu = cu(rng.standard_normal(d).astype(np.float32))
        v = cu((0.3 * rng.standard_normal((b, d))).astype(np.float32))
        k = fs.gsm_eps_update_fused(e, v, mu, f, method="chol")
        p = fs.gsm_eps_update_chol_reference(e, v, mu, f)
        p64 = fs.gsm_eps_update_chol_reference(*_f64((e, v, mu, f)))
        recs.append(("update_chol", k, p, p64))
        torch.cuda.synchronize()
        for case, k, p, p64 in recs:
            if case == "step_ns":
                em, tm = float((k[0] - p[0]).abs().max()), STEP_TOL
                ef_, tf = (float((k[1] - p[1]).abs().max()),
                           STEP_TOL * float(p[1].abs().max()))
            else:
                em, tm, ef_, tf = _chol_close(k, p, p64)
            rec = {"kernel": "make_fused_eps_step" if case.startswith("step")
                   else "gsm_eps_update_fused(chol)", "case": case, "B": b,
                   "D": d, "good": [bool(k[2]), bool(p[2])],
                   "mean_err": em, "mean_tol": tm,
                   ("f_err" if case == "step_ns" else "cov_err"): ef_,
                   ("f_tol" if case == "step_ns" else "cov_tol"): tf}
            emit({"phase": "eps_step_kernels", **rec})
            check(bool(k[2]) == bool(p[2]) is True, f"K4 accept flag {rec}")
            check(em <= tm and ef_ <= tf,
                  f"K4 disagrees with its plain version: {rec}")
            worst = max(worst, em, float((k[1] - p[1]).abs().max()))

        # Rejections: K indefinite in float32 (draws at 1e4, score v = e),
        # and a NaN score; the old state must come back.
        ind_e = cu((1e4 * rng.standard_normal((b, d))).astype(np.float32))
        neg = (torch.zeros((1, d), device=dev), -torch.eye(d, device=dev))
        nan_v = v.clone()
        nan_v[b // 2, d // 3] = float("nan")
        nan_params = (params[0].clone(), params[1])
        nan_params[0][0, d // 3] = float("nan")
        chol_step = fs.make_fused_eps_step(score_fn, 2, b, d,
                                           external_eps=True, method="chol")
        ns_step = fs.make_fused_eps_step(score_fn, 2, b, d,
                                         external_eps=True)
        rejects = [
            ("update_chol_indefinite", mean0, f0,
             fs.gsm_eps_update_fused(ind_e, ind_e, mean0, f0, method="chol"),
             fs.gsm_eps_update_chol_reference(ind_e, ind_e, mean0, f0)),
            ("step_chol_indefinite", mean0, f0,
             chol_step(ind_e, mean0, f0, *neg),
             fs.eps_step_reference(ref, neg, ind_e, mean0, f0,
                                   method="chol")),
            ("update_chol_nan_score", mu, f,
             fs.gsm_eps_update_fused(e, nan_v, mu, f, method="chol"),
             fs.gsm_eps_update_chol_reference(e, nan_v, mu, f)),
            ("step_chol_nan_score", mean0, f0,
             chol_step(e, mean0, f0, *nan_params),
             fs.eps_step_reference(ref, nan_params, e, mean0, f0,
                                   method="chol")),
            ("step_ns_nan_score", mean0, f0,
             ns_step(e, mean0, f0, *nan_params),
             fs.eps_step_reference(ref, nan_params, e, mean0, f0)),
        ]
        torch.cuda.synchronize()
        for case, m_old, f_old, k, p in rejects:
            kept = bool(torch.equal(k[0], m_old) and torch.equal(k[1], f_old))
            rec = {"kernel": "make_fused_eps_step" if case.startswith("step")
                   else "gsm_eps_update_fused(chol)", "case": case, "B": b,
                   "D": d, "good": [bool(k[2]), bool(p[2])],
                   "old_state_kept": kept}
            emit({"phase": "eps_step_kernels", **rec})
            check(bool(k[2]) == bool(p[2]) is False and kept,
                  f"K4 rejection {rec}")

    # The Philox draw.
    seed = 20261016
    n_blocks = PRNG_SHAPE[0] * PRNG_SHAPE[1] // 2
    kat = fs.philox4x32(1, 0, 0, device=dev)[0].tolist()
    words = fs.philox4x32(n_blocks, seed, fs.PHILOX_KEY1, device=dev)
    words_p = fs.philox4x32_reference(fs._philox_counters(n_blocks, dev),
                                      seed, fs.PHILOX_KEY1)
    z = fs.philox_normal(seed, *PRNG_SHAPE, device=dev)
    z_p = fs.philox_normal_reference(seed, *PRNG_SHAPE, device=dev)
    z2 = fs.philox_normal(seed + 1, *PRNG_SHAPE, device=dev)
    x = z.reshape(-1).double()
    xs, _ = torch.sort(x)
    n = xs.numel()
    cdf = 0.5 * (1.0 + torch.erf(xs / 2.0 ** 0.5))
    i = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    ks = max(float((i / n - cdf).max()), float((cdf - (i - 1) / n).max()))
    rec = {"kat_counter0_key0": [f"{w:08x}" for w in kat],
           "words_equal": bool(torch.equal(words, words_p)),
           "normals_max_ulp": _ulps(z, z_p, torch), "n": n,
           "mean": float(x.mean()), "var": float(x.var()), "ks": ks,
           "seeds_differ": bool((z2 - z).abs().mean() > 0.5)}
    emit({"phase": "eps_step_kernels", "kernel": "philox", **rec})
    check(kat == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
          f"Philox known answer {rec}")
    check(rec["words_equal"] and rec["normals_max_ulp"] <= PRNG_ULP,
          f"Philox kernel vs plain version {rec}")
    check(abs(rec["mean"]) < PRNG_MEAN_TOL
          and abs(rec["var"] - 1.0) < PRNG_VAR_TOL and ks < PRNG_KS_TOL
          and rec["seeds_differ"], f"Philox draw distribution {rec}")
    t = dense_gaussian(TARGET_SEED, D, device=dev)
    score_fn, params = t.fused_score
    on_card = fs.make_fused_eps_step(score_fn, len(params), B, D)
    mean0, f0 = torch.zeros(D, device=dev), torch.eye(D, device=dev)
    k = on_card(seed, mean0, f0, *params)
    p = fs.eps_step_reference(ref, params,
                              fs.philox_normal_reference(seed, B, D, dev),
                              mean0, f0)
    torch.cuda.synchronize()
    em = float((k[0] - p[0]).abs().max())
    ef_ = float((k[1] - p[1]).abs().max())
    rec = {"kernel": "make_fused_eps_step", "case": "step_ns_philox",
           "B": B, "D": D, "good": [bool(k[2]), bool(p[2])],
           "mean_err": em, "f_err": ef_,
           "f_tol": STEP_TOL * float(p[1].abs().max())}
    emit({"phase": "eps_step_kernels", **rec})
    check(bool(k[2]) == bool(p[2]) is True and em <= STEP_TOL
          and ef_ <= rec["f_tol"], f"K4 on-card draw step {rec}")
    return worst


def phase_eps_step_path(FactorGSM, fs, t, st_spc8, torch):
    """Phase 15: FactorGSM(fused_score, steps_per_call=1) on K4."""
    g = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=1, device="cuda")
    check(g._fused_mode(B) == "step", "spc=1 must run the step mode")
    fs.reset_launch_counts()
    st, wall = _timed(lambda: g.fit(FIT_SEED, batch_size=B, niter=N_ITER,
                                    verbose=False, return_state=True), torch)
    c = fs.launch_counts()
    same = bool(torch.equal(st.mean, st_spc8.mean)
                and torch.equal(st.factor, st_spc8.factor)
                and int(st.n_accepted) == int(st_spc8.n_accepted))
    emit({"phase": "eps_step_path",
          "fitter": "FactorGSM(fused_score, steps_per_call=1)", "D": D,
          "B": B, "niter": N_ITER, "launches": c,
          "n_accepted": int(st.n_accepted), "equals_spc8_state": same,
          "iters_per_s": (N_ITER + 1) / wall})
    check(c["make_fused_eps_step"] == N_ITER + 1,
          f"K4 launches {c['make_fused_eps_step']} != niter+1")
    check(c["make_fused_eps_multistep"] == 0, "K2 launched at spc=1")
    check(same, "the spc=1 K4 fit differs from the spc=8 K2 fit")
    return c


def phase_audit_paths(FactorGSM, FactorBaM, Regularizers, fs, t, st_gsm,
                      st_bam, torch):
    """Phase 16: the audited FactorGSM (K2 + K4 audits) and FactorBaM
    (K8 + K7 audits) fits against their unaudited states."""
    import warnings

    counts = []
    g = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    fs.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st, wall = _timed(lambda: g.fit(
            FIT_SEED, batch_size=B, niter=N_ITER, verbose=False,
            return_state=True, audit_every=AUDIT_EVERY,
            audit_tol=AUDIT_TOL), torch)
    c = fs.launch_counts()
    counts.append(c)
    warned = [str(w.message) for w in caught if "audit" in str(w.message)]
    same = bool(torch.equal(st.mean, st_gsm.mean)
                and torch.equal(st.factor, st_gsm.factor)
                and int(st.n_accepted) == int(st_gsm.n_accepted))
    log = g.audit_log
    emit({"phase": "audit_paths", "fitter": "FactorGSM(fused_score)",
          "D": D, "B": B, "niter": N_ITER, "audit_every": AUDIT_EVERY,
          "launches": c, "records": log, "warnings": warned,
          "max_err": max(max(r["mean_err"], r["cov_err"]) for r in log),
          "equals_unaudited_state": same,
          "iters_per_s": (N_ITER + 1) / wall})
    check([r["i"] for r in log] == list(range(AUDIT_EVERY, N_ITER + 1,
                                              AUDIT_EVERY))
          and len(log) == 6 and all(r["valid"] for r in log),
          "FactorGSM audit records")
    check(not warned, f"FactorGSM audit warned: {warned}")
    check(c["make_fused_eps_step"] == 6, "K4 must launch once per audit")
    check(same, "the audited FactorGSM fit differs from the unaudited one")

    regf = Regularizers().linear(BAM_REGF0)
    fb = FactorBaM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    fs.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st, wall = _timed(lambda: fb.fit(
            FIT_SEED, regf, batch_size=B, niter=N_BAM, verbose=False,
            retries=0, return_state=True, audit_every=AUDIT_EVERY,
            audit_tol=AUDIT_TOL), torch)
    c = fs.launch_counts()
    counts.append(c)
    warned = [str(w.message) for w in caught if "audit" in str(w.message)]
    same = bool(torch.equal(st.mean, st_bam.mean)
                and torch.equal(st.factor, st_bam.factor)
                and int(st.n_accepted) == int(st_bam.n_accepted)
                and tuple(st.ns_stats) == tuple(st_bam.ns_stats))
    log = fb.audit_log
    valid = [r for r in log if r["valid"]]
    emit({"phase": "audit_paths", "fitter": "FactorBaM(fused_score)",
          "D": D, "B": B, "niter": N_BAM, "regf": f"linear({BAM_REGF0})",
          "audit_every": AUDIT_EVERY, "launches": c, "records": log,
          "warnings": warned,
          "max_valid_err": max((max(r["mean_err"], r["cov_err"])
                                for r in valid), default=None),
          "equals_unaudited_state": same,
          "iters_per_s": (N_BAM + 1) / wall})
    check([r["i"] for r in log] == list(range(AUDIT_EVERY, N_BAM + 1,
                                              AUDIT_EVERY)) and len(log) == 4,
          "FactorBaM audit records")
    check(not warned, f"FactorBaM audit warned on a valid record: {warned}")
    check(c["bam_eps_update_fused"] == 4, "K7 must launch once per audit")
    check(same, "the audited FactorBaM fit differs from the unaudited one")
    return counts


def phase_eps_step_times(fs, t, torch):
    """Per-call times of K4 (ns and chol, external draw; ns on the on-card
    draw), K4a and the Philox draw at D=256, B=32 from (0, I), kernel vs
    plain version (CUDA events; K4, K4a and the draw also on the device),
    and K4's bound inputs."""
    dev = torch.device("cuda")
    score_fn, params = t.fused_score
    ref = fs.gaussian_score_reference
    gen = torch.Generator(device=dev).manual_seed(17)
    e = torch.randn((B, D), generator=gen, device=dev)
    mean, f = torch.zeros(D, device=dev), torch.eye(D, device=dev)
    v = t.lp_g(mean + e @ f.T)
    ns = fs.make_fused_eps_step(score_fn, len(params), B, D,
                                external_eps=True)
    chol = fs.make_fused_eps_step(score_fn, len(params), B, D,
                                  external_eps=True, method="chol")
    on_card = fs.make_fused_eps_step(score_fn, len(params), B, D)
    times = {
        "make_fused_eps_step": (
            cuda_ms(lambda: ns(e, mean, f, *params)),
            cuda_ms(lambda: fs.eps_step_reference(ref, params, e, mean, f))),
        "make_fused_eps_step_chol": (
            cuda_ms(lambda: chol(e, mean, f, *params), reps=20),
            cuda_ms(lambda: fs.eps_step_reference(ref, params, e, mean, f,
                                                  method="chol"),
                    reps=3, warmup=1)),
        "gsm_eps_update_fused_chol": (
            cuda_ms(lambda: fs.gsm_eps_update_fused(e, v, mean, f,
                                                    method="chol"), reps=20),
            cuda_ms(lambda: fs.gsm_eps_update_chol_reference(e, v, mean, f),
                    reps=3, warmup=1)),
        "make_fused_eps_step_philox": (
            cuda_ms(lambda: on_card(7, mean, f, *params)),
            cuda_ms(lambda: fs.eps_step_reference(
                ref, params, fs.philox_normal_reference(7, B, D, dev), mean,
                f))),
        "philox_normal": (
            cuda_ms(lambda: fs.philox_normal(7, B, D, device=dev), reps=200),
            cuda_ms(lambda: fs.philox_normal_reference(7, B, D, dev),
                    reps=20)),
    }
    device = {"make_fused_eps_step": device_ms(
        lambda: ns(e, mean, f, *params))[0],
        "make_fused_eps_step_chol": device_ms(
            lambda: chol(e, mean, f, *params), calls=20)[0],
        "gsm_eps_update_fused_chol": device_ms(
            lambda: fs.gsm_eps_update_fused(e, v, mean, f, method="chol"),
            calls=20)[0],
        "philox_normal": device_ms(
            lambda: fs.philox_normal(7, B, D, device=dev))[0]}
    # The Philox draw's yardstick: torch.randn of the same shape (partial:
    # another stream, the same distribution), CUDA events and device time,
    # at the main path's shape and the two-phase bulk's (512, 1024).
    yardstick = {}
    for b, d in ((B, D), PHILOX_LARGE):
        yardstick[f"{b}x{d}"] = {
            "philox_ms": cuda_ms(lambda: fs.philox_normal(7, b, d,
                                                          device=dev),
                                 reps=200),
            "philox_device_ms": device_ms(
                lambda: fs.philox_normal(7, b, d, device=dev))[0],
            "randn_ms": cuda_ms(lambda: torch.randn((b, d), device=dev),
                                reps=200),
            "randn_device_ms": device_ms(
                lambda: torch.randn((b, d), device=dev))[0]}
    emit({"phase": "eps_step_times", "B": B, "D": D,
          "ms_per_call": {k: {"kernel": a, "plain": p,
                              "device": device.get(k)}
                          for k, (a, p) in times.items()},
          "philox_yardstick": yardstick})
    work = {
        "make_fused_eps_step": (
            lambda: fs.eps_step_reference(ref, params, e, mean, f),
            (e, mean, f, *params)),
        "make_fused_eps_step_chol": (
            lambda: fs.eps_step_reference(ref, params, e, mean, f,
                                          method="chol"),
            (e, mean, f, *params)),
        "gsm_eps_update_fused_chol": (
            lambda: fs.gsm_eps_update_chol_reference(e, v, mean, f),
            (e, v, mean, f)),
        "philox_normal": (
            lambda: fs.philox_normal_reference(7, B, D, dev), ()),
    }
    return times, work, device

# Phase 17: the kernels' shape ranges.  K1 and K2 at the reference
# examples' small shapes and at the bench's large batches (bench.py:551-590,
# the B sweep on FactorGSM(pallas_score)); K2 on a benign target
# (log-spaced eigenvalues 1-10, ill_conditioned_gaussian) so that every
# shape's update is accepted; BaM at B=2 and B=128 (the JAX kernel's top,
# bam_fused.py:345-352); ADVI at (1, 16) and the two-phase bulk's
# (512, 1024) (bench.py:411-440); GSM at D=2048 (bench.py:489-494).
RANGE_SMALL = ((1, 1), (2, 10), (3, 5), (7, 16))
RANGE_LARGE = ((65, 1), (65, 33), (65, 256), (96, 1), (96, 33), (96, 256),
               (127, 1), (127, 33), (127, 256),
               (128, 256), (129, 33), (200, 1), (256, 256), (512, 256),
               (128, 1024), (512, 1024))
RANGE_COND = 10.0
RANGE_BAM = ((2, 256), (128, 256))
RANGE_ADVI = ((1, 16), (512, 1024))
WIDE_D, N_WIDE = 2048, 200
# Phase 18: the reference examples' configurations (examples/example_gsm.py,
# example_bam.py, example_initializers.py) on dense_gaussian of the same
# numpy seeds as tools/jax_example_bound.py, and the bench's B=128 cells.
# Bounds: 1.5 x the worst error of that script's JAX CPU fits (PRNGKey
# 0..7, on both routes the JAX package runs each configuration on; 0..3 at
# B=128): (D, numpy seed, B, niter, worst (mean_err, cov_err)).  At B=1-2
# from (0, I) some JAX fits have not converged by niter (the worst of
# gsm16 and bam5 are such fits), so those two bounds are loose.
EXAMPLES = {
    "gsm10": (10, 3, 2, 500, (4.4704e-6, 8.9894e-6)),
    "bam5": (5, 5, 2, 100, (1.2329, 0.18525)),
    "gsm16": (16, 11, 1, 500, (13.446, 0.36385)),
}
B128, N_B128 = 128, 3000
B128_MEAN_REF, B128_COV_REF = 9.0187e-4, 2.3533e-4
N_BAM128 = 200
# A short fit above the panel range, on the grid small space.
B256, N_B256 = 256, 64
# K6 at K replicas and B=128 against the single K2 fits (phase 17).
K6_B128 = (4, 64, 16)                # (K, D, niter)
# Phases 19-20: the zoo's K11a and K11b kernels and the zoo path.  Kernel
# vs plain version (float32 on the card, sums in other orders): funnel and
# banana within 1e-5 * max(1, max|v|) (elementwise work and one row sum),
# the Student-t within 1e-4 * max(1, max|v|) (a D-long product, then a row
# sum and a division), logreg within 1e-5 * max(1, max|v|) (z ~ N(0, 1): two
# well-conditioned products).  The mixture's logits are differences of
# terms ~1e3 at separation 3 (x . m_k and ||m_k||^2/2 at D=256), so any
# float32 order of sums moves them by ~1e-4, and a row whose top two
# logits nearly tie turns that into ~1e-3 of v (the plain float32
# version's own distance from float64 there); the mixture is held to the
# larger of 1e-5 * max(1, max|v|) and ZOO_FLOOR x that distance, the
# rounding floor of its input.  funnel's x0 is drawn in [-3, 3], where
# e^{-x0} stays finite; logreg's saturated case scales every other row by
# ZOO_SATURATE, so that |z| > 100 there.  Bounds on the zoo fits: 1.5 x the
# worst of 4 (logreg: 8) JAX CPU FactorGSM fits of the same target
# (tools/jax_example_bound.py; errors against the analytic moments, for the
# mixture against the component the fit lands in, for logreg against the
# Laplace approximation); funnel has none, so its fit must stay finite and
# PD.
ZOO_SHAPES = ((B, D), (3, 10), (512, 1024))
ZOO_TOL = {"funnel_score": 1e-5, "banana_score": 1e-5,
           "student_t_score": 1e-4, "mixture_score": 1e-5,
           "logreg_score": 1e-5}
ZOO_FLOOR, ZOO_SATURATE = 8.0, 400.0
ZOO_DF = 6.0
ZOO_WORST = {"banana": (1.5583, 0.88977), "student_t": (1.7734e-3, 0.18539),
             "mixture": (6.0961e-3, 1.1539e-3), "logreg": (0.41377, 0.056698)}
N_ZOO, N_ZOO_SIDE = 3000, 200


def _k1_inputs(np, torch, b, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    f = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (eps, v, mu, f)]


def phase_ranges(GSM, FactorGSM, fs, bf, af, dense_gaussian,
                 ill_conditioned_gaussian, torch, np):
    """Phase 17: K1/K2 against their plain versions over RANGE_SMALL and
    RANGE_LARGE (B 65-128 on the row-panel small space, above on the grid
    one), K6 replicas at B=128, K7/K8 at RANGE_BAM, K9/K10 at
    RANGE_ADVI; GSM.fit at D=2048 on K1; and the large-B small spaces'
    per-call and device times beside their bounds.  Returns (worst errors,
    the D=2048 path's counts, times, work, device times, the grid small
    space's B=256 and B=512 numbers for the kernels line)."""
    dev = torch.device("cuda")
    spc = 8
    worst = {"gsm_eps_update_fused": 0.0, "make_fused_eps_multistep": 0.0,
             "eps_smallspace_large": 0.0, "eps_smallspace_panel": 0.0}
    for b, d in RANGE_SMALL + RANGE_LARGE:
        e, v, mu, f = _k1_inputs(np, torch, b, d, 5000 + b + d)
        fmax = float(f.abs().max())
        fs.reset_launch_counts()
        m_k, f_k, g_k = fs.gsm_eps_update_fused(e, v, mu, f)
        large = fs.launch_counts()["eps_smallspace_large"]
        panel = fs.launch_counts()["eps_smallspace_panel"]
        m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(e, v, mu, f)
        t = ill_conditioned_gaussian(TARGET_SEED, d, RANGE_COND, device=dev)
        score_fn, params = t.fused_score
        gen = torch.Generator(device=dev).manual_seed(b + d)
        block = torch.randn((spc * b, d), generator=gen, device=dev)
        step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
        m0, f0 = torch.zeros(d, device=dev), torch.eye(d, device=dev)
        mk2, fk2, nk2 = graph_block(step, spc, block, m0, f0, params, torch)
        mp2, fp2, np2 = fs.eps_multistep_reference(
            fs.gaussian_score_reference, params, spc, block, m0, f0, batch=b)
        torch.cuda.synchronize()
        em = float((m_k - m_p).abs().max())
        ef_ = float((f_k - f_p).abs().max())
        em2 = float((mk2 - mp2).abs().max())
        ef2 = float((fk2 - fp2).abs().max())
        fscale = float(fp2.abs().max())
        rec = {"B": b, "D": d, "large_small_space": large,
               "panel_small_space": panel,
               "k1": {"good": [bool(g_k), bool(g_p)], "mean_err": em,
                      "f_err": ef_, "f_tol": F_TOL * fmax},
               "k2": {"n_acc": [int(nk2), int(np2)], "mean_err": em2,
                      "f_err": ef2, "f_tol": MULTI_TOL * fscale,
                      "graph_equals_eager": True,
                      "captures": step.captures}}
        emit({"phase": "ranges", "kernel": "K1/K2", **rec})
        check(large == int(b > fs.PANEL_SMALLSPACE_MAX_B)
              and panel == int(fs.SHARED_SMALLSPACE_MAX_B < b
                               <= fs.PANEL_SMALLSPACE_MAX_B),
              f"small-space route at B={b}: {rec}")
        check(bool(g_k) == bool(g_p) and int(nk2) == int(np2), f"flags {rec}")
        check(em <= MEAN_TOL and ef_ <= F_TOL * fmax,
              f"K1 disagrees with its plain version: {rec}")
        check(em2 <= MULTI_TOL and ef2 <= MULTI_TOL * fscale,
              f"K2 disagrees with its plain version: {rec}")
        for key, err in (("gsm_eps_update_fused", max(em, ef_)),
                         ("make_fused_eps_multistep", max(em2, ef2))):
            worst[key] = max(worst[key], err)
        for key, used in (("eps_smallspace_large", large),
                          ("eps_smallspace_panel", panel)):
            if used:
                worst[key] = max(worst[key], em, ef_, em2, ef2)

    # K6 at K replicas and B=128 on the panel small space's replica axis:
    # each replica equals its single K2 fit, bit for bit.
    k6, d6, n6 = K6_B128
    t6 = dense_gaussian(TARGET_SEED, d6, device=dev)
    g6 = FactorGSM(d6, t6.lp, t6.lp_g, fused_score=t6.fused_score,
                   device="cuda")
    fs.reset_launch_counts()
    st6 = g6.fit_batch(range(k6), batch_size=B128, niter=n6,
                       return_state=True, small_solver="fused")
    c6 = fs.launch_counts()
    singles = [g6.fit(i, batch_size=B128, niter=n6, verbose=False,
                      return_state=True) for i in range(k6)]
    same = [bool(torch.equal(st6.mean[i], s.mean)
                 and torch.equal(st6.factor[i], s.factor))
            for i, s in enumerate(singles)]
    emit({"phase": "ranges", "check": "k6_replicas_b128", "K": k6, "D": d6,
          "B": B128, "niter": n6, "replica_equals_single_fit": same,
          "launches": {k: c6[k] for k in ("make_fused_eps_batch_multistep",
                                          "eps_smallspace_panel")}})
    check(all(same) and c6["eps_smallspace_panel"] > 0,
          "K6 at B=128: a replica differs from its single fit")

    fs.reset_launch_counts()
    small = phase_bam_kernels(bf, fs, torch, np, shapes=RANGE_BAM[:1],
                              designed=False, phase="ranges")
    c_small = fs.launch_counts()
    fs.reset_launch_counts()
    big = phase_bam_kernels(bf, fs, torch, np, shapes=RANGE_BAM[1:],
                            designed=False, phase="ranges")
    c_big = fs.launch_counts()
    check(c_small["bam_smallspace_panel"] == 0 and c_small["bam_smallspace"]
          > 0 and c_big["bam_smallspace"] == 0
          and c_big["bam_smallspace_panel"] > 0,
          f"BaM small-space route: B={RANGE_BAM[0][0]} {c_small}, "
          f"B={RANGE_BAM[1][0]} {c_big}")
    worst["bam_smallspace_panel"] = max(big.values())
    for key in small:
        worst[key] = max(small[key], big[key])
    worst.update(phase_advi_kernels(af, fs, torch, np, shapes=RANGE_ADVI,
                                    designed=False, phase="ranges"))

    # GSM at D=2048 on the factor route (K1 once per step).
    tw = dense_gaussian(TARGET_SEED, WIDE_D, device=dev)
    g = GSM(WIDE_D, tw.lp, tw.lp_g, device="cuda")
    check(g._factor_route(B), "GSM at D=2048 must take the factor route")
    fs.reset_launch_counts()
    (mean, cov), wall = _timed(lambda: g.fit(FIT_SEED, batch_size=B,
                                             niter=N_WIDE, verbose=False),
                               torch)
    wide_counts = fs.launch_counts()
    em, ec = errs(mean, cov, tw)
    emit({"phase": "ranges", "path": "GSM.fit", "D": WIDE_D, "B": B,
          "niter": N_WIDE, "k1_launches": wide_counts["gsm_eps_update_fused"],
          "mean_err": em, "cov_err": ec, "iters_per_s": (N_WIDE + 1) / wall})
    check(wide_counts["gsm_eps_update_fused"] == N_WIDE + 1,
          "GSM at D=2048: K1 must launch once per step")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()),
          "GSM at D=2048: moments not finite")

    # Per-call times of the large-B small spaces (K1 and K7 calls on the
    # row-panel route at B=128, on the grid one at B=256 and 512) beside the
    # plain versions and the bounds; the small spaces' device times, each
    # checked to be its own kernel (the grid one: no GEMM template).
    times, work, out, device, grid = {}, {}, {}, {}, {}
    for b, d in ((B128, D), (256, D), (512, D), (512, 1024)):
        e, v, mu, f = _k1_inputs(np, torch, b, d, 6000 + b + d)
        ef = e @ f.T
        reps = 20 if b == B128 else 5
        tk = cuda_ms(lambda: fs.gsm_eps_update_fused(e, v, mu, f, ef=ef),
                     reps=reps, warmup=2)
        tp = cuda_ms(lambda: fs.gsm_eps_update_ns_reference(e, v, mu, f,
                                                            ef_t=ef),
                     reps=reps, warmup=2)
        bd = bound(lambda: fs.gsm_eps_update_ns_reference(e, v, mu, f,
                                                          ef_t=ef),
                   (e, v, mu, f, ef))
        out[f"K1_B{b}_D{d}"] = {"kernel": tk, "plain": tp, **bd}
        if b == B128:
            t2 = dense_gaussian(TARGET_SEED, d, device=dev)
            score_fn, params = t2.fused_score
            step = fs.make_fused_eps_multistep(score_fn, len(params), b, d,
                                               spc)
            blk = torch.randn((spc * b, d), device=dev)
            m0, f0 = torch.zeros(d, device=dev), torch.eye(d, device=dev)
            out[f"K2_B{b}_D{d}"] = {
                "graph": cuda_ms(lambda: step(spc, blk, m0, f0, *params),
                                 reps=10, warmup=2),
                "eager": cuda_ms(lambda: step(spc, blk, m0, f0, *params,
                                              graph=False), reps=10,
                                 warmup=2)}
        if d == D:
            key = ("eps_smallspace_panel" if b == B128
                   else "eps_smallspace_large")
            if b != 256:
                times[key] = (tk, tp)
                work[key] = (
                    lambda e=e, v=v, mu=mu, f=f, ef=ef:
                    fs.gsm_eps_update_ns_reference(e, v, mu, f, ef_t=ef),
                    (e, v, mu, f, ef))
            vf = v @ f
            rows = (e, v, vf, vf @ f.T, ef, mu)
            ms, names = device_ms(lambda: fs.eps_smallspace(*rows),
                                  calls=20 if b == B128 else 10, warmup=2)
            if b != 256:
                device[key] = ms
            out[f"small_space_B{b}_D{d}_device_ms"] = ms
            want = "eps_panel_kernel" if b == B128 else "eps_grid_kernel"
            check(any(want in n for n in names)
                  and not any("gemm_kernel" in n or "gl_" in n for n in names),
                  f"the small space at B={b} ran {names}")
            if b > B128:
                grid[f"b{b}"] = {"ms": tk, "plain_ms": tp,
                                 "bound_ms": bd["bound_ms"],
                                 "bound_by": bd["bound_by"],
                                 "small_space_device_ms": ms,
                                 "tile": fs.grid_tile(b)}
    cases = bam_k7_cases(np, ((B128, D),))
    _, b, d, arrays, reg, gates, _ = cases[0]
    e, v, mu, f = (torch.from_numpy(x).to(dev) for x in arrays)
    tk = cuda_ms(lambda: bf.bam_eps_update_fused(e, v, mu, f, reg), reps=10,
                 warmup=2)
    tp = cuda_ms(lambda: bf.bam_eps_update_ns_reference(e, v, mu, f, reg),
                 reps=10, warmup=2)
    plain7 = lambda: bf.bam_eps_update_ns_reference(e, v, mu, f, reg)
    out[f"K7_B{b}_D{d}"] = {"kernel": tk, "plain": tp,
                            **bound(plain7, (e, v, mu, f))}
    times["bam_smallspace_panel"] = (tk, tp)
    work["bam_smallspace_panel"] = (plain7, (e, v, mu, f))
    vf = v @ f
    rows = (e, v, vf, vf @ f.T, e @ f.T, mu)
    ms, names = device_ms(lambda: bf.bam_smallspace(*rows, reg), calls=10,
                          warmup=2)
    check(any("bam_panel_kernel" in n for n in names),
          f"BaM's small space at B={b} ran {names}")
    device["bam_smallspace_panel"] = ms
    out[f"bam_small_space_B{b}_D{d}_device_ms"] = ms
    emit({"phase": "range_times", "ms_per_call": out})
    return (worst, [wide_counts], times, work, device,
            {"eps_smallspace_large": grid})


def phase_examples(GSM, BaM, FactorGSM, FactorBaM, Regularizers,
                   dense_gaussian, fs, t, torch):
    """Phase 18: the reference examples' configurations on the card with
    the fitters' defaults (K1 / K7 at B=1-2), then FactorGSM(fused_score)
    at B=128 to convergence on the row-panel small space, a
    FactorBaM(fused_score) run at B=128 on BaM's and a short
    FactorGSM(fused_score) run at B=256 on the grid small space.
    Returns each path's counts."""
    dev = torch.device("cuda")
    counts = []
    for name, (d, seed, b, niter, ref) in EXAMPLES.items():
        te = dense_gaussian(seed, d, device=dev)
        fs.reset_launch_counts()
        if name.startswith("bam"):
            fit = BaM(d, te.lp, te.lp_g, use_lowrank=True, device="cuda")
            check(fit._factor_route()
                  and fit._get_factor_fitter()._fused_mode(b) == "update",
                  "BaM example must run K7")
            (mean, cov), wall = _timed(lambda: fit.fit(
                FIT_SEED, Regularizers().custom(lambda i: 100 / (1 + i)),
                niter=niter, batch_size=b, verbose=False), torch)
            key = "bam_eps_update_fused"
        else:
            fit = GSM(d, te.lp, te.lp_g, device="cuda")
            kw = {} if b == 2 else {"batch_size": b}
            (mean, cov), wall = _timed(lambda: fit.fit(
                FIT_SEED, niter=niter, verbose=False, **kw), torch)
            key = "gsm_eps_update_fused"
        c = fs.launch_counts()
        counts.append(c)
        em, ec = errs(mean, cov, te)
        bounds = (1.5 * ref[0], 1.5 * ref[1])
        emit({"phase": "examples", "config": name, "D": d, "B": b,
              "niter": niter, "launches": {key: c[key]}, "mean_err": em,
              "cov_err": ec, "mean_err_bound": bounds[0],
              "cov_err_bound": bounds[1], "iters_per_s": (niter + 1) / wall})
        check(c[key] == niter + 1 if key == "gsm_eps_update_fused"
              else c[key] >= niter + 1, f"{name}: {key} launches {c[key]}")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()),
              f"{name}: moments not finite")
        _errs_bounded(em, ec, bounds, name)

    fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    check(fg._fused_mode(B128) == "step", "B=128 must run K2")
    fs.reset_launch_counts()
    st, wall = _timed(lambda: fg.fit(FIT_SEED, batch_size=B128, niter=N_B128,
                                     verbose=False, return_state=True),
                      torch)
    c = fs.launch_counts()
    counts.append(c)
    em, ec = errs(st.mean, st.cov, t)
    bounds = (1.5 * B128_MEAN_REF, 1.5 * B128_COV_REF)
    emit({"phase": "examples", "config": "gsm_fused_b128",
          "fitter": "FactorGSM(fused_score)", "D": D, "B": B128,
          "niter": N_B128, "launches": c, "n_accepted": int(st.n_accepted),
          "mean_err": em, "cov_err": ec, "mean_err_bound": bounds[0],
          "cov_err_bound": bounds[1], "iters_per_s": (N_B128 + 1) / wall})
    check(c["make_fused_eps_multistep"] > 0
          and c["eps_smallspace_panel"] == N_B128 + 1
          and c["eps_smallspace_large"] == 0,
          "B=128: K2 on the row-panel small space every step")
    _errs_bounded(em, ec, bounds, "FactorGSM(fused_score) at B=128")

    fb = FactorBaM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    fs.reset_launch_counts()
    st, wall = _timed(lambda: fb.fit(
        FIT_SEED, Regularizers().linear(BAM_REGF0), batch_size=B128,
        niter=N_BAM128, verbose=False, retries=0, return_state=True), torch)
    c = fs.launch_counts()
    counts.append(c)
    emit({"phase": "examples", "config": "bam_fused_b128",
          "fitter": "FactorBaM(fused_score)", "D": D, "B": B128,
          "niter": N_BAM128, "launches": c, "fit_counts": dict(fb.fit_counts),
          "n_accepted": int(st.n_accepted), "errs": list(errs(st.mean, st.cov,
                                                               t)),
          "iters_per_s": (N_BAM128 + 1) / wall})
    check(c["make_fused_bam_multistep"] > 0 and c["bam_smallspace_panel"] > 0
          and c["bam_smallspace"] == 0,
          "BaM at B=128: K8 on the row-panel small space")
    check(bool(torch.isfinite(st.mean).all() and torch.isfinite(st.cov).all()),
          "BaM at B=128: moments not finite")
    check(bool(torch.linalg.eigvalsh(st.cov).min() > 0),
          "BaM at B=128: covariance not PD")

    fs.reset_launch_counts()
    st, wall = _timed(lambda: fg.fit(FIT_SEED, batch_size=B256, niter=N_B256,
                                     verbose=False, return_state=True),
                      torch)
    c = fs.launch_counts()
    counts.append(c)
    emit({"phase": "examples", "config": "gsm_fused_b256",
          "fitter": "FactorGSM(fused_score)", "D": D, "B": B256,
          "niter": N_B256, "launches": c, "n_accepted": int(st.n_accepted),
          "errs": list(errs(st.mean, st.cov, t)),
          "iters_per_s": (N_B256 + 1) / wall})
    check(c["eps_smallspace_large"] == N_B256 + 1
          and c["eps_smallspace_panel"] == 0,
          "B=256: K2 on the grid small space every step")
    check(bool(torch.isfinite(st.mean).all() and torch.isfinite(st.cov).all()),
          "FactorGSM at B=256: moments not finite")
    return counts


def _zoo_target(name, d, models, dev):
    if name == "student_t":
        return models.student_t(TARGET_SEED, d, df=ZOO_DF, device=dev)
    if name == "mixture":
        return models.gaussian_mixture(TARGET_SEED, d, device=dev)
    if name == "logreg":
        return models.logistic_regression(TARGET_SEED, d, device=dev)
    return getattr(models, name)(d, device=dev)


ZOO = {"funnel": "funnel_score", "banana": "banana_score",
       "student_t": "student_t_score", "mixture": "mixture_score",
       "logreg": "logreg_score"}


def _zoo_cases(name, models, dev, np):
    """Phase 19's inputs for one zoo target, (case, B, D, target, scale of
    every other row of x): ZOO_SHAPES on the target, then the K11b
    kernels' own cases."""
    cases = [("", b, d, _zoo_target(name, d, models, dev), 1.0)
             for b, d in ZOO_SHAPES]
    if name == "mixture":
        means = models.gaussian_mixture(TARGET_SEED, D, device="cpu")
        means = means.fused_score[1][0].numpy()
        k = means.shape[0]
        pad = np.concatenate([means, np.repeat(means[:1], 8 - k, axis=0)])
        mask = np.where(np.arange(8) < k, 0.0, -1e30)[None]
        cases += [
            ("padded K=8", B, D, models.gaussian_mixture_from_arrays(
                pad, mask.astype(np.float32), device=dev), 1.0),
            ("K=1024", 3, 10, models.gaussian_mixture(
                TARGET_SEED, 10, n_components=1024, device=dev), 1.0),
            ("separation 0.3", B, D, models.gaussian_mixture(
                TARGET_SEED, D, separation=0.3, device=dev), 1.0)]
    if name == "logreg":
        cases += [
            ("N=1", B, D, models.logistic_regression(
                TARGET_SEED, D, n_data=1, device=dev), 1.0),
            ("N=4096", 3, 10, models.logistic_regression(
                TARGET_SEED, 10, n_data=4096, device=dev), 1.0),
            ("saturated", B, D, _zoo_target(name, D, models, dev),
             ZOO_SATURATE)]
    return cases


# The kernels each zoo score runs on the card, by name (torch.profiler).
ZOO_KERNELS = {"funnel_score": "funnel_score_kernel",
               "banana_score": "banana_score_kernel",
               "student_t_score": "student_t_kernel",
               "mixture_score": "mixture_score_kernel",
               "logreg_score": "logreg_kernel"}


def zoo_yardsticks(name, x, params, torch) -> dict:
    """The library yardsticks of a zoo score, one PyTorch call each for a
    part of it: (x - loc) prec for the Student-t, x M^T for the mixture,
    w X^T and then resid X (resid of shape (B, N)) for logreg."""
    if name == "student_t":
        loc, prec = params[0], params[1]
        lp = loc @ prec
        return {"first": lambda: torch.addmm(lp, x, prec, beta=-1.0)}
    if name == "mixture":
        mt = params[0].T
        return {"first": lambda: torch.mm(x, mt)}
    if name == "logreg":
        xd = params[0]
        resid = torch.rand((x.shape[0], xd.shape[0]), device=x.device)
        return {"first": lambda: torch.mm(x, xd.T),
                "second": lambda: torch.mm(resid, xd)}
    return {}


def phase_zoo_kernels(fs, models, torch, np):
    """Phase 19: each zoo kernel against its plain version at ZOO_SHAPES
    and the K11b kernels' own cases (``_zoo_cases``); then per-call times
    at the path's shape, by CUDA events and on the device, beside the
    library yardsticks' (``zoo_yardsticks``); each score must run its one
    kernel alone.  Returns (worst, times, work, library, device,
    library_device, extra)."""
    dev = torch.device("cuda")
    worst = {k: 0.0 for k in ZOO.values()}
    times, work, library, device, library_device, extra = {}, {}, {}, {}, \
        {}, {}
    for name, key in ZOO.items():
        plain = getattr(fs, f"{key}_reference")
        for case, b, d, t, scale in _zoo_cases(name, models, dev, np):
            score_fn, params = t.fused_score
            rng = np.random.default_rng(7000 + b + d)
            x = rng.standard_normal((b, d)).astype(np.float32)
            x[:, 0] = rng.uniform(-3.0, 3.0, b)
            x[::2] *= scale
            x = torch.from_numpy(x).to(dev)
            v_k = score_fn(x, *params)
            v_p = plain(x, *params)
            torch.cuda.synchronize()
            err = float((v_k - v_p).abs().max())
            tol = ZOO_TOL[key] * max(1.0, float(v_p.abs().max()))
            rec = {"phase": "zoo_kernels", "kernel": key, "case": case,
                   "B": b, "D": d, "params": [list(p.shape) for p in params],
                   "v_err": err}
            if name == "mixture":
                v64 = plain(x.double(), *(p.double() for p in params))
                floor = float((v_p.double() - v64).abs().max())
                rec["plain_err_f64"] = floor
                tol = max(tol, ZOO_FLOOR * floor)
            if name == "logreg":
                z = x @ params[0].T
                rec["rows_saturated"] = int((z.abs() > 100).any(1).sum())
                check(case != "saturated" or rec["rows_saturated"] > 0,
                      "logreg: the saturated case has no |z| > 100")
            emit({**rec, "v_tol": tol})
            check(bool(torch.isfinite(v_k).all()) and err <= tol,
                  f"{key} disagrees with its plain version: {rec}")
            worst[key] = max(worst[key], err)
            if (case, b, d) == ("", B, D):
                run = lambda x=x, p=params, f=score_fn: f(x, *p)
                times[key] = (cuda_ms(run, reps=200),
                              cuda_ms(lambda: plain(x, *params), reps=200))
                work[key] = (lambda x=x, p=params, f=plain: f(x, *p),
                             (x, *params))
                device[key], names = device_ms(run)
                check(names and all(ZOO_KERNELS[key] in n for n in names),
                      f"{key} runs other kernels: {names}")
                sticks = zoo_yardsticks(name, x, params, torch)
                if "first" in sticks:
                    library[key] = cuda_ms(sticks["first"], reps=200)
                    library_device[key] = device_ms(sticks["first"])[0]
                if "second" in sticks:
                    extra[key] = {
                        "library_second_ms": cuda_ms(sticks["second"],
                                                     reps=200),
                        "library_second_device_ms": device_ms(
                            sticks["second"])[0]}
    one = torch.empty(1, device=dev)
    emit({"phase": "zoo_times", "B": B, "D": D,
          "launch_floor_device_ms": device_ms(lambda: one.fill_(1.0))[0],
          "ms_per_call": {
              k: {"kernel": a, "plain": p, "device": device.get(k),
                  "library": library.get(k),
                  "library_device": library_device.get(k),
                  **extra.get(k, {})}
              for k, (a, p) in times.items()}})
    return worst, times, work, library, device, library_device, extra


def _zoo_errs(name, t, mean, cov, np) -> tuple:
    """(mean_err, cov_err, record) of a zoo fit: against the analytic
    moments; the mixture's against the component the fit lands in (and, in
    the record only, against the mixture's moments); logreg's against the
    Laplace approximation on its own arrays."""
    m, c = (a.double().cpu().numpy() for a in (mean, cov))
    if name == "mixture":
        means = t.fused_score[1][0].double().cpu().numpy()
        em, ec = nearest_component_errs(m, c, means)
        mix = moment_errs(m, c, t.mean.double().cpu().numpy(),
                          t.cov.double().cpu().numpy())
        return em, ec, {"mixture_moment_errs": list(mix)}
    if name == "logreg":
        xd, y, inv_ps2 = (p.double().cpu().numpy() for p in t.fused_score[1])
        w_map, cov_lap = laplace_moments(xd, y[0], float(inv_ps2[0, 0]) ** -0.5)
        return (*moment_errs(m, c, w_map, cov_lap), {})
    return (*errs(mean, cov, t), {})


def phase_zoo_paths(FactorGSM, FactorBaM, ADVI, Regularizers, fs, models,
                    card, torch, np):
    """Phase 20: FactorGSM(fused_score=t.fused_score) on funnel(256),
    banana(256), student_t(0, 256, df=6), gaussian_mixture(0, 256) and
    logistic_regression(0, 256) at B=32, spc=8 (K2 with the zoo kernel
    inside each sub-step); then one FactorBaM(fused_score) (K8) and one
    ADVI.fit_fused (K9) run per target.  Returns each run's counts."""
    dev = torch.device("cuda")
    counts = []
    for name, key in ZOO.items():
        t = _zoo_target(name, D, models, dev)
        fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                       device="cuda")
        check(fg._fused_mode(B) == "step" and fg.steps_per_call == 8,
              f"{name}: the zoo path must run K2 at spc=8")
        fs.reset_launch_counts()
        st, wall = _timed(lambda: fg.fit(FIT_SEED, batch_size=B, niter=N_ZOO,
                                         verbose=False, return_state=True),
                          torch)
        c = fs.launch_counts()
        counts.append(c)
        cov = st.cov.double()
        pd = bool(torch.linalg.eigvalsh(0.5 * (cov + cov.T)).min() > 0)
        rec = {"phase": "zoo_path", "target": t.name,
               "fitter": "FactorGSM(fused_score)", "D": D, "B": B,
               "niter": N_ZOO, "spc": fg.steps_per_call,
               "k2_launches": c["make_fused_eps_multistep"],
               "score_launches": c[key], "n_accepted": int(st.n_accepted),
               "finite": bool(torch.isfinite(st.mean).all()
                              and torch.isfinite(st.cov).all()),
               "pd": pd, "iters_per_s": (N_ZOO + 1) / wall, "card": card}
        if name in ZOO_WORST:
            em, ec, more = _zoo_errs(name, t, st.mean, st.cov, np)
            rec.update(mean_err=em, cov_err=ec,
                       mean_err_bound=1.5 * ZOO_WORST[name][0],
                       cov_err_bound=1.5 * ZOO_WORST[name][1], **more)
        emit(rec)
        check(c["make_fused_eps_multistep"] > 0 and c[key] > 0,
              f"{name}: K2 and {key} must launch")
        check(c["gsm_eps_update_fused"] == 0 and c["gaussian_score"] == 0,
              f"{name}: another score or update kernel ran")
        check(rec["finite"] and pd, f"{name}: fit not finite and PD")
        if name in ZOO_WORST:
            _errs_bounded(rec["mean_err"], rec["cov_err"],
                          (rec["mean_err_bound"], rec["cov_err_bound"]),
                          f"zoo path {name}")
        emit({"phase": "zoo_graph", "target": t.name, **graph_vs_eager(
            fg, lambda: fg.fit(FIT_SEED, batch_size=B, niter=N_ZOO,
                               verbose=False, return_state=True),
            st, wall, N_ZOO + 1, fg._get_runner(B, "step"), torch)})

        fb = FactorBaM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                       device="cuda")
        fs.reset_launch_counts()
        sb, wall = _timed(lambda: fb.fit(
            FIT_SEED, Regularizers().linear(BAM_REGF0), batch_size=B,
            niter=N_ZOO_SIDE, verbose=False, retries=0, return_state=True),
            torch)
        cb = fs.launch_counts()
        counts.append(cb)
        ga = ADVI(D, t.lp, fused_score=t.fused_score, device="cuda")
        fs.reset_launch_counts()
        (sa, _), wall_a = _timed(lambda: ga.fit_fused(
            FIT_SEED, learning_rate=ADVI_LR, batch_size=B, niter=N_ZOO_SIDE,
            verbose=False, return_state=True), torch)
        ca = fs.launch_counts()
        counts.append(ca)
        ga.cuda_graph = False
        sa_e, _ = ga.fit_fused(FIT_SEED, learning_rate=ADVI_LR, batch_size=B,
                               niter=N_ZOO_SIDE, verbose=False,
                               return_state=True)
        ga.cuda_graph = True
        k9_blocks = ga._fused_runner(B, ADVI_LR, 0.9, 0.999, 1e-8,
                                     "analytic").blocks
        check(all(torch.equal(x, y) for x, y in zip(sa[:-2], sa_e[:-2])),
              f"{name}: ADVI.fit_fused on graph blocks differs from eager")
        check(k9_blocks.captures >= 1,
              f"{name}: the K9 block with {key} was not captured")
        emit({"phase": "zoo_path", "target": t.name, "side_fits": {
            "FactorBaM(fused_score)": {
                "niter": N_ZOO_SIDE, "k8_launches":
                    cb["make_fused_bam_multistep"], "score_launches": cb[key],
                "fit_counts": dict(fb.fit_counts),
                "iters_per_s": (N_ZOO_SIDE + 1) / wall},
            "ADVI.fit_fused": {
                "niter": N_ZOO_SIDE, "k9_launches":
                    ca["make_fused_advi_multistep"], "score_launches": ca[key],
                "graph_equals_eager": True,
                "captures": k9_blocks.captures,
                "iters_per_s": (N_ZOO_SIDE + 1) / wall_a}}})
        check(cb["make_fused_bam_multistep"] > 0 and cb[key] > 0,
              f"{name}: FactorBaM must run K8 with {key}")
        check(ca["make_fused_advi_multistep"] > 0 and ca[key] > 0,
              f"{name}: ADVI.fit_fused must run K9 with {key}")
        check(bool(torch.isfinite(sb.mean).all()
                   and torch.isfinite(sb.cov).all()
                   and torch.isfinite(sa.loc).all()
                   and torch.isfinite(sa.l).all()),
              f"{name}: FactorBaM or ADVI.fit_fused not finite")
    return counts


# Phase 21: the surface at the headline width, the flow of the reference's
# examples/example_initializers.py on dense_gaussian(0, 256): lbfgs_init
# from ones(D), then GSM.fit under a KLMonitor (batch_size_kl=32,
# checkpoint=10, offset_evals=res.nfev) at B=32 for N_ITER steps, then
# ADVI.fit under a second monitor (B=32, N_SURFACE_ADVI steps) at
# Adam(SURFACE_ADVI_LR): from this warm start Adam(1e-2)'s noise on the
# 32,896 parameters outruns the ELBO's gradient at D=256 (its reverse KL
# rose 633 -> 838 over 1000 steps on an H100), Adam(1e-3)'s falls.
# A monitor gets one entry per checkpoint and one after the loop, as the
# JAX package's monitor does (tests/test_torch_surface.py holds the lengths
# and nevals against it).  The posterior's float32 log density is held to
# its float64 evaluation on the same (mean, chol) within POST_LP_RTOL of
# the largest |log p|; the checkpoint is taken after CKPT_STEP steps, a
# whole number of spc=8 blocks.
SURFACE_KL_BATCH, SURFACE_CHECKPOINT = 32, 10
N_SURFACE_ADVI, SURFACE_ADVI_LR = 1000, 1e-3
POST_DRAWS, POST_LP_RTOL = 1024, 1e-4
CKPT_STEP = 1600


def monitor_cadence(niter: int, checkpoint: int) -> int:
    """Entries a monitor gets over a fit: one per checkpoint i = 0,
    checkpoint, ... <= niter, and one after the loop."""
    return niter // checkpoint + 2


def _monitor_record(mon, niter: int, nfev: int, np) -> dict:
    rkl = np.asarray(mon.rkl, np.float64)
    return {"entries": [len(mon.rkl), len(mon.fkl), len(mon.nevals)],
            "cadence": monitor_cadence(niter, mon.checkpoint),
            "rkl_first": float(rkl[0]), "rkl_last": float(rkl[-1]),
            "rkl_finite": bool(np.isfinite(rkl).all()),
            "nevals_first": mon.nevals[0], "nevals_last": mon.nevals[-1],
            "nfev": nfev}


def _check_monitor(rec: dict, what: str) -> None:
    check(rec["entries"] == [rec["cadence"]] * 3,
          f"{what}: monitor entries {rec['entries']} != cadence "
          f"{rec['cadence']}")
    check(rec["rkl_finite"] and rec["rkl_last"] < rec["rkl_first"],
          f"{what}: reverse KL not finite or not falling {rec}")
    check(rec["nevals_first"] == rec["nfev"] + 1,
          f"{what}: nevals must start at the L-BFGS cost {rec}")


def phase_surface(GSM, ADVI, Adam, FactorGSM, fs, t, st3, torch, np):
    """Phase 21: lbfgs_init, GSM.fit and ADVI.fit under KL monitors,
    Posterior.from_fit (log_prob against float64, save/load bit for bit)
    and a FactorGSM(fused_score) checkpoint resumed to phase 3's state bit
    for bit.  Returns the launch counts of the monitored GSM fit and of the
    resumed fit's two halves."""
    import tempfile

    from gsmvi_tpu_torch import (KLMonitor, Posterior, lbfgs_init,
                                 load_state, save_state)
    from gsmvi_tpu_torch.distributions import mvn_logpdf

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mean0, cov0, res = lbfgs_init(np.ones(D), t.lp, t.lp_g, device=dev)
    lbfgs_s = time.perf_counter() - t0
    em0, _ = moment_errs(mean0, cov0, *(a.cpu().numpy().astype(np.float64)
                                        for a in (t.mean, t.cov)))
    check(bool(res.success) and np.isfinite(cov0).all(),
          f"lbfgs_init failed: {res.message}")

    mon = KLMonitor(batch_size_kl=SURFACE_KL_BATCH,
                    checkpoint=SURFACE_CHECKPOINT, offset_evals=res.nfev)
    g = GSM(D, t.lp, t.lp_g, device=dev)
    fs.reset_launch_counts()
    (mean, cov), wall = _timed(lambda: g.fit(
        FIT_SEED, mean=mean0, cov=cov0, batch_size=B, niter=N_ITER,
        verbose=False, monitor=mon), torch)
    gsm_counts = fs.launch_counts()
    em, ec = errs(mean, cov, t)
    rec_gsm = _monitor_record(mon, N_ITER, res.nfev, np)
    emit({"phase": "surface", "step": "lbfgs_gsm", "D": D, "B": B,
          "niter": N_ITER, "lbfgs_nfev": res.nfev, "lbfgs_nit": res.nit,
          "lbfgs_s": lbfgs_s, "lbfgs_mean_err": em0,
          "k1_launches": gsm_counts["gsm_eps_update_fused"],
          "monitor": rec_gsm, "mean_err": em, "cov_err": ec,
          "iters_per_s_with_monitor": (N_ITER + 1) / wall})
    _check_monitor(rec_gsm, "GSM.fit")
    check(gsm_counts["gsm_eps_update_fused"] == N_ITER + 1,
          "the monitored GSM.fit must launch K1 once per step")
    check(em < MEAN_ERR_BOUND and ec < COV_ERR_BOUND,
          "the monitored GSM.fit did not converge under the GSM bound")

    mon2 = KLMonitor(batch_size_kl=SURFACE_KL_BATCH,
                     checkpoint=SURFACE_CHECKPOINT, offset_evals=res.nfev)
    a = ADVI(D, t.lp, device=dev)
    (am, ac, losses), wall = _timed(lambda: a.fit(
        FIT_SEED, Adam(SURFACE_ADVI_LR), mean=mean0, cov=cov0,
        batch_size=B, niter=N_SURFACE_ADVI, verbose=False, monitor=mon2),
        torch)
    rec_advi = _monitor_record(mon2, N_SURFACE_ADVI, res.nfev, np)
    ema, eca = errs(am, ac, t)
    emit({"phase": "surface", "step": "lbfgs_advi", "D": D, "B": B,
          "niter": N_SURFACE_ADVI, "monitor": rec_advi, "mean_err": ema,
          "cov_err": eca, "losses_finite": bool(np.isfinite(losses).all()),
          "iters_per_s_with_monitor": (N_SURFACE_ADVI + 1) / wall})
    _check_monitor(rec_advi, "ADVI.fit")

    post = Posterior.from_fit(mean, cov)
    x = post.sample(7, POST_DRAWS)
    lp32 = post.log_prob(x)
    lp64 = mvn_logpdf(x.double(), post.mean.double(), post.chol.double())
    lp_err = float((lp32.double() - lp64).abs().max())
    lp_tol = POST_LP_RTOL * max(1.0, float(lp64.abs().max()))
    with tempfile.TemporaryDirectory() as tmp:
        post.save(os.path.join(tmp, "posterior"))
        back = Posterior.load(os.path.join(tmp, "posterior"), device=dev)
        same = bool(torch.equal(back.mean, post.mean)
                    and torch.equal(back.chol, post.chol))

        # Checkpoint and resume: the K2 fit of phase 3 cut after CKPT_STEP
        # steps.
        fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                       device=dev)
        fs.reset_launch_counts()
        half = fg.fit(FIT_SEED, batch_size=B, niter=CKPT_STEP - 1,
                      verbose=False, return_state=True)
        save_state(os.path.join(tmp, "state"), half)
        loaded = load_state(os.path.join(tmp, "state"), device=dev)
        done = fg.fit(FIT_SEED, batch_size=B, niter=N_ITER - CKPT_STEP,
                      verbose=False, return_state=True, state=loaded)
        ckpt_counts = fs.launch_counts()
    resumed = bool(torch.equal(done.mean, st3.mean)
                   and torch.equal(done.factor, st3.factor)
                   and int(done.n_accepted) == int(st3.n_accepted)
                   and done.step == st3.step)
    emit({"phase": "surface", "step": "posterior_checkpoint",
          "log_prob_err": lp_err, "log_prob_tol": lp_tol,
          "save_load_bitwise": same, "checkpoint_step": CKPT_STEP,
          "resumed_step": done.step, "resumed_equals_phase3": resumed,
          "k2_launches": ckpt_counts["make_fused_eps_multistep"]})
    check(bool(torch.isfinite(lp32).all()) and lp_err <= lp_tol,
          f"Posterior.log_prob vs float64: {lp_err} > {lp_tol}")
    check(same, "Posterior save/load is not bit for bit")
    check(resumed, "the resumed FactorGSM fit differs from phase 3's")
    return [gsm_counts, ckpt_counts]


# Phase 22: replicas.  K7 over stacked replicas against its plain version
# (``bam_eps_update_replicas_reference``) and against K7 on each replica
# alone (bit for bit) at BAM_REPLICA_SHAPES, K in (1, 8); K = 8 runs the
# four NS tiers side by side, replica 5 on a two-sweep tier with open gates
# (its residual gates reject), replica 6 on a tier whose lmax gate every
# input passes over (stiff), at one shared reg.  Then FactorBaM.fit_batch
# (K7's replica axis) over seeds 0..7, and BaM.fit_batch and ADVI.fit_batch
# over seeds 0..3 at D=256, B=32: replicas 0 and 1 equal to their single
# fits bit for bit, every replica under its bound.  BaM's and ADVI's
# replicas run their steps one replica after another (ADVI's autograd step
# and BaM's dense step at ~3.5 and ~4 ms a replica-step on an H100, host
# bound), so they run N_REPLICA_DENSE steps, not phase 5's and 8's.  Their
# bounds are 1.5 x the worst of 8 JAX CPU fit_batch replicas of the same
# arrays, niter, batch and schedule (tools/jax_fit_batch_bound.py
# --niter 500): BaM(use_factor=False) with retries=0 and BAM_REGF0, mean_err
# 6.7792e-3, cov_err 7.2138e-4; ADVI with adam(ADVI_LR), 1.29951 and
# 0.995514.
BAM_REPLICA_SHAPES = ((2, 10), (B, D), (56, D), (128, D))
BAM_REPLICA_KS = (1, 8)
BAM_REPLICA_REG = 0.5
REPLICA_K, REPLICA_K_DENSE, N_REPLICA_DENSE = 8, 4, 500
BAM_DENSE_MEAN_ERR_BOUND = 1.5 * 6.7792e-3
BAM_DENSE_COV_ERR_BOUND = 1.5 * 7.2138e-4
ADVI_BATCH_MEAN_ERR_BOUND = 1.5 * 1.29951
ADVI_BATCH_COV_ERR_BOUND = 1.5 * 0.995514


def bam_replica_cases(bf, np, b: int, d: int, k: int):
    """(eps, v, mu, f) stacked over ``k`` replicas (numpy float32) and each
    replica's NS tier (iters, gu_gate, lmax_gate)."""
    rng = np.random.default_rng(7000 + 31 * b + d + k)
    arrays, tiers = [], []
    for i in range(k):
        e = rng.standard_normal((b, d)).astype(np.float32)
        f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))
             ).astype(np.float32)
        mu = rng.standard_normal(d).astype(np.float32)
        v = (0.05 * rng.standard_normal((b, d))).astype(np.float32)
        arrays.append((e, v, mu, f))
        tier = bf.BAM_NS_TIERS[i % len(bf.BAM_NS_TIERS)]
        if k > 1 and i == 5:
            tier = (_SHORT_ITERS, float("inf"), float("inf"))
        if k > 1 and i == 6:
            tier = (bf.BAM_NS_ITERS_DEFAULT, bf.GU_GATE_DEFAULT, 1e-3)
        tiers.append(tier)
    return [np.stack(x) for x in zip(*arrays)], tiers


def phase_bam_replica_kernels(bf, torch, np):
    """K7's replica axis against its plain version and against single K7
    calls; returns the worst error against the plain version."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = 0.0
    for b, d in BAM_REPLICA_SHAPES:
        for k in BAM_REPLICA_KS:
            arrays, tiers = bam_replica_cases(bf, np, b, d, k)
            e, v, mu, f = (cu(x) for x in arrays)
            reg = BAM_REPLICA_REG
            got = bf.bam_eps_update_replicas(e, v, mu, f, reg, tiers)
            want = bf.bam_eps_update_replicas_reference(e, v, mu, f, reg,
                                                        tiers)
            singles = [bf.bam_eps_update_fused(
                e[i], v[i], mu[i], f[i], reg, iters=tiers[i][0],
                gu_gate=tiers[i][1], lmax_gate=tiers[i][2])
                for i in range(k)]
            torch.cuda.synchronize()
            em, tm = _bam_close(got[0], want[0], BAM_TOL)
            ef_, tf = _bam_close(got[1], want[1], BAM_TOL)
            keep, stiff = got[2].tolist(), got[3].tolist()
            bitwise = all(
                torch.equal(got[0][i], s[0]) and torch.equal(got[1][i], s[1])
                and bool(got[2][i]) == bool(s[2])
                and bool(got[3][i]) == bool(s[3])
                and torch.equal(got[4][i], s[4])
                for i, s in enumerate(singles))
            rec = {"kernel": "bam_eps_update_replicas", "B": b, "D": d,
                   "K": k, "tiers": [list(t[0]) for t in tiers],
                   "keep": [keep, want[2].tolist()],
                   "stiff": [stiff, want[3].tolist()], "mean_err": em,
                   "mean_tol": tm, "f_err": ef_, "f_tol": tf,
                   "equals_single_k7": bitwise}
            emit({"phase": "bam_replica_kernels", **rec})
            check(keep == want[2].tolist() and stiff == want[3].tolist(),
                  f"replica K7 flags {rec}")
            check(np.allclose(got[4].cpu().numpy(), want[4].cpu().numpy(),
                              rtol=BAM_STATS_RTOL, atol=0),
                  f"replica K7 stats {rec}")
            check(em <= tm and ef_ <= tf,
                  f"replica K7 disagrees with its plain version: {rec}")
            check(bitwise, f"replica K7 differs from single K7 calls: {rec}")
            if k > 1:
                check(keep[0] and keep[1] and not keep[5] and not stiff[5]
                      and stiff[6],
                      f"replica K7 cases missed their design: {rec}")
            for i in range(k):
                if not keep[i]:
                    check(torch.equal(got[0][i], mu[i])
                          and torch.equal(got[1][i], f[i]),
                          "replica K7 must return a replica's old state "
                          "unless it keeps")
            worst = max(worst, em, ef_)
    return worst


def phase_bam_replica_times(bf, torch, np):
    """Per-call times of K7's replica axis at K=8, (32, 256) on the long
    profile, beside eight single K7 calls on the same inputs (CUDA events
    and device time) and the plain version; the bound's inputs."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    arrays, _ = bam_replica_cases(bf, np, B, D, REPLICA_K)
    e, v, mu, f = (cu(x) for x in arrays)
    reg = BAM_REPLICA_REG
    rep = lambda: bf.bam_eps_update_replicas(e, v, mu, f, reg)
    singles = lambda: [bf.bam_eps_update_fused(e[i], v[i], mu[i], f[i], reg)
                       for i in range(REPLICA_K)]
    plain = lambda: bf.bam_eps_update_replicas_reference(e, v, mu, f, reg)
    ms, ms_singles = cuda_ms(rep), cuda_ms(singles, reps=20)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    dev_ms, names = device_ms(rep, calls=20)
    dev_singles, _ = device_ms(singles, calls=10)
    emit({"phase": "bam_replica_times", "B": B, "D": D, "K": REPLICA_K,
          "ms_per_call": {"replicas": ms, "eight_single_k7": ms_singles,
                          "plain": plain_ms},
          "device_ms": {"replicas": dev_ms, "eight_single_k7": dev_singles},
          "kernels": names})
    joined = " ".join(names)
    check("bam_cluster_kernel" in joined and "apply_f32_kernel" in joined
          and "gemm_kernel" not in joined,
          f"replica K7 must run the BaM cluster kernel and apply_f32_kernel,"
          f" never the 32x32 template: {names}")
    times = {"bam_eps_update_replicas": (ms, plain_ms)}
    work = {"bam_eps_update_replicas": (plain, (e, v, mu, f))}
    extra = {"bam_eps_update_replicas": {
        "K": REPLICA_K, "ms_eight_single_k7": ms_singles,
        "device_ms_eight_single_k7": dev_singles}}
    return times, work, {"bam_eps_update_replicas": dev_ms}, extra


def _equal_states(a, b, fields) -> bool:
    return all(torch_equal(getattr(a, x), getattr(b, x)) for x in fields)


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y)) if torch.is_tensor(x) else x == y


def phase_replica_paths(BaM, FactorBaM, ADVI, Adam, Regularizers, fs, t,
                        torch):
    """Phase 22's fits: FactorBaM.fit_batch on K7's replica axis, then
    BaM.fit_batch and ADVI.fit_batch.  Returns the launch counts of the
    FactorBaM replica fit."""
    from gsmvi_tpu_torch.ops.gsm_factor import factor_to_cov
    from gsmvi_tpu_torch.state import replica

    dev = torch.device("cuda")
    regf = Regularizers().linear(BAM_REGF0)
    fb = FactorBaM(D, t.lp, t.lp_g, device=dev)
    check(fb._fused_mode(B) == "update",
          "FactorBaM.fit_batch must run K7's update mode")
    seeds = tuple(range(REPLICA_K))
    fb.fit_batch((11, 12), regf, batch_size=B, niter=20, retries=0)  # warm up
    fs.reset_launch_counts()
    st, wall = _timed(lambda: fb.fit_batch(
        seeds, regf, batch_size=B, niter=N_BAM, retries=0,
        return_state=True), torch)
    counts = fs.launch_counts()
    fc = dict(fb.fit_counts)
    ips = (N_BAM + 1) / wall
    singles, walls = [], []
    for seed in seeds[:2]:
        s, w = _timed(lambda: fb.fit(seed, regf, batch_size=B, niter=N_BAM,
                                     verbose=False, retries=0,
                                     return_state=True), torch)
        singles.append(s)
        walls.append(w)
    fields = ("mean", "factor", "step", "n_accepted", "n_rejected",
              "ns_stats")
    equal = [_equal_states(replica(st, i), s, fields)
             for i, s in enumerate(singles)]
    covs = factor_to_cov(st.factor)
    errs_k = [errs(st.mean[i], covs[i], t) for i in range(REPLICA_K)]
    emit({"phase": "replica_path", "fitter": "FactorBaM.fit_batch",
          "K": REPLICA_K, "D": D, "B": B, "niter": N_BAM, "retries": 0,
          "replica_k7_launches": counts["bam_eps_update_replicas"],
          "single_k7_launches": counts["bam_eps_update_fused"],
          "fit_counts": fc, "replicas_equal_single": equal,
          "n_accepted": st.n_accepted.tolist(),
          "errs": errs_k, "iters_per_s_per_replica": ips,
          "aggregate_iters_per_s": REPLICA_K * ips,
          "single_k7_iters_per_s": [(N_BAM + 1) / w for w in walls]})
    check(counts["bam_eps_update_replicas"] == N_BAM + 1
          and fc["kernel_calls"] == N_BAM + 1
          and fc["report_reads"] == N_BAM + 1,
          "FactorBaM.fit_batch: one replica K7 launch and one read a step")
    check(counts["bam_eps_update_fused"] == 0
          and counts["make_fused_bam_multistep"] == 0,
          "FactorBaM.fit_batch launched single K7 or K8")
    check(all(equal), "FactorBaM.fit_batch replicas 0, 1 != fit(0), fit(1)")
    check(all(em < BAM_MEAN_ERR_BOUND and ec < BAM_COV_ERR_BOUND
              for em, ec in errs_k),
          f"a FactorBaM.fit_batch replica over the BaM bound: {errs_k}")

    seeds = tuple(range(REPLICA_K_DENSE))
    n = N_REPLICA_DENSE
    g = BaM(D, t.lp, t.lp_g, device=dev, use_factor=False)
    stb, wall = _timed(lambda: g.fit_batch(
        seeds, regf, batch_size=B, niter=n, retries=0, return_state=True),
        torch)
    equal = [_equal_states(replica(stb, i), g.fit(
        seed, regf, batch_size=B, niter=n, verbose=False, retries=0,
        return_state=True), ("mean", "cov", "chol", "n_accepted"))
        for i, seed in enumerate(seeds[:2])]
    errs_b = [errs(stb.mean[i], stb.cov[i], t) for i in range(len(seeds))]
    emit({"phase": "replica_path", "fitter": "BaM.fit_batch",
          "K": len(seeds), "D": D, "B": B, "niter": n, "retries": 0,
          "route": "dense, per replica", "replicas_equal_single": equal,
          "errs": errs_b, "mean_err_bound": BAM_DENSE_MEAN_ERR_BOUND,
          "cov_err_bound": BAM_DENSE_COV_ERR_BOUND,
          "iters_per_s_per_replica": (n + 1) / wall})
    check(all(equal), "BaM.fit_batch replicas 0, 1 != fit(0), fit(1)")
    check(all(em < BAM_DENSE_MEAN_ERR_BOUND and ec < BAM_DENSE_COV_ERR_BOUND
              for em, ec in errs_b),
          f"a BaM.fit_batch replica over its bound: {errs_b}")

    a = ADVI(D, t.lp, device=dev)
    (am, ac, losses), wall = _timed(lambda: a.fit_batch(
        seeds, Adam(ADVI_LR), batch_size=B, niter=n), torch)
    equal = []
    for i, seed in enumerate(seeds[:2]):
        m1, c1, l1 = a.fit(seed, Adam(ADVI_LR), batch_size=B, niter=n,
                           verbose=False)
        equal.append(bool(torch.equal(am[i], m1) and torch.equal(ac[i], c1)
                          and (losses[i] == l1).all()))
    errs_a = [errs(am[i], ac[i], t) for i in range(len(seeds))]
    emit({"phase": "replica_path", "fitter": "ADVI.fit_batch",
          "K": len(seeds), "D": D, "B": B, "niter": n,
          "losses_shape": list(losses.shape), "replicas_equal_single": equal,
          "errs": errs_a, "mean_err_bound": ADVI_BATCH_MEAN_ERR_BOUND,
          "cov_err_bound": ADVI_BATCH_COV_ERR_BOUND,
          "iters_per_s_per_replica": (n + 1) / wall})
    check(tuple(losses.shape) == (len(seeds), n + 1),
          "ADVI.fit_batch losses must be (K, niter + 1)")
    check(all(equal), "ADVI.fit_batch replicas 0, 1 != fit(0), fit(1)")
    check(all(em < ADVI_BATCH_MEAN_ERR_BOUND
              and ec < ADVI_BATCH_COV_ERR_BOUND for em, ec in errs_a),
          f"an ADVI.fit_batch replica over its bound: {errs_a}")
    return [counts]


# ---------------------------------------------------------------------------
# Phases 23-25: the host-callable routes, the tensor-core precisions, and
# FactorGSM's twophase and qr methods.
# ---------------------------------------------------------------------------

# Phase 23: the numpy-score GSM fit runs N_ITER steps under the GSM bound;
# the bit-for-bit comparison of a numpy wrapper of the tensor score with the
# tensor dense fit runs N_HOST_EQUAL; BaM(jit_compile=False) runs phase 22's
# dense BaM configuration (N_REPLICA_DENSE steps) under its bound.
N_HOST_EQUAL = 500


def phase_host_paths(GSM, BaM, FactorGSM, FactorBaM, Regularizers, fs, t,
                     torch, np):
    """Phase 23: ``GSM`` on dense_gaussian(0, 256)'s numpy score (the dense
    eager host loop: K5 once a step), a numpy wrapper of the tensor score
    equal to the tensor dense fit bit for bit, ``BaM(jit_compile=False)``
    on the numpy score, and the factor fitters' TypeError.  Returns the
    numpy-score GSM fit's launch counts."""
    dev = torch.device("cuda")
    _, params = t.fused_score
    mu_np, prec_np = (p.cpu().numpy() for p in params)
    lp_np = lambda x: (mu_np - x) @ prec_np
    g = GSM(D, None, lp_np, device=dev)
    check(g._host(B) and not g._factor_route(B, True) and g._dense_fused(B),
          "a numpy score must take the dense eager route on K5")
    fs.reset_launch_counts()
    (mean, cov), wall = _timed(lambda: g.fit(
        FIT_SEED, batch_size=B, niter=N_ITER, verbose=False), torch)
    c = fs.launch_counts()
    em, ec = errs(mean, cov, t)
    busy, wall_prof = busy_per_step(lambda: g.fit(
        FIT_SEED, batch_size=B, niter=DENSE_WINDOW - 1, verbose=False),
        DENSE_WINDOW)
    gt = GSM(D, t.lp, t.lp_g, use_factor=False, device=dev)
    _, wall_t = _timed(lambda: gt.fit(FIT_SEED, batch_size=B, niter=N_ITER,
                                      verbose=False), torch)
    busy_t, wall_prof_t = busy_per_step(lambda: gt.fit(
        FIT_SEED, batch_size=B, niter=DENSE_WINDOW - 1, verbose=False),
        DENSE_WINDOW)
    wrap = lambda x: t.lp_g(torch.as_tensor(x, device=dev)).cpu().numpy()
    kw = dict(batch_size=B, niter=N_HOST_EQUAL, verbose=False,
              return_state=True)
    same = _equal_states(GSM(D, t.lp, wrap, device=dev).fit(FIT_SEED, **kw),
                         gt.fit(FIT_SEED, **kw),
                         ("mean", "cov", "chol", "n_accepted"))
    emit({"phase": "host_path", "fitter": "GSM(numpy lp_g)", "D": D,
          "B": B, "niter": N_ITER, "route": "dense eager host loop, K5",
          "launches": {k: n for k, n in c.items() if n},
          "mean_err": em, "cov_err": ec, "mean_err_bound": MEAN_ERR_BOUND,
          "cov_err_bound": COV_ERR_BOUND,
          "iters_per_s": (N_ITER + 1) / wall,
          "device_busy_us_per_step": busy,
          "wall_us_per_step_profiled": wall_prof,
          "device_idle_share_profiled": 1.0 - busy / wall_prof,
          "tensor_route_iters_per_s": (N_ITER + 1) / wall_t,
          "tensor_route_device_busy_us_per_step": busy_t,
          "tensor_route_device_idle_share_profiled":
              1.0 - busy_t / wall_prof_t,
          "numpy_wrapper_equals_tensor_fit": same,
          "equal_niter": N_HOST_EQUAL})
    check(c["gsm_update_fused"] == N_ITER + 1
          and sum(c.values()) == N_ITER + 1,
          f"numpy-score GSM: K5 must launch once a step and alone: {c}")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()),
          "numpy-score GSM fit not finite")
    check(em < MEAN_ERR_BOUND and ec < COV_ERR_BOUND,
          "numpy-score GSM fit over the GSM bound")
    check(same, "a numpy wrapper of the tensor score != the tensor dense fit")

    regf = Regularizers().linear(BAM_REGF0)
    bm = BaM(D, None, lp_np, jit_compile=False, device=dev)
    check(not bm._factor_route(bm._host(B)),
          "BaM(jit_compile=False) must run the dense eager loop")
    fs.reset_launch_counts()
    (mb, cb), wall_b = _timed(lambda: bm.fit(
        FIT_SEED, regf, batch_size=B, niter=N_REPLICA_DENSE, verbose=False,
        retries=0), torch)
    cbam = fs.launch_counts()
    emb, ecb = errs(mb, cb, t)
    busy_b, wall_prof_b = busy_per_step(lambda: bm.fit(
        FIT_SEED, regf, batch_size=B, niter=DENSE_WINDOW - 1, verbose=False,
        retries=0), DENSE_WINDOW)
    emit({"phase": "host_path", "fitter": "BaM(jit_compile=False, numpy "
          "lp_g)", "D": D, "B": B, "niter": N_REPLICA_DENSE,
          "regf": f"linear({BAM_REGF0})", "retries": 0,
          "mean_err": emb, "cov_err": ecb,
          "mean_err_bound": BAM_DENSE_MEAN_ERR_BOUND,
          "cov_err_bound": BAM_DENSE_COV_ERR_BOUND,
          "iters_per_s": (N_REPLICA_DENSE + 1) / wall_b,
          "device_busy_us_per_step": busy_b,
          "wall_us_per_step_profiled": wall_prof_b,
          "device_idle_share_profiled": 1.0 - busy_b / wall_prof_b})
    check(sum(cbam.values()) == 0, f"the dense BaM step ran a kernel: {cbam}")
    check(emb < BAM_DENSE_MEAN_ERR_BOUND and ecb < BAM_DENSE_COV_ERR_BOUND,
          "BaM(jit_compile=False) over the dense BaM bound")

    refused = []
    for cls, args in ((FactorGSM, ()), (FactorBaM, (regf,))):
        try:
            cls(D, None, lp_np, device=dev).fit(FIT_SEED, *args, niter=2,
                                                verbose=False)
        except TypeError:
            refused.append(cls.__name__)
    emit({"phase": "host_path", "refused_with_type_error": refused})
    check(refused == ["FactorGSM", "FactorBaM"],
          f"the factor fitters must refuse a numpy score: {refused}")
    return [c]


# Phase 24: the tensor-core products.  Kernel and plain version round the
# same float32 operands to the same bfloat16 values (round to nearest even
# on both), so each product of two of them is exact in float32 and the two
# differ only in their float32 sums over K terms (K = D for the row
# products, 2B for the fat apply; 3K at bf16x3): within PREC_SUM K 2^-24
# (|a| @ |b|) elementwise, the worst case of a recursive sum rounded to
# nearest (K u) plus one whose adds truncate (2 K u, the tensor cores').
# Against the float64 product each stays within its precision's operand
# bound plus that: 2^-8 (1 + 2^-8) |a| @ |b| at bf16, 2^-16 at bf16x3
# (tests/test_torch_options.py).
PREC_SHAPES = ((B, D), RAGGED, (128, D), (512, 1024))
# The fat apply's D edges besides (D % 4 != 0: its masked 4-byte path).
APPLY_EDGES = ((B, 1), (B, 33))
PREC_SUM = 4.0
PREC_PASSES = {"bf16": 1, "high": 3}
PREC_REL = {"bf16": 2.0 ** -8 * (1 + 2.0 ** -8), "high": 2.0 ** -16}
# The card's dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet).
BF16_FLOPS_PER_S = 989e12
# K1, K2, K4 and K6 at "high" against their plain versions: one update
# within 2^-14 x max(1, |F|) (the 2^-16 of bf16x3 on the products, carried
# through the small space), the spc=8 blocks within 8 x that.  At "bf16"
# a float32 sum-order difference can move an operand across a bfloat16
# rounding boundary, 2^-8 of that one term: one update (K1, K4) is held to
# BF16_UPDATE_SHARE of the plain versions' own bf16-vs-float32 distance on
# the same input, and no less than "high"'s; over the eight chained
# sub-steps of a K2/K6 block such flips compound until two bf16 chains that
# differ only in sum order lie as far apart as bf16 and float32 do
# (measured 0.26-1.31 x that distance on an NVIDIA H100), so a block is
# held to BF16_MULTI_SHARE of it.
HIGH_UPDATE_TOL = 2.0 ** -14
HIGH_MULTI_TOL = 8 * HIGH_UPDATE_TOL
BF16_UPDATE_SHARE, BF16_MULTI_SHARE = 0.5, 2.0
# The precisions' fits (FactorGSM(fused_score, pallas_precision=p) at D=256,
# B=32, N_ITER steps) under 1.5 x the worst of the port's plain-version fits
# on the CPU (K2's plain version at p, keys 0..7; JAX on the CPU computes
# float32 whatever the precision says): tools/option_bounds.py, "high"
# mean_err <= 1.4366e-3, cov_err <= 5.6536e-4 (the float32 route's size);
# "bf16" 0.15326 and 0.15463 (the fit settles at a bf16-biased moment).
HIGH_MEAN_REF, HIGH_COV_REF = 1.4366e-3, 5.6536e-4
BF16_MEAN_REF, BF16_COV_REF = 0.15326, 0.15463
PREC_FIT_WORST = {"high": (HIGH_MEAN_REF, HIGH_COV_REF),
                  "bf16": (BF16_MEAN_REF, BF16_COV_REF)}
N_PREC_K1 = 500
PREC_NAMES = ("thin_product_bf16", "thin_product_bf16x3", "factor_apply_bf16",
              "factor_apply_bf16x3")


def _abs_product(a, b):
    return a.abs().double() @ b.abs().double()


def phase_precision_kernels(fs, bfm, t, torch, np):
    """Phase 24a: the tensor-core thin product (both transposes, with x =
    mu + out) and fat apply (with its select) against their plain versions
    and the float64 product at PREC_SHAPES, a K=3 replica launch against
    single launches bit for bit; then K1, K4, K2 and K6 at "bf16" and
    "high" against their plain versions at (32, 256) and (8, 200).
    Returns the worst |kernel - plain| per variant."""
    dev = torch.device("cuda")
    cu = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    worst = {name: 0.0 for name in PREC_NAMES}
    for p in ("bf16", "high"):
        tag = fs.MMA_TAG[p]
        for m, d in PREC_SHAPES + APPLY_EDGES:
            rng = np.random.default_rng(2400 + m + d)
            rows = cu(rng.standard_normal((m, d)).astype(np.float32))
            f = cu((rng.standard_normal((d, d)) / np.sqrt(d))
                   .astype(np.float32))
            mu = cu(rng.standard_normal(d).astype(np.float32))
            su = cu(rng.standard_normal((2 * m, d)).astype(np.float32))
            sw = cu((0.1 * rng.standard_normal((2 * m, d)))
                    .astype(np.float32))
            cases = []
            for trans in (() if (m, d) in APPLY_EDGES else (False, True)):
                fb = f.T if trans else f
                if trans:
                    out, x = fs.thin_product(rows, f, trans=True, mu=mu,
                                             precision=p)
                    check(torch.equal(x, mu + out),
                          f"thin {tag}: x != mu + out")
                else:
                    out = fs.thin_product(rows, f, trans=False, precision=p)
                cases.append((f"thin_product_{tag}", f"trans={trans}", out,
                              fs.mm_prec(rows, fb, p), rows, fb, d))
            # The apply's sums on F = 0 (F + acc is then acc exactly); its
            # select on the random F.
            flag = torch.tensor(False, device=dev)
            check(torch.equal(fs.factor_apply(su, sw, f, flag, precision=p),
                              f), f"apply {tag}: a rejected update != F")
            flag = torch.tensor(True, device=dev)
            zero = torch.zeros_like(f)
            cases.append((f"factor_apply_{tag}", "apply",
                          fs.factor_apply(su, sw, zero, flag, precision=p),
                          fs.factor_apply_reference(su, sw, zero, flag, p),
                          su.T, sw, 2 * m))
            torch.cuda.synchronize()
            for name, case, got, want, a, b, k in cases:
                absprod = _abs_product(a, b)
                exact = a.double() @ b.double()
                sum_tol = PREC_SUM * PREC_PASSES[p] * k * 2.0 ** -24
                diff = (got.double() - want.double()).abs()
                dev_exact = (got.double() - exact).abs()
                err = float(diff.max())
                rec = {"kernel": name, "case": case, "M": m, "D": d,
                       "max_abs_err": err,
                       "max_rel_to_abs_product": float(
                           (diff / absprod.clamp_min(1e-30)).max()),
                       "sum_tol_rel": sum_tol,
                       "vs_float64_rel": float(
                           (dev_exact / absprod.clamp_min(1e-30)).max()),
                       "precision_tol_rel": PREC_REL[p] + sum_tol}
                emit({"phase": "precision_kernels", **rec})
                check(bool((diff <= sum_tol * absprod + 1e-30).all()),
                      f"{name} disagrees with its plain version: {rec}")
                check(bool((dev_exact <= (PREC_REL[p] + sum_tol) * absprod
                            + 1e-30).all()),
                      f"{name} is off its precision's bound: {rec}")
                worst[name] = max(worst[name], err)
        # The replica axis: K=3 stacked launches equal single launches.
        rng = np.random.default_rng(2499)
        rows = cu(rng.standard_normal((3, B, D)).astype(np.float32))
        fk = cu((rng.standard_normal((3, D, D)) / 16).astype(np.float32))
        su = cu(rng.standard_normal((3, 2 * B, D)).astype(np.float32))
        good = torch.tensor([True, False, True], device=dev)
        out_k = fs.thin_product(rows, fk, trans=True, precision=p)
        app_k = fs.factor_apply(su, su, fk, good, precision=p)
        same = all(torch.equal(out_k[i], fs.thin_product(
            rows[i], fk[i], trans=True, precision=p)) and torch.equal(
            app_k[i], fs.factor_apply(su[i], su[i], fk[i], good[i],
                                      precision=p)) for i in range(3))
        emit({"phase": "precision_kernels", "precision": p, "case":
              "replicas", "K": 3, "equal_single_launches": same})
        check(same, f"a {tag} replica launch differs from a single launch")

    score_fn, params = t.fused_score
    ref = fs.gaussian_score_reference
    for b, d in ((B, D), RAGGED):
        rng = np.random.default_rng(2450 + d)
        a = rng.standard_normal((d, d))
        f = cu(np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32))
        mu = cu(rng.standard_normal(d).astype(np.float32))
        eps = cu(rng.standard_normal((b, d)).astype(np.float32))
        v = cu((0.3 * rng.standard_normal((b, d))).astype(np.float32))
        tgt = t if d == D else None
        if tgt is None:
            from gsmvi_tpu_torch.models import dense_gaussian

            tgt = dense_gaussian(TARGET_SEED, d, device=dev)
        sf, sp = tgt.fused_score
        spc, k = 8, 3
        gen = torch.Generator(device=dev).manual_seed(24 + d)
        block = torch.randn((spc * b, d), generator=gen, device=dev)
        blocks = torch.randn((k, spc * b, d), generator=gen, device=dev)
        means = torch.zeros((k, d), device=dev)
        factors = torch.eye(d, device=dev).repeat(k, 1, 1)
        zero, eye = torch.zeros(d, device=dev), torch.eye(d, device=dev)

        def runs(p):
            k4 = fs.make_fused_eps_step(sf, len(sp), b, d, external_eps=True,
                                        precision=p)
            k2 = fs.make_fused_eps_multistep(sf, len(sp), b, d, spc,
                                             precision=p)
            k6 = bfm.make_fused_eps_batch_multistep(sf, len(sp), b, d, k,
                                                    spc, precision=p)
            return {
                "gsm_eps_update_fused": (
                    lambda: fs.gsm_eps_update_fused(eps, v, mu, f,
                                                    precision=p),
                    lambda: fs.gsm_eps_update_ns_reference(eps, v, mu, f,
                                                           precision=p)),
                "make_fused_eps_step": (
                    lambda: k4(eps, mu, f, *sp),
                    lambda: fs.eps_step_reference(ref, sp, eps, mu, f,
                                                  precision=p)),
                "make_fused_eps_multistep": (
                    lambda: graph_block(k2, spc, block, zero, eye, sp,
                                        torch),
                    lambda: fs.eps_multistep_reference(
                        ref, sp, spc, block, zero, eye, batch=b,
                        precision=p)),
                "make_fused_eps_batch_multistep": (
                    lambda: graph_block(k6, spc, blocks, means, factors, sp,
                                        torch),
                    lambda: bfm.eps_batch_multistep_reference(
                        ref, sp, spc, blocks, means, factors, batch=b,
                        precision=p)),
            }

        plain32 = {name: pl() for name, (_, pl) in runs("highest").items()}
        for p in ("high", "bf16"):
            for name, (kern, pl) in runs(p).items():
                got, want = kern(), pl()
                torch.cuda.synchronize()
                multi = "multistep" in name
                base = HIGH_MULTI_TOL if multi else HIGH_UPDATE_TOL
                fscale = max(1.0, float(want[1].abs().max()))
                em = float((got[0] - want[0]).abs().max())
                ef_ = float((got[1] - want[1]).abs().max())
                own = max(float((want[0] - plain32[name][0]).abs().max()),
                          float((want[1] - plain32[name][1]).abs().max())
                          / fscale)
                share = BF16_MULTI_SHARE if multi else BF16_UPDATE_SHARE
                tol = base if p == "high" else max(base, share * own)
                flags = [x.tolist() if torch.is_tensor(x) else x
                         for x in (got[2], want[2])]
                rec = {"kernel": name, "precision": p, "B": b, "D": d,
                       "flags": flags, "mean_err": em, "f_err": ef_,
                       "tol": tol, "f_tol": tol * fscale,
                       "plain_vs_float32": own}
                emit({"phase": "precision_kernels", **rec})
                check(flags[0] == flags[1],
                      f"{name} at {p}: flags differ from the plain: {rec}")
                check(em <= tol and ef_ <= tol * fscale,
                      f"{name} at {p} disagrees with its plain version: "
                      f"{rec}")
    return worst


def phase_precision_times(fs, bfm, t, torch):
    """Phase 24b: per-call times of the tensor-core products at the main
    path's shapes beside the float32 kernel, the plain version and
    ``torch.mm`` on bf16 operands (the library yardstick, operands
    converted ahead); then K1, K4, K2 (an 8-step block) and K6 (K=8) at
    each precision on the device, with their bounds.  Returns (times,
    work, library, device, library_device, extra) of PREC_NAMES; extra
    holds each apply's whole function by library calls (its operands'
    bfloat16 round trips, bf16x3's lo parts, and addmm: partial, no
    select) and each library yardstick's note."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2424)
    vf = torch.randn((B, D), generator=gen, device=dev)
    f = torch.randn((D, D), generator=gen, device=dev) / 16
    su = torch.randn((2 * B, D), generator=gen, device=dev)
    sw = 0.1 * torch.randn((2 * B, D), generator=gen, device=dev)
    good = torch.ones(1, dtype=torch.int32, device=dev)   # the kernel's flag
    vf16, f16 = vf.bfloat16(), f.bfloat16()
    su16, sw16 = su.bfloat16(), sw.bfloat16()
    times, work, library, device, library_device = {}, {}, {}, {}, {}
    extra = {}

    def whole_apply(p):
        hi = lambda x: x.bfloat16().float()
        if p == "bf16":
            return lambda: torch.addmm(f, hi(su).T, hi(sw))

        def run():
            ah, bh = hi(su), hi(sw)
            al, bl = hi(su - ah), hi(sw - bh)
            return torch.addmm(torch.addmm(torch.addmm(f, al.T, bh), ah.T,
                                           bl), ah.T, bh)
        return run

    for p in ("bf16", "high"):
        tag = fs.MMA_TAG[p]
        thin = lambda p=p: fs.thin_product(vf, f, trans=True, precision=p)
        thin_plain = lambda p=p: fs.mm_prec(vf, f.T, p)
        app = lambda p=p: fs.factor_apply(su, sw, f, good, precision=p)
        app_plain = lambda p=p: fs.factor_apply_reference(su, sw, f, good, p)
        lib_thin = lambda: torch.mm(vf16, f16.T)
        lib_app = lambda: torch.mm(su16.T, sw16)
        for name, kern, plain, lib, inputs in (
                (f"thin_product_{tag}", thin, thin_plain, lib_thin, (vf, f)),
                (f"factor_apply_{tag}", app, app_plain, lib_app,
                 (su, sw, f, good))):
            times[name] = (cuda_ms(kern, reps=200), cuda_ms(plain, reps=200))
            work[name] = (plain, inputs, None, BF16_FLOPS_PER_S)
            library[name] = cuda_ms(lib, reps=200)
            device[name], names = device_ms(kern)
            library_device[name] = device_ms(lib)[0]
            want = "thin_mma_kernel" if "thin" in name else "apply_mma_kernel"
            check(len(names) == 1 and want in names[0],
                  f"{name} runs other kernels: {names}")
            extra[name] = {"library": "mm on bf16 operands converted ahead"}
        extra[f"factor_apply_{tag}"]["library_whole_device_ms"] = device_ms(
            whole_apply(p))[0]
    emit({"phase": "precision_times", "B": B, "D": D, "ms_per_call": {
        k: {"kernel": a, "plain": b, "library_bf16_mm": library[k],
            "device": device[k], "library_device": library_device[k]}
        for k, (a, b) in times.items()},
        "float32_thin_device_ms": device_ms(
            lambda: fs.thin_product(vf, f, trans=True))[0]})

    # The three row products at every PREC_SHAPES shape, each precision,
    # device ms a call beside mm on bf16 operands converted ahead: vf = v F,
    # t = vf F^T, ef = e F^T with x = mu + ef.
    by_shape = {}
    for m, d in PREC_SHAPES:
        g = torch.Generator(device=dev).manual_seed(2425 + m + d)
        rows = torch.randn((m, d), generator=g, device=dev)
        fm = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
        mu = torch.randn(d, generator=g, device=dev)
        rows16, f16 = rows.bfloat16(), fm.bfloat16()
        fns = {}
        for p in ("bf16", "high"):
            tag = fs.MMA_TAG[p]
            fns[f"vf_{tag}"] = lambda p=p: fs.thin_product(
                rows, fm, trans=False, precision=p)
            fns[f"t_{tag}"] = lambda p=p: fs.thin_product(
                rows, fm, trans=True, precision=p)
            fns[f"ef_{tag}"] = lambda p=p: fs.thin_product(
                rows, fm, trans=True, mu=mu, precision=p)
        fns["mm_vf"] = lambda: torch.mm(rows16, f16)
        fns["mm_t"] = lambda: torch.mm(rows16, f16.T)
        res = {key: device_ms(fn, calls=50 if d <= 256 else 20)
               for key, fn in fns.items()}
        for key, (_, names) in res.items():
            if not key.startswith("mm"):
                check(len(names) == 1 and "thin_mma_kernel" in names[0],
                      f"thin {key} at ({m}, {d}) runs other kernels: {names}")
        by_shape[f"{m}x{d}"] = {key: ms for key, (ms, _) in res.items()}
    emit({"phase": "precision_times", "check": "thin_by_shape",
          "device_ms": by_shape})
    for p in ("bf16", "high"):
        tag = fs.MMA_TAG[p]
        extra[f"thin_product_{tag}"]["by_shape_device_ms"] = {
            shape: {key: ms for key, ms in row.items()
                    if key.endswith(tag) or key.startswith("mm")}
            for shape, row in by_shape.items()}

    # K1, K4, K2 and K6 at each precision: device ms per call, bytes and
    # FLOPs bounds (the O(B D^2) products over the bf16 peak x passes, the
    # rest of the plain version's FLOPs over the float32 one).  A whole
    # update forms five B D^2-sized products' worth: ef, vf, t and the fat
    # apply (2B x D x D, two of them); K3 stays float32.
    score_fn, params = t.fused_score
    ref = fs.gaussian_score_reference
    eps = torch.randn((B, D), generator=gen, device=dev)
    mean, eye = torch.zeros(D, device=dev), torch.eye(D, device=dev)
    v = t.lp_g(mean + eps)
    spc, k = 8, FIT_BATCH_K
    block = torch.randn((spc * B, D), generator=gen, device=dev)
    blocks = torch.randn((k, spc * B, D), generator=gen, device=dev)
    means, factors = torch.zeros((k, D), device=dev), eye.repeat(k, 1, 1)
    big = 2 * B * D * D           # FLOPs of one O(B D^2) product
    out = {}
    for p in ("highest", "high", "bf16"):
        k4 = fs.make_fused_eps_step(score_fn, len(params), B, D,
                                    external_eps=True, precision=p)
        k2 = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc,
                                         precision=p)
        k6 = bfm.make_fused_eps_batch_multistep(score_fn, len(params), B, D,
                                                k, spc, precision=p)
        passes = PREC_PASSES.get(p, 0)
        cases = {
            "gsm_eps_update_fused": (
                lambda: fs.gsm_eps_update_fused(eps, v, mean, eye,
                                                precision=p),
                lambda: fs.gsm_eps_update_ns_reference(eps, v, mean, eye,
                                                       precision="highest"),
                (eps, v, mean, eye), 5, 50),
            "make_fused_eps_step": (
                lambda: k4(eps, mean, eye, *params),
                lambda: fs.eps_step_reference(ref, params, eps, mean, eye),
                (eps, mean, eye, *params), 5, 50),
            "make_fused_eps_multistep": (
                lambda: k2(spc, block, mean, eye, *params),
                lambda: fs.eps_multistep_reference(ref, params, spc, block,
                                                   mean, eye, batch=B),
                (block, mean, eye, *params), 5 * spc, 20),
            "make_fused_eps_batch_multistep": (
                lambda: k6(spc, blocks, means, factors, *params),
                lambda: bfm.eps_batch_multistep_reference(
                    ref, params, spc, blocks, means, factors, batch=B),
                (blocks, means, factors, *params), 5 * spc * k, 10),
        }
        for name, (kern, plain32, inputs, nbig, calls) in cases.items():
            b32 = bound(plain32, inputs)
            small_flops = b32["flops"] - nbig * big
            t_ops = (small_flops / F32_FLOPS_PER_S + (
                nbig * big * passes / BF16_FLOPS_PER_S if passes else
                nbig * big / F32_FLOPS_PER_S))
            t_bytes = b32["bytes"] / HBM_BYTES_PER_S
            out.setdefault(name, {})[p] = {
                "ms": cuda_ms(kern, reps=calls),
                "device_ms": device_ms(kern, calls=calls)[0],
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    emit({"phase": "precision_times", "B": B, "D": D, "spc": spc, "K": k,
          "per_call": out})
    return times, work, library, device, library_device, extra


def phase_precision_paths(FactorGSM, fs, t, torch):
    """Phase 24c: ``FactorGSM(fused_score, pallas_precision=p)`` at D=256,
    B=32, N_ITER steps for p in ("high", "bf16"): K2 with its three row
    products and the fat apply on the tensor-core kernels every sub-step
    (K3 stays float32), finite and PD, under 1.5 x the worst plain CPU fit;
    then the same precision on K1 (``FactorGSM`` without ``fused_score``,
    N_PREC_K1 steps, finite and PD).  Returns the fits' launch counts."""
    from gsmvi_tpu_torch.ops.gsm_factor import factor_to_cov

    dev = torch.device("cuda")
    counts = []
    for p in ("high", "bf16"):
        tag = fs.MMA_TAG[p]
        fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                       pallas_precision=p, device=dev)
        check(fg._fused_mode(B) == "step", f"{p}: the K2 path must run")
        fs.reset_launch_counts()
        st, wall = _timed(lambda: fg.fit(FIT_SEED, batch_size=B,
                                         niter=N_ITER, verbose=False,
                                         return_state=True), torch)
        c = fs.launch_counts()
        counts.append(c)
        em, ec = errs(st.mean, st.cov, t)
        lmin = float(torch.linalg.eigvalsh(st.cov.double()).min())
        wm, wc = PREC_FIT_WORST[p]
        emit({"phase": "precision_path", "fitter":
              "FactorGSM(fused_score)", "pallas_precision": p, "D": D,
              "B": B, "niter": N_ITER,
              "launches": {k: n for k, n in c.items() if n},
              "n_accepted": int(st.n_accepted), "mean_err": em,
              "cov_err": ec, "mean_err_bound": 1.5 * wm,
              "cov_err_bound": 1.5 * wc, "cov_min_eig": lmin,
              "iters_per_s": (N_ITER + 1) / wall})
        n = N_ITER + 1
        check(c[f"thin_product_{tag}"] == 3 * n
              and c[f"factor_apply_{tag}"] == n
              and c["make_fused_eps_multistep"] > 0
              and c["gaussian_score"] == n and c["thin_product"] == 0,
              f"{p}: every sub-step must run its products on the "
              f"tensor-core kernels: {c}")
        check(bool(torch.isfinite(st.mean).all()
                   and torch.isfinite(st.cov).all()) and lmin > 0.0,
              f"FactorGSM at {p}: not finite and PD")
        check(em < 1.5 * wm and ec < 1.5 * wc,
              f"FactorGSM at {p} over 1.5 x its plain CPU fit")

        fk = FactorGSM(D, t.lp, t.lp_g, pallas_precision=p, device=dev)
        check(fk._fused_mode(B) == "update", f"{p}: the K1 path must run")
        fs.reset_launch_counts()
        sk = fk.fit(FIT_SEED, batch_size=B, niter=N_PREC_K1, verbose=False,
                    return_state=True)
        ck = fs.launch_counts()
        counts.append(ck)
        cov_k = factor_to_cov(sk.factor)
        lk = float(torch.linalg.eigvalsh(cov_k.double()).min())
        emk, eck = errs(sk.mean, cov_k, t)
        emit({"phase": "precision_path", "fitter": "FactorGSM",
              "pallas_precision": p, "D": D, "B": B, "niter": N_PREC_K1,
              "launches": {k: n for k, n in ck.items() if n},
              "mean_err": emk, "cov_err": eck, "cov_min_eig": lk})
        check(ck["gsm_eps_update_fused"] == N_PREC_K1 + 1
              and ck[f"thin_product_{tag}"] == 2 * (N_PREC_K1 + 1)
              and ck[f"factor_apply_{tag}"] == N_PREC_K1 + 1,
              f"{p}: K1 must run its products on the tensor cores: {ck}")
        check(bool(torch.isfinite(sk.mean).all()
                   and torch.isfinite(cov_k).all()) and lk > 0.0,
              f"FactorGSM (K1) at {p}: not finite and PD")
    return counts


# Phase 25: twophase and qr at D=256, B=32, N_ITER steps, under 1.5 x the
# worst of the JAX package's own CPU fits of the same method, arrays, batch
# and niter (FactorGSM(method=m), PRNGKey(k), k = 0..7):
# tools/option_bounds.py, twophase mean_err <= 1.6638e-3, cov_err <=
# 2.5461e-4; qr 1.4353e-3 and 3.4642e-4.
TWOPHASE_MEAN_REF, TWOPHASE_COV_REF = 1.6638e-3, 2.5461e-4
QR_MEAN_REF, QR_COV_REF = 1.4353e-3, 3.4642e-4
METHOD_WORST = {"twophase": (TWOPHASE_MEAN_REF, TWOPHASE_COV_REF),
                "qr": (QR_MEAN_REF, QR_COV_REF)}


def phase_method_paths(FactorGSM, fs, t, torch):
    """Phase 25: ``FactorGSM(method=m)`` for m in ("twophase", "qr") on the
    card: torch's own ops (no kernel launches), Finv refreshed after steps
    999, 1999 and 2999 (``refresh_every=1000``), Finv F close to I, the
    moments under the bound; it/s and the idle share of a profiled
    window."""
    import gsmvi_tpu_torch.gsm_factor as gf

    dev = torch.device("cuda")
    real = gf.factor_refresh
    calls = []

    def counting(f, finv):
        calls.append(1)
        return real(f, finv)

    gf.factor_refresh = counting
    try:
        for m in ("twophase", "qr"):
            fg = FactorGSM(D, t.lp, t.lp_g, method=m, device=dev)
            check(fg._fused_mode(B) is None, f"{m} must run no kernel")
            fs.reset_launch_counts()
            calls.clear()
            st, wall = _timed(lambda: fg.fit(
                FIT_SEED, batch_size=B, niter=N_ITER, verbose=False,
                return_state=True), torch)
            c = fs.launch_counts()
            refreshes = len(calls)
            em, ec = errs(st.mean, st.cov, t)
            eye = torch.eye(D, device=dev)
            inv_res = float((st.finv @ st.factor - eye).abs().max())
            busy, wall_prof = busy_per_step(lambda: fg.fit(
                FIT_SEED, batch_size=B, niter=DENSE_WINDOW - 1,
                verbose=False), DENSE_WINDOW)
            wm, wc = METHOD_WORST[m]
            emit({"phase": "method_path", "fitter": "FactorGSM",
                  "method": m, "D": D, "B": B, "niter": N_ITER,
                  "refresh_every": fg.refresh_every,
                  "refreshes": refreshes, "n_accepted": int(st.n_accepted),
                  "finv_residual": inv_res, "mean_err": em, "cov_err": ec,
                  "mean_err_bound": 1.5 * wm, "cov_err_bound": 1.5 * wc,
                  "iters_per_s": (N_ITER + 1) / wall,
                  "device_busy_us_per_step": busy,
                  "wall_us_per_step_profiled": wall_prof,
                  "device_idle_share_profiled": 1.0 - busy / wall_prof})
            check(sum(c.values()) == 0, f"{m} launched a kernel: {c}")
            check(refreshes == (N_ITER + 1) // fg.refresh_every,
                  f"{m}: {refreshes} refreshes at refresh_every="
                  f"{fg.refresh_every}")
            check(bool(torch.isfinite(st.mean).all()
                       and torch.isfinite(st.cov).all()),
                  f"FactorGSM({m}) not finite")
            check(em < 1.5 * wm and ec < 1.5 * wc,
                  f"FactorGSM({m}) over 1.5 x the JAX CPU fit")
    finally:
        gf.factor_refresh = real


# Phase 26: the float32 fat apply (apply_f32.cu) against the 32x32 template
# it replaced, which stays compiled as its oracle (gemm.cu): every output
# keeps the template's FMA chain, so the two agree bit for bit on every
# shape, in place or not, and a K=8 launch's replica z equals a launch on
# it alone.  Against its plain version (torch's float32 mm, TF32 off) the
# kernel differs in sum order alone: on F = 0 within PREC_SUM 2B 2^-24
# |su|^T |sw|, phase 24's bound at one pass.
APPLY_K2 = (2, 4, 2 * B, 128, 256, 1024)
APPLY_D = (1, 33, D, 1024, 8192)
APPLY_GOOD8 = (1, 0, 1, 1, 0, 1, 1, 1)
APPLY_PLAIN = ((2 * B, D), (2 * RAGGED[0], RAGGED[1]), (2 * B, 33), (256, D),
               (2 * B, 1024))
APPLY_TIMES = ((2 * B, D), (256, D), (1024, 1024), (2 * B, 8192))


def same_bits(x, y) -> bool:
    """x and y hold the same float32 bits (signed zeros told apart)."""
    import torch

    return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def apply_oracle(fs, lib, su, sw, f, good, out):
    """``out`` = the 32x32 template's select apply (``gsmvi_factor_apply_
    oracle``): f + su^T sw where good[z], else f, per replica."""
    k, d = su.shape[-2:]
    lib.call("gsmvi_factor_apply_oracle", fs._ptr(su), fs._ptr(sw),
             fs._ptr(f), fs._ptr(out), fs._ptr(good), k, d,
             f.shape[0] if f.dim() == 3 else 1, fs._stream(f.device))
    return out


def apply_routes(fs, bfm, t, torch) -> dict:
    """The kernels one call of each eps route runs at "highest" (K1, K1
    over K replicas, K4a, K4 ns and chol, a K2 block, a K6 block), by
    ``torch.profiler``; each must run ``apply_f32_kernel`` for its fat
    apply and never the 32x32 template."""
    dev = torch.device("cuda")
    score_fn, params = t.fused_score
    gen = torch.Generator(device=dev).manual_seed(2626)
    spc, k = 8, 4
    eps = torch.randn((B, D), generator=gen, device=dev)
    mean, eye = torch.zeros(D, device=dev), torch.eye(D, device=dev)
    v = t.lp_g(mean + eps)
    eps_k, v_k = eps.repeat(k, 1, 1), v.repeat(k, 1, 1)
    means, factors = mean.repeat(k, 1), eye.repeat(k, 1, 1)
    block = torch.randn((spc * B, D), generator=gen, device=dev)
    blocks = torch.randn((k, spc * B, D), generator=gen, device=dev)
    step = lambda method: fs.make_fused_eps_step(
        score_fn, len(params), B, D, external_eps=True, method=method)
    k4, k4c = step("ns"), step("chol")
    k2 = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)
    k6 = bfm.make_fused_eps_batch_multistep(score_fn, len(params), B, D, k,
                                            spc)
    routes = {
        "K1": lambda: fs.gsm_eps_update_fused(eps, v, mean, eye),
        "K1 batched": lambda: fs.gsm_eps_update_fused(eps_k, v_k, means,
                                                      factors),
        "K4a": lambda: fs.gsm_eps_update_fused(eps, v, mean, eye,
                                               method="chol"),
        "K4 ns": lambda: k4(eps, mean, eye, *params),
        "K4 chol": lambda: k4c(eps, mean, eye, *params),
        "K2": lambda: k2(spc, block, mean, eye, *params),
        "K6": lambda: k6(spc, blocks, means, factors, *params)}
    out = {}
    for name, fn in routes.items():
        names = device_ms(fn, calls=4, warmup=2)[1]
        out[name] = [n for n in names if "apply" in n or "gemm" in n]
        check(any("apply_f32_kernel" in n for n in names)
              and not any("gemm_kernel" in n for n in names),
              f"{name} runs other kernels for its fat apply: {names}")
    return out


def phase_apply_f32(fs, bfm, lib, t, torch):
    """Phase 26: ``factor_apply`` at "highest" against the template oracle
    bit for bit over APPLY_K2 x APPLY_D x K in (1, 8) x good x in place,
    replica z of K=8 against a launch on it alone; against its plain
    version at APPLY_PLAIN; every eps route on ``apply_f32_kernel``
    (``apply_routes``); device times at APPLY_TIMES beside the template's,
    ``torch.addmm`` and addmm + ``torch.where``.  Returns (times, work,
    library, device, library_device, worst, extra) of ``factor_apply``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    rand = lambda *shape, scale=1.0: scale * torch.randn(
        shape, generator=gen, device=dev)
    stream = fs._stream(dev)
    unequal, n = [], 0
    for k2 in APPLY_K2:
        for d in APPLY_D:
            for reps in (1, 8):
                lead = (reps,) if reps > 1 else ()
                su, sw = rand(*lead, k2, d), rand(*lead, k2, d, scale=0.1)
                f = rand(*lead, d, d)
                for gv in ((1,), (0,)) if reps == 1 else (APPLY_GOOD8,):
                    good = torch.tensor(gv, dtype=torch.int32, device=dev)
                    want = apply_oracle(fs, lib, su, sw, f, good,
                                        torch.empty_like(f))
                    got = fs.factor_apply(su, sw, f, good)
                    inplace = f.clone()
                    fs._apply(lib, stream, su, sw, inplace, inplace, good,
                              precision="highest", reps=reps)
                    same = {"out_of_place": same_bits(got, want),
                            "in_place": same_bits(inplace, want)}
                    if reps > 1:
                        same["replicas_alone"] = all(
                            same_bits(fs.factor_apply(
                                su[z], sw[z], f[z], good[z:z + 1]), want[z])
                            for z in range(reps))
                    n += 1
                    if not all(same.values()):
                        unequal.append({"2B": k2, "D": d, "K": reps,
                                        "good": list(gv), **same})
                del want, got, inplace
            del su, sw, f
    # Signed zeros: a k chain that ends at -0 (a product underflowing) on
    # F = -0; the template's zero FMAs to its 32-deep slab make it +0.
    su = torch.zeros((2, 64), device=dev)
    sw = torch.zeros((2, 64), device=dev)
    su[1], sw[1] = -2.0 ** -80, 2.0 ** -80
    f = torch.full((64, 64), -0.0, device=dev)
    good = torch.ones(1, dtype=torch.int32, device=dev)
    want = apply_oracle(fs, lib, su, sw, f, good, torch.empty_like(f))
    n += 1
    if not (same_bits(fs.factor_apply(su, sw, f, good), want)
            and not bool(torch.signbit(want).any())):
        unequal.append({"2B": 2, "D": 64, "K": 1, "case": "signed zeros"})
    torch.cuda.synchronize()
    emit({"phase": "apply_f32", "check": "template_oracle", "cases": n,
          "2B": list(APPLY_K2), "D": list(APPLY_D), "K": [1, 8],
          "unequal": unequal})
    check(not unequal, f"apply_f32 differs from the template: {unequal}")

    emit({"phase": "apply_f32", "check": "routes",
          "apply_kernels": apply_routes(fs, bfm, t, torch)})

    worst = 0.0
    for k2, d in APPLY_PLAIN:
        su, sw = rand(k2, d), rand(k2, d, scale=0.1)
        zero = torch.zeros((d, d), device=dev)
        got = fs.factor_apply(su, sw, zero)
        want = fs.factor_apply_reference(su, sw, zero)
        torch.cuda.synchronize()
        absprod = _abs_product(su.T, sw)
        tol = PREC_SUM * k2 * 2.0 ** -24
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        rec = {"2B": k2, "D": d, "max_abs_err": err, "sum_tol_rel": tol,
               "max_rel_to_abs_product": float(
                   (diff / absprod.clamp_min(1e-30)).max())}
        emit({"phase": "apply_f32", "check": "plain", **rec})
        check(bool((diff <= tol * absprod + 1e-30).all()),
              f"apply_f32 disagrees with its plain version: {rec}")
        worst = max(worst, err)

    # Device time per call by torch.profiler, and by CUDA events over
    # back-to-back calls (at D = 8192 each call runs 0.1-1 ms, so events
    # time the device there too).
    by_shape = {}
    times = work = library = device = library_device = None
    for k2, d in APPLY_TIMES:
        su, sw, f = rand(k2, d), rand(k2, d, scale=0.1), rand(d, d)
        good = torch.ones(1, dtype=torch.int32, device=dev)
        keep = good.reshape(1, 1) != 0
        out = torch.empty_like(f)
        calls = 50 if d <= 1024 else 10
        fns = {
            "kernel": lambda su=su, sw=sw, f=f, good=good: fs.factor_apply(
                su, sw, f, good),
            "template": lambda su=su, sw=sw, f=f, good=good, out=out:
                apply_oracle(fs, lib, su, sw, f, good, out),
            "addmm": lambda su=su, sw=sw, f=f: torch.addmm(f, su.T, sw),
            "addmm_where": lambda su=su, sw=sw, f=f, keep=keep: torch.where(
                keep, torch.addmm(f, su.T, sw), f)}
        plain = lambda su=su, sw=sw, f=f, good=good: \
            fs.factor_apply_reference(su, sw, f, good)
        ms, names = device_ms(fns["kernel"], calls=calls)
        check(len(names) == 1 and "apply_f32_kernel" in names[0],
              f"factor_apply at ({k2}, {d}) runs other kernels: {names}")
        bd = bound(plain, (su, sw, f, good))
        rec = {"device_ms": ms}
        for key, fn in fns.items():
            if key != "kernel":
                rec[f"{key}_device_ms"] = device_ms(fn, calls=calls)[0]
            rec[f"{key}_events_ms"] = cuda_ms(fn, reps=calls)
        by_shape[f"{k2}x{d}"] = {**rec, "bound_ms": bd["bound_ms"],
                                 "bound_by": bd["bound_by"]}
        if (k2, d) == (2 * B, D):
            times = {"factor_apply": (cuda_ms(fns["kernel"], reps=200),
                                      cuda_ms(plain, reps=200))}
            work = {"factor_apply": (plain, (su, sw, f, good))}
            library = {"factor_apply": cuda_ms(fns["addmm"], reps=200)}
            device = {"factor_apply": ms}
            library_device = {"factor_apply": rec["addmm_device_ms"]}
    emit({"phase": "apply_f32", "check": "times", "by_shape": by_shape})
    extra = {"factor_apply": {
        "library": "addmm, TF32 off (partial: no select)",
        "by_shape": by_shape}}
    return times, work, library, device, library_device, worst, extra


# Phase 27: BaM's fat apply (apply_f32.cu, ``gsmvi_bam_apply``) against the
# 32x32 template it replaced, kept as its oracle (``gsmvi_bam_apply_oracle``,
# gemm.cu).  Every output keeps the template's FMA chain, so F' agrees bit
# for bit on every shape.  The trace screen's sums are taken over other
# tiles in another order: a float32 sum of n non-negative terms in any order
# lies within (n - 1) 2^-24 of its exact value, relative to it, so each new
# tile's pair is held to (n - 1) 2^-24 of the float64 sums over its tile
# (of F', bit equal to the oracle's, and of F), and each replica's totals
# to (n_new + n_old) 2^-24 of the exact totals against the oracle's (n the
# elements of a tile; the tiles' sums taken in float64).
BAM_APPLY_B = (1, 2, 32, 56, 63, 64, 128)
BAM_APPLY_D = (1, 33, D, 1024)
BAM_APPLY_TIMES = ((B, D), (128, D), (B, 1024), (8, 33))
BAM_APPLY_HALT = (B, D)
# Against its plain version (torch's float32 mm, TF32 off) on F = 0: phase
# 26's bound, PREC_SUM 2(B+1) 2^-24 |su|^T |sw| (the tile sums are held to
# exact sums of the kernel's own F' above).
BAM_APPLY_PLAIN = ((B, D), (12, 200), (B, 33), (128, D), (B, 1024))


def bam_apply_oracle(fs, lib, su, sw, f):
    """The 32x32 template's BaM apply (``gsmvi_bam_apply_oracle``): (f +
    su^T sw, its 32x32 tiles' (sum f'^2, sum f^2) pairs (..., tiles, 2))."""
    import torch

    k2, d = su.shape[-2:]
    reps = f.shape[0] if f.dim() == 3 else 1
    out = torch.empty_like(f)
    part = out.new_empty((*f.shape[:-2], (-(-d // 32)) ** 2, 2))
    lib.call("gsmvi_bam_apply_oracle", fs._ptr(su), fs._ptr(sw), fs._ptr(f),
             fs._ptr(out), fs._ptr(part), None, k2, d, reps,
             fs._stream(f.device))
    return out, part


def _bam_apply_sums_ok(bf, f, got, part, opart) -> dict:
    """The tile and total bounds of phase 27 on one launch's outputs (a
    leading replica axis allowed); returns the worst ratios to them."""
    d = f.shape[-1]
    bm, bn = bf.apply_tile(d)
    u = 2.0 ** -24
    exact = (bf._tile_sums_of_squares(got.double()),
             bf._tile_sums_of_squares(f.double()))
    tile = max(float(((part[..., i].double() - exact[i]).abs()
                      / ((bm * bn - 1) * u * exact[i]).clamp_min(1e-300))
                     .max()) for i in (0, 1))
    total = 0.0
    for i in (0, 1):
        ex = exact[i].sum(-1)
        gap = (part[..., i].double().sum(-1)
               - opart[..., i].double().sum(-1)).abs()
        total = max(total, float((gap / ((bm * bn + 32 * 32) * u * ex)
                                  .clamp_min(1e-300)).max()))
    return {"tile_over_bound": tile, "total_over_bound": total}


def phase_bam_apply(bf, fs, lib, torch, np):
    """Phase 27: ``bam_apply`` against the template oracle over 2(B+1) for
    B in BAM_APPLY_B x D in BAM_APPLY_D x K in (1, 3) (F' bit for bit, the
    sums within their bounds, replica z of K=3 equal to a launch on it
    alone), a signed-zero case, the halt word (a set word leaves F' and the
    partials untouched, a cleared one runs); device times of the kernel,
    the oracle and addmm + the two sums of squares (TF32 off; partial: the
    trace sums in one order, no halt) at BAM_APPLY_TIMES; against its plain
    version at BAM_APPLY_PLAIN.  Returns (times, work, library, device,
    library_device, worst, extra) of ``bam_apply``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    rand = lambda *shape, scale=1.0: scale * torch.randn(
        shape, generator=gen, device=dev)
    unequal, n, ratios = [], 0, {"tile_over_bound": 0.0,
                                 "total_over_bound": 0.0}
    for b in BAM_APPLY_B:
        k2 = 2 * (b + 1)
        for d in BAM_APPLY_D:
            for reps in (1, 3):
                lead = (reps,) if reps > 1 else ()
                su, sw = rand(*lead, k2, d), rand(*lead, k2, d, scale=0.1)
                f = rand(*lead, d, d)
                got, part = bf.bam_apply(su, sw, f)
                want, opart = bam_apply_oracle(fs, lib, su, sw, f)
                same = {"f_out": same_bits(got, want)}
                if reps > 1:
                    alone = [bf.bam_apply(su[z], sw[z], f[z])
                             for z in range(reps)]
                    same["replicas_alone"] = all(
                        same_bits(a[0], got[z]) and same_bits(a[1], part[z])
                        for z, a in enumerate(alone))
                torch.cuda.synchronize()
                r = _bam_apply_sums_ok(bf, f, got, part, opart)
                for key in ratios:
                    ratios[key] = max(ratios[key], r[key])
                n += 1
                if not all(same.values()) or max(r.values()) > 1.0:
                    unequal.append({"B": b, "D": d, "K": reps, **same, **r})
    # Signed zeros: a k chain that ends at -0 on F = -0; the template's zero
    # FMAs to its 32-deep slab make it +0, and so must the kernel.
    su = torch.zeros((2, 64), device=dev)
    sw = torch.zeros((2, 64), device=dev)
    su[1], sw[1] = -2.0 ** -80, 2.0 ** -80
    f = torch.full((64, 64), -0.0, device=dev)
    got, _ = bf.bam_apply(su, sw, f)
    want, _ = bam_apply_oracle(fs, lib, su, sw, f)
    n += 1
    if not (same_bits(got, want) and not bool(torch.signbit(want).any())):
        unequal.append({"B": 0, "D": 64, "K": 1, "case": "signed zeros"})
    # The halt word: set, the launch leaves its outputs as they were;
    # cleared, it computes what bam_apply computes.
    b, d = BAM_APPLY_HALT
    su, sw, f = rand(2 * (b + 1), d), rand(2 * (b + 1), d, scale=0.1), \
        rand(d, d)
    stream = fs._stream(dev)
    halt = torch.ones(1, device=dev)
    out = torch.full_like(f, 7.0)
    part = torch.full((bf.bam_apply_tiles(d), 2), 7.0, device=dev)
    bf._launch_bam_apply(lib, stream, su, sw, f, out, part, halt, 1)
    torch.cuda.synchronize()
    halted = bool((out == 7.0).all() and (part == 7.0).all())
    halt.zero_()
    bf._launch_bam_apply(lib, stream, su, sw, f, out, part, halt, 1)
    ref = bf.bam_apply(su, sw, f)
    torch.cuda.synchronize()
    ran = same_bits(out, ref[0]) and same_bits(part, ref[1])
    emit({"phase": "bam_apply", "check": "template_oracle", "cases": n,
          "B": list(BAM_APPLY_B), "D": list(BAM_APPLY_D), "K": [1, 3],
          "worst_over_bound": ratios, "halt_set_no_op": halted,
          "halt_cleared_runs": ran, "unequal": unequal})
    check(not unequal, f"bam_apply differs from the template: {unequal}")
    check(halted and ran, "bam_apply does not honour its halt word")

    worst = 0.0
    for b, d in BAM_APPLY_PLAIN:
        k2 = 2 * (b + 1)
        su, sw = rand(k2, d), rand(k2, d, scale=0.1)
        zero = torch.zeros((d, d), device=dev)
        got = bf.bam_apply(su, sw, zero)[0]
        want = bf.bam_apply_reference(su, sw, zero)[0]
        torch.cuda.synchronize()
        absprod = _abs_product(su.T, sw)
        tol = PREC_SUM * k2 * 2.0 ** -24
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        rec = {"B": b, "D": d, "max_abs_err": err, "sum_tol_rel": tol,
               "max_rel_to_abs_product": float(
                   (diff / absprod.clamp_min(1e-30)).max())}
        emit({"phase": "bam_apply", "check": "plain", **rec})
        check(bool((diff <= tol * absprod + 1e-30).all()),
              f"bam_apply disagrees with its plain version: {rec}")
        worst = max(worst, err)

    # Device time per call of the three functions; CUDA events at the main
    # shape for the kernels line.
    by_shape, out = {}, {}
    for b, d in BAM_APPLY_TIMES:
        k2 = 2 * (b + 1)
        su, sw, f = rand(k2, d), rand(k2, d, scale=0.1), rand(d, d)
        fns = {
            "kernel": lambda su=su, sw=sw, f=f: bf.bam_apply(su, sw, f),
            "template": lambda su=su, sw=sw, f=f: bam_apply_oracle(
                fs, lib, su, sw, f),
            "addmm_sums": lambda su=su, sw=sw, f=f: (lambda fp: (
                fp, (fp * fp).sum(), (f * f).sum()))(
                torch.addmm(f, su.T, sw))}
        res = {key: device_ms(fn, calls=50) for key, fn in fns.items()}
        names = res["kernel"][1]
        check(len(names) == 1 and "apply_f32_kernel" in names[0],
              f"bam_apply at ({b}, {d}) runs other kernels: {names}")
        check(any("gemm_kernel" in x for x in res["template"][1]),
              f"the oracle runs other kernels: {res['template'][1]}")
        plain = lambda su=su, sw=sw, f=f: bf.bam_apply_reference(su, sw, f)
        bd = bound(plain, (su, sw, f))
        by_shape[f"{b}x{d}"] = {
            **{f"{key}_device_ms": ms for key, (ms, _) in res.items()},
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}
        if (b, d) == (B, D):
            out = {"times": (cuda_ms(fns["kernel"], reps=200),
                             cuda_ms(plain, reps=200)),
                   "work": (plain, (su, sw, f)),
                   "library": cuda_ms(fns["addmm_sums"], reps=200),
                   "device": res["kernel"][0],
                   "library_device": res["addmm_sums"][0]}
    emit({"phase": "bam_apply", "check": "times", "by_shape": by_shape})
    extra = {"library": "addmm + (F'*F').sum() + (F*F).sum(), TF32 off "
                        "(partial: the sums in one order, no halt)",
             "template_device_ms": by_shape[f"{B}x{D}"]["template_device_ms"],
             "by_shape": by_shape}
    return ({"bam_apply": out["times"]}, {"bam_apply": out["work"]},
            {"bam_apply": out["library"]}, {"bam_apply": out["device"]},
            {"bam_apply": out["library_device"]}, worst,
            {"bam_apply": extra})


# Phase 28: the Philox draw (prng.cu), redesigned: one normal a thread for a
# small draw, two or four interleaved chains a thread with float4/uint4
# stores for a larger one, each round's products as one 32x32->64 multiply,
# the grid from the SM count.  Its words and normals equal the plain
# versions' bit for bit, and the replaced design's
# (``gsmvi_philox_oracle``).  Its ops bound takes the instructions per
# normal counted in this build's SASS by tools/philox_sass.py: for each
# pipe the fewest that a thread of philox_kernel<NP> can issue on a path
# through its float4 stores of normals (slow paths skipped, predicated and
# unclassified instructions off their pipes), so the bound is a lower one.
# The phase also measures the marginal cost of a normal (PHILOX_SLOPE: the
# time between two large draws by CUDA events; at 16-32 M normals a call
# runs ~0.1 ms, far above its host enqueue).
PHILOX_SHAPES = ((B, D), PHILOX_LARGE, (37, 201))
PHILOX_TIMES = ((B, D), PHILOX_LARGE)
PHILOX_SLOPE = ((16384, 1024), (32768, 1024))
# Philox rounds per counter block, two products each.
PHILOX_PRODUCTS = 20


def philox_bound(n: int, per_normal: dict, lanes: dict) -> dict:
    """The least time of an n-normal draw: its bytes (4 n written) over the
    memory rate, and each pipe's instructions (``per_normal`` of
    tools/philox_sass.py) over its rate, the FP32 peak scaled by the
    pipe's lanes (an FMA counts two FLOPs on 128 lanes)."""
    ms = {"bytes": 4.0 * n / HBM_BYTES_PER_S * 1e3}
    for pipe, per in per_normal.items():
        rate = F32_FLOPS_PER_S / 2 * lanes[pipe] / 128
        ms[pipe] = n * per / rate * 1e3
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": "bytes" if by == "bytes"
            else "operations", "pipe": by, "by_pipe_ms": ms}


def philox_oracle(fs, lib, seed: int, shape, torch):
    """The replaced design's normals (``gsmvi_philox_oracle``)."""
    dev = torch.device("cuda")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    n = out.numel()
    lib.call("gsmvi_philox_oracle", fs._ptr(None), fs._ptr(out),
             (n + 1) // 2, n, int(seed) & 0xFFFFFFFF, fs.PHILOX_KEY1,
             fs._stream(dev))
    return out


def phase_philox(fs, lib, torch):
    """Phase 28: the redesigned Philox draw against its plain versions bit
    for bit (words and normals) and against the replaced design's normals
    at PHILOX_SHAPES; device and event times at PHILOX_TIMES beside the
    replaced design's and ``torch.randn``'s (its yardstick: another stream,
    the same distribution) and the bound from the SASS of this build
    (``tools/philox_sass.py``), whose products are one IMAD.WIDE.U32
    each (the replaced design's an IMAD and an IMAD.HI.U32)."""
    from tools.philox_sass import pipe_counts

    dev = torch.device("cuda")
    seed = 20261018
    sass = pipe_counts()
    ops = {name.split("prng_cu_")[-1]: {
        op: hist.get(op, 0) for op in ("IMAD.WIDE.U32", "IMAD.HI.U32",
                                       "MUFU.RSQ", "STG.E.128")}
        for name, hist in sass["kernels"].items()}
    emit({"phase": "philox", "check": "sass", "kernels": ops,
          "paths": sass["paths"], "per_normal": sass["per_normal"]})
    wide = {k: v for k, v in ops.items() if "oracle" not in k}
    check(len(wide) == 3 and all(v["IMAD.HI.U32"] == 0 for v in wide.values())
          and all(v["IMAD.WIDE.U32"] >= PHILOX_PRODUCTS
                  for v in wide.values())
          and any(v["IMAD.HI.U32"] > 0 for k, v in ops.items()
                  if "oracle" in k),
          f"Philox products are not one wide multiply each: {ops}")
    bound_of = lambda n: philox_bound(n, sass["per_normal"],
                                      sass["lanes_per_sm_clock"])
    cases = []
    for shape in PHILOX_SHAPES:
        n = shape[0] * shape[1]
        nb = (n + 1) // 2
        words = fs.philox4x32(nb, seed, fs.PHILOX_KEY1, device=dev)
        words_p = fs.philox4x32_reference(fs._philox_counters(nb, dev), seed,
                                          fs.PHILOX_KEY1)
        z = fs.philox_normal(seed, *shape, device=dev)
        z_p = fs.philox_normal_reference(seed, *shape, device=dev)
        old = philox_oracle(fs, lib, seed, shape, torch)
        torch.cuda.synchronize()
        cases.append({"shape": list(shape), "normals": n,
                      "words_equal": bool(torch.equal(words, words_p)),
                      "normals_equal": same_bits(z, z_p),
                      "replaced_design_equal": same_bits(old, z)})
    emit({"phase": "philox", "check": "bits", "cases": cases})
    check(all(c["words_equal"] and c["normals_equal"]
              and c["replaced_design_equal"] for c in cases),
          f"Philox kernel differs from its plain version: {cases}")

    by_shape = {}
    for shape in PHILOX_TIMES:
        fns = {"kernel": lambda shape=shape: fs.philox_normal(
                   7, *shape, device=dev),
               "replaced_design": lambda shape=shape: philox_oracle(
                   fs, lib, 7, shape, torch),
               "randn": lambda shape=shape: torch.randn(shape, device=dev)}
        rec = {}
        for key, fn in fns.items():
            ms, names = device_ms(fn, calls=200)
            rec[f"{key}_device_ms"] = ms
            rec[f"{key}_events_ms"] = cuda_ms(fn, reps=200)
            if key == "kernel":
                check(len(names) == 1 and "philox" in names[0]
                      and "oracle" not in names[0],
                      f"philox_normal at {shape} runs other kernels: {names}")
                rec["kernel_name"] = names[0]
        rec["plain_events_ms"] = cuda_ms(
            lambda shape=shape: fs.philox_normal_reference(7, *shape, dev),
            reps=50)
        by_shape["x".join(map(str, shape))] = {
            **rec, **bound_of(shape[0] * shape[1])}
    slope = {}
    for key, fn in (("kernel", lambda shape: fs.philox_normal(
                        7, *shape, device=dev)),
                    ("replaced_design", lambda shape: philox_oracle(
                        fs, lib, 7, shape, torch)),
                    ("randn", lambda shape: torch.randn(shape, device=dev))):
        ms = [cuda_ms(lambda shape=shape: fn(shape), reps=20)
              for shape in PHILOX_SLOPE]
        n = [a * b for a, b in PHILOX_SLOPE]
        slope[f"{key}_us_per_mnormal"] = (1e3 * (ms[1] - ms[0])
                                          / ((n[1] - n[0]) / 1e6))
        slope[f"{key}_events_ms"] = ms
    per_m = {pipe: 1e3 * ms for pipe, ms in
             bound_of(1_000_000)["by_pipe_ms"].items()}
    emit({"phase": "philox", "check": "times", "by_shape": by_shape,
          "slope": slope, "bound_us_per_mnormal": per_m,
          "slope_shapes": [list(x) for x in PHILOX_SLOPE]})
    return by_shape


# Phase 29: the mesh path.  A world-size-1 NCCL group on a file:// store,
# meshes over it, and the fitters' mesh routes equal bit for bit to the
# same fits without a mesh that phases 2, 5 and 11 ran (every rank draws
# the whole batch, and the gathered rows of one rank are the rows).  MESH_ADVI_ITER steps of ADVI; the
# large-D configuration of examples/example_large_d_torch.py (numpy seed
# 4, D=512, B=32, LARGE_D_ITER steps, chol_block=128 on a 1 x 1 mesh)
# under 1.5 x the worst of 4 JAX CPU fits of the same target
# (tools/jax_example_bound.py --only large_d, GSM(chol_block=128) float32,
# PRNGKey(0..3)): mean_err <= 5.6002e-3, cov_err <= 1.0647e-3 (key 2).
MESH_ADVI_ITER = 500
LARGE_D, LARGE_D_B, LARGE_D_ITER, LARGE_D_BLOCK = 512, 32, 4000, 128
LARGE_D_MEAN_ERR_BOUND = 1.5 * 5.6002e-3
LARGE_D_COV_ERR_BOUND = 1.5 * 1.0647e-3
# The blocked Cholesky at D=512, b=128 against float64: within CHOL_FLOOR
# times the library's own float32 factor's distance from float64 (the
# input's rounding floor).
MESH_CHOL_D, MESH_CHOL_B = 512, 128


def _timed_fit(fitter, fit, fs, torch):
    """(result, launch counts, seconds) of one fit, counts reset before."""
    fs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fit(fitter)
    torch.cuda.synchronize()
    return out, fs.launch_counts(), time.perf_counter() - t0


def phase_mesh(GSM, FactorGSM, FactorBaM, ADVI, Adam, Regularizers, fs, t,
               plain_fits, torch):
    """Phase 29; returns the launch counts of its fits.  ``plain_fits``:
    the (mean, cov) of the same fits without a mesh from phases 2
    (``GSM``, the factor route's K1), 5 (``BaM``, the factor route's K7)
    and 11 (``GSM(use_factor=False)``, K5), which a one-rank mesh must
    equal bit for bit."""
    import tempfile

    import torch.distributed as dist

    from gsmvi_tpu_torch.distributions import safe_cholesky
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.parallel import (blocked_cholesky, cov_sharding,
                                          initialize_distributed, make_mesh,
                                          make_mesh_2d)
    from gsmvi_tpu_torch.parallel.mesh import all_gather_into

    dev = torch.device("cuda")
    path_counts = []
    with tempfile.TemporaryDirectory() as tmp:
        multi = initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            check(dist.is_initialized() and not multi
                  and dist.get_backend() == "nccl",
                  "initialize_distributed: no one-rank NCCL group")
            mesh = make_mesh(1)
            # The group's collectives: what a row gather costs a step on a
            # mesh of more ranks (a one-rank axis sends nothing).
            rows = torch.ones((B, D), device=dev)
            parts = [torch.empty_like(rows)]
            dist.all_gather(parts, rows)
            one = torch.ones(1, device=dev)
            dist.all_reduce(one)
            torch.cuda.synchronize()
            check(torch.equal(parts[0], rows) and float(one) == 1.0,
                  "NCCL collectives on the one-rank group")
            flat = torch.empty_like(rows)
            gathers = {
                "all_gather_list": lambda: dist.all_gather(parts, rows),
                "all_gather_into": lambda: all_gather_into(flat, rows, None)}
            rec = {}
            for key, gather in gathers.items():
                gather()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    gather()
                rec[f"{key}_host_us"] = 1e6 * (time.perf_counter() - t0) / 50
                rec[f"{key}_events_ms"] = cuda_ms(gather, reps=50)
            emit({"phase": "mesh", "check": "group",
                  "backend": dist.get_backend(),
                  "world": dist.get_world_size(), "mesh": str(mesh),
                  "rows": [B, D], **rec})
            kw = dict(batch_size=B, verbose=False, return_state=True)
            fits = (
                ("FactorGSM", "gsm_eps_update_fused", N_ITER,
                 lambda m: FactorGSM(D, t.lp, t.lp_g, device=dev, mesh=m),
                 lambda g: g.fit(FIT_SEED, niter=N_ITER, **kw),
                 (MEAN_ERR_BOUND, COV_ERR_BOUND)),
                ("FactorBaM", "bam_eps_update_fused", N_BAM,
                 lambda m: FactorBaM(D, t.lp, t.lp_g, device=dev, mesh=m),
                 lambda g: g.fit(FIT_SEED, Regularizers().linear(BAM_REGF0),
                                 niter=N_BAM, retries=0, **kw),
                 (BAM_MEAN_ERR_BOUND, BAM_COV_ERR_BOUND)),
                ("GSM(use_factor=False)", "gsm_update_fused", N_ITER,
                 lambda m: GSM(D, t.lp, t.lp_g, device=dev, use_factor=False,
                               mesh=m),
                 lambda g: g.fit(FIT_SEED, niter=N_ITER, **kw),
                 (MEAN_ERR_BOUND, COV_ERR_BOUND)))
            for name, kernel, niter, make, fit, (mb, cb) in fits:
                got, counts, wall = _timed_fit(make(mesh), fit, fs, torch)
                path_counts.append(counts)
                mean0, cov0 = plain_fits[name]
                same = (torch.equal(mean0, got.mean)
                        and torch.equal(cov0, got.cov))
                em, ec = errs(got.mean, got.cov, t)
                rec = {"fitter": name, "D": D, "B": B, "niter": niter,
                       "kernel": kernel, "launches": counts[kernel],
                       "equal_to_fit_without_mesh": same,
                       "mean_err": em, "cov_err": ec,
                       "mean_err_bound": mb, "cov_err_bound": cb,
                       "iters_per_s": (niter + 1) / wall}
                emit({"phase": "mesh", "check": "fit", **rec})
                check(same, f"mesh fit differs from the fit without: {rec}")
                check(counts[kernel] >= niter + 1 if kernel !=
                      "bam_eps_update_fused" else counts[kernel] > 0,
                      f"{kernel} not launched on the mesh path: {rec}")
                check(em < mb and ec < cb, f"mesh fit over its bound: {rec}")

            adam_fit = lambda g: g.fit(FIT_SEED, Adam(ADVI_LR), batch_size=B,
                                       niter=MESH_ADVI_ITER, verbose=False,
                                       return_state=True)
            (sp, lp_), _, _ = _timed_fit(ADVI(D, t.lp, device=dev),
                                         adam_fit, fs, torch)
            (sm, lm), _, _ = _timed_fit(ADVI(D, t.lp, device=dev, mesh=mesh),
                                        adam_fit, fs, torch)
            advi_same = (torch.equal(sp.loc, sm.loc)
                         and torch.equal(sp.scales, sm.scales)
                         and bool((lp_ == lm).all()))
            refused = []
            for call in (
                    lambda: ADVI(D, t.lp, device=dev, mesh=mesh,
                                 fused_score=t.fused_score).fit_fused(
                                     0, niter=2, batch_size=B, verbose=False),
                    lambda: FactorGSM(D, t.lp, t.lp_g, device=dev,
                                      mesh=mesh)._fused_mode(513),
                    lambda: FactorBaM(D, t.lp, t.lp_g, device=dev,
                                      mesh=mesh)._fused_mode(129)):
                try:
                    call()
                    refused.append(False)
                except ValueError:
                    refused.append(True)
            emit({"phase": "mesh", "check": "advi_and_refusals",
                  "advi_equal_to_fit_without_mesh": advi_same,
                  "niter": MESH_ADVI_ITER, "refused": refused})
            check(advi_same, "ADVI(mesh).fit differs from ADVI.fit")
            check(all(refused), f"a mesh call ran instead of raising: "
                                f"{refused}")

            gen = torch.Generator(device=dev).manual_seed(29)
            a = torch.randn((MESH_CHOL_D, MESH_CHOL_D), generator=gen,
                            device=dev)
            a = a @ a.T / MESH_CHOL_D + torch.eye(MESH_CHOL_D, device=dev)
            mesh2 = make_mesh_2d(1, 1)
            sh = cov_sharding(mesh2)
            l_b = blocked_cholesky(a, MESH_CHOL_B)
            l_s = blocked_cholesky(sh.place(a), MESH_CHOL_B).full_tensor()
            l_c = safe_cholesky(a)
            l64 = torch.linalg.cholesky(a.double())
            bad = blocked_cholesky(a - 2.0 * torch.eye(MESH_CHOL_D,
                                                       device=dev),
                                   MESH_CHOL_B)
            bad_cols = ~torch.isfinite(bad).all(0)
            first = int(torch.argmax(bad_cols.to(torch.int32)))
            torch.cuda.synchronize()
            rec = {"D": MESH_CHOL_D, "block": MESH_CHOL_B,
                   "err_vs_float64": float((l_b.double() - l64).abs().max()),
                   "library_err_vs_float64": float(
                       (l_c.double() - l64).abs().max()),
                   "sharded_equal": same_bits(l_s, l_b),
                   "not_pd_first_nan_column": first,
                   "not_pd_nan_from_there_on": bool(
                       bad_cols.any() and bad_cols[first:].all()
                       and torch.isfinite(bad[:, :first]).all())}
            emit({"phase": "mesh", "check": "blocked_cholesky", **rec})
            check(rec["sharded_equal"] and rec["not_pd_nan_from_there_on"]
                  and rec["err_vs_float64"] <= CHOL_FLOOR * max(
                      rec["library_err_vs_float64"], 1e-30),
                  f"blocked Cholesky: {rec}")

            tl = dense_gaussian(4, LARGE_D, device=dev)
            g = GSM(LARGE_D, tl.lp, tl.lp_g, device=dev, mesh=mesh2,
                    cov_sharding=sh, chol_block=LARGE_D_BLOCK)
            (mean, cov), counts, wall = _timed_fit(
                g, lambda g: g.fit(0, batch_size=LARGE_D_B,
                                   niter=LARGE_D_ITER, verbose=False),
                fs, torch)
            cov = cov.full_tensor()
            em, ec = errs(mean, cov, tl)
            busy, wall_us = busy_per_step(
                lambda: g.fit(0, batch_size=LARGE_D_B, niter=DENSE_WINDOW - 1,
                              verbose=False), DENSE_WINDOW)
            rec = {"config": "examples/example_large_d_torch.py",
                   "D": LARGE_D, "B": LARGE_D_B, "niter": LARGE_D_ITER,
                   "chol_block": LARGE_D_BLOCK, "mesh": [1, 1],
                   "mean_err": em, "cov_err": ec,
                   "mean_err_bound": LARGE_D_MEAN_ERR_BOUND,
                   "cov_err_bound": LARGE_D_COV_ERR_BOUND,
                   "iters_per_s": (LARGE_D_ITER + 1) / wall,
                   "profiled_busy_us_per_step": busy,
                   "profiled_wall_us_per_step": wall_us,
                   "profiled_idle": 1.0 - busy / wall_us,
                   "kernel_launches": {k: v for k, v in counts.items() if v}}
            emit({"phase": "mesh", "check": "large_d", **rec})
            check(bool(torch.isfinite(cov).all()) and em < LARGE_D_MEAN_ERR_BOUND
                  and ec < LARGE_D_COV_ERR_BOUND,
                  f"large-D example over its bound: {rec}")
        finally:
            dist.destroy_process_group()
    return path_counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    from gsmvi_tpu_torch import (ADVI, GSM, Adam, BaM, FactorBaM, FactorGSM,
                                 Regularizers)
    from gsmvi_tpu_torch import models
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.models import dense_gaussian, ill_conditioned_gaussian
    from gsmvi_tpu_torch.ops import advi_fused as af
    from gsmvi_tpu_torch.ops import bam_fused as bf
    from gsmvi_tpu_torch.ops import batch_fused as bfm
    from gsmvi_tpu_torch.ops import fused_step as fs
    from gsmvi_tpu_torch.ops import gsm_step as gs
    from gsmvi_tpu_torch.ops.cuda._build import load_library

    pin_fp32()
    card = card_line()
    t0 = time.perf_counter()
    lib = load_library()
    ptxas = [ln.strip() for ln in lib.path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": lib.build_seconds, "ptxas": ptxas})

    worst = phase_kernels(fs, dense_gaussian, torch, np)

    dev = torch.device("cuda")
    t = dense_gaussian(TARGET_SEED, D, device=dev)

    # Each path: counts reset just before, read just after.
    fs.reset_launch_counts()
    g = GSM(D, t.lp, t.lp_g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, cov = g.fit(FIT_SEED, batch_size=B, niter=N_ITER, verbose=False)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    main_counts = fs.launch_counts()
    main_fit = (mean, cov)
    k1_launches = main_counts["gsm_eps_update_fused"]
    em2, ec2 = errs(mean, cov, t)
    fin2 = bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
    emit({"phase": "main_path", "fitter": "GSM", "D": D, "B": B,
          "niter": N_ITER, "k1_launches": k1_launches, "mean_err": em2,
          "cov_err": ec2, "mean_err_bound": MEAN_ERR_BOUND,
          "cov_err_bound": COV_ERR_BOUND, "iters_per_s": (N_ITER + 1) / wall2})
    check(k1_launches == N_ITER + 1, f"K1 launches {k1_launches} != niter+1")
    check(fin2 and tuple(mean.shape) == (D,) and tuple(cov.shape) == (D, D),
          "GSM.fit output shape/finiteness")
    check(em2 < MEAN_ERR_BOUND and ec2 < COV_ERR_BOUND,
          "GSM.fit did not converge under the bound")

    fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score, device="cuda")
    check(fg._fused_mode(B) == "step" and fg.steps_per_call == 8,
          "headline path must run the whole-step kernel at spc=8")
    fs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fg.fit(FIT_SEED, batch_size=B, niter=N_ITER, verbose=False,
                return_state=True)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    counts = fs.launch_counts()
    em3, ec3 = errs(st.mean, st.cov, t)
    emit({"phase": "headline_path", "fitter": "FactorGSM(fused_score)",
          "D": D, "B": B, "niter": N_ITER, "spc": fg.steps_per_call,
          "launches": counts, "n_accepted": int(st.n_accepted),
          "mean_err": em3, "cov_err": ec3, "iters_per_s": (N_ITER + 1) / wall3})
    check(counts["make_fused_eps_multistep"] > 0
          and counts["gaussian_score"] > 0, "K2/K3 not launched")
    check(counts["gsm_eps_update_fused"] == 0,
          "K1 launched outside the main path's GSM fit")
    check(bool(torch.isfinite(st.mean).all() and torch.isfinite(st.cov).all()),
          "FactorGSM output not finite")
    check(em3 < MEAN_ERR_BOUND and ec3 < COV_ERR_BOUND,
          "FactorGSM(fused_score) did not converge under the bound")
    emit({"phase": "headline_graph", "fitter": "FactorGSM(fused_score)",
          **graph_vs_eager(fg, lambda: fg.fit(
              FIT_SEED, batch_size=B, niter=N_ITER, verbose=False,
              return_state=True), st, wall3, N_ITER + 1,
              fg._get_runner(B, "step"), torch)})

    # it/s of the kernel path vs the plain version, same blocks, same card.
    score_fn, params = t.fused_score
    spc, nblk = 8, 50
    gen = torch.Generator(device=dev).manual_seed(11)
    blocks = [torch.randn((spc * B, D), generator=gen, device=dev)
              for _ in range(nblk)]
    multi = fs.make_fused_eps_multistep(score_fn, len(params), B, D, spc)

    def run_blocks(fn):
        m, f = torch.zeros(D, device=dev), torch.eye(D, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks:
            m, f, _ = fn(blk, m, f)
        torch.cuda.synchronize()
        return spc * nblk / (time.perf_counter() - t0)

    kern = lambda blk, m, f: multi(spc, blk, m, f, *params)
    plain = lambda blk, m, f: fs.eps_multistep_reference(
        fs.gaussian_score_reference, params, spc, blk, m, f, batch=B)
    rates = [run_blocks(kern), run_blocks(plain), run_blocks(plain),
             run_blocks(kern)]
    emit({"phase": "rates", "D": D, "B": B, "spc": spc,
          "fit_iters_per_s": (N_ITER + 1) / wall3,
          "kernel_iters_per_s": [rates[0], rates[3]],
          "plain_iters_per_s": [rates[1], rates[2]]})

    worst.update(phase_bam_kernels(bf, fs, torch, np))
    worst.update(phase_bam_smallspace(bf, torch, np))
    bam_counts, st6, fb, bam_fit = phase_bam_paths(BaM, FactorBaM, Regularizers, bf,
                                          fs, t, torch)

    worst.update(phase_advi_kernels(af, fs, torch, np))
    advi_counts = phase_advi_paths(ADVI, Adam, af, fs, t, torch)

    worst["gsm_update_fused"] = phase_dense_kernels(gs, torch, np)
    dense_counts, dense_fit = phase_dense_paths(GSM, fs, t, torch)
    worst["make_fused_eps_batch_multistep"] = phase_batch_kernels(
        bfm, fs, t, torch)
    batch_counts = phase_fit_batch_paths(GSM, FactorGSM, fs, t, st, torch)
    phase_fit_batch_rates(FactorGSM, dense_gaussian, torch)

    worst["make_fused_eps_step"] = phase_eps_step_kernels(
        fs, dense_gaussian, torch, np)
    step_counts = phase_eps_step_path(FactorGSM, fs, t, st, torch)
    audit_counts = phase_audit_paths(FactorGSM, FactorBaM, Regularizers, fs,
                                     t, st, st6, torch)

    (range_worst, wide_counts, range_times, range_work, range_device,
     range_extra) = phase_ranges(GSM, FactorGSM, fs, bf, af, dense_gaussian,
                                 ill_conditioned_gaussian, torch, np)
    for key, err in range_worst.items():
        worst[key] = max(worst.get(key, 0.0), err)
    example_counts = phase_examples(GSM, BaM, FactorGSM, FactorBaM,
                                    Regularizers, dense_gaussian, fs, t, torch)
    (zoo_worst, zoo_times, zoo_work, zoo_library, zoo_device,
     zoo_library_device, zoo_extra) = phase_zoo_kernels(fs, models, torch, np)
    worst.update(zoo_worst)
    zoo_counts = phase_zoo_paths(FactorGSM, FactorBaM, ADVI, Regularizers,
                                 fs, models, card, torch, np)

    times, work, library, device, library_device, eager = phase_times(
        fs, dense_gaussian, torch, np)
    bam_more = phase_bam_times(bf, fs, fb, t, st6, torch)
    extra = bam_more[3]
    k6_times = phase_dense_batch_times(gs, bfm, fs, t, torch, np)
    for name, more in (*eager.items(), *k6_times[3].items()):
        extra[name] = {**extra.get(name, {}), **more}
    advi_more = phase_advi_times(af, fs, torch, np)
    for name, more in advi_more[3].items():
        extra[name] = {**extra.get(name, {}), **more}
    # Phases 21-22 after the per-call times of the earlier kernels.
    surface_counts = phase_surface(GSM, ADVI, Adam, FactorGSM, fs, t, st,
                                   torch, np)
    worst["bam_eps_update_replicas"] = phase_bam_replica_kernels(bf, torch,
                                                                 np)
    replica_counts = phase_replica_paths(BaM, FactorBaM, ADVI, Adam,
                                         Regularizers, fs, t, torch)
    replica_more = phase_bam_replica_times(bf, torch, np)
    for name, more in replica_more[3].items():
        extra[name] = {**extra.get(name, {}), **more}
    # Phases 23-25.
    host_counts = phase_host_paths(GSM, BaM, FactorGSM, FactorBaM,
                                   Regularizers, fs, t, torch, np)
    worst.update(phase_precision_kernels(fs, bfm, t, torch, np))
    (prec_times, prec_work, prec_library, prec_device, prec_library_device,
     prec_extra) = phase_precision_times(fs, bfm, t, torch)
    precision_counts = phase_precision_paths(FactorGSM, fs, t, torch)
    phase_method_paths(FactorGSM, fs, t, torch)
    (apply_times, apply_work, apply_library, apply_device,
     apply_library_device, worst["factor_apply"], apply_extra) = \
        phase_apply_f32(fs, bfm, lib, t, torch)
    (bam_apply_times, bam_apply_work, bam_apply_library, bam_apply_device,
     bam_apply_library_device, worst["bam_apply"], bam_apply_extra) = \
        phase_bam_apply(bf, fs, lib, torch, np)
    apply_times.update(bam_apply_times)
    apply_work.update(bam_apply_work)
    apply_library.update(bam_apply_library)
    apply_device.update(bam_apply_device)
    apply_library_device.update(bam_apply_library_device)
    apply_extra.update(bam_apply_extra)
    # Phases 28-29.
    philox_shapes = phase_philox(fs, lib, torch)
    mesh_counts = phase_mesh(GSM, FactorGSM, FactorBaM, ADVI, Adam,
                             Regularizers, fs, t,
                             {"FactorGSM": main_fit, "FactorBaM": bam_fit,
                              "GSM(use_factor=False)": dense_fit}, torch)
    library.update(prec_library)
    library_device.update(prec_library_device)
    library.update(apply_library)
    library_device.update(apply_library_device)
    for more in (bam_more[:3],
                 advi_more[:3],
                 replica_more[:3],
                 k6_times[:3],
                 phase_eps_step_times(fs, t, torch),
                 (range_times, range_work, range_device),
                 (zoo_times, zoo_work, zoo_device),
                 (prec_times, prec_work, prec_device),
                 (apply_times, apply_work, apply_device)):
        times.update(more[0])
        work.update(more[1])
        device.update(more[2] if len(more) > 2 else {})
    library.update(zoo_library)
    library_device.update(zoo_library_device)
    for name, more in (*zoo_extra.items(), *range_extra.items(),
                       *prec_extra.items(), *apply_extra.items()):
        extra[name] = {**extra.get(name, {}), **more}
    bounds = {name: bound(*fn_inputs) for name, fn_inputs in work.items()}
    # The draw's bound counts its instructions (phase 28), not bytes alone.
    bounds["philox_normal"] = {
        k: philox_shapes[f"{B}x{D}"][k] for k in ("bound_ms", "bound_by",
                                                  "pipe", "by_pipe_ms")}
    emit({"phase": "bounds", **bounds})
    path_counts = ([main_counts, counts] + list(bam_counts)
                   + list(advi_counts) + dense_counts + batch_counts
                   + [step_counts] + audit_counts + wide_counts
                   + example_counts + zoo_counts + surface_counts
                   + replica_counts + host_counts + precision_counts
                   + mesh_counts)
    launches = {name: sum(c[name] for c in path_counts) for name in SOURCES}
    check(all(launches.values()),
          f"a kernel never launched on the paths: {launches}")
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": worst[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"],
         "library_ms": library.get(name),
         "device_ms": device.get(name),
         "library_device_ms": library_device.get(name),
         **extra.get(name, {})}
        for name, (src, rep) in SOURCES.items()]})
    # Every phase ran on device 0, the one card this script drives.
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
