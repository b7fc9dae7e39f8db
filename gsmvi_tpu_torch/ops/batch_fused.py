"""K6: K-replica whole GSM steps, the kernel wrapper and its plain version.

Counterpart of ``gsmvi_tpu/ops/pallas/batch_fused.py``.
``make_fused_eps_batch_multistep`` is K2 (``ops/fused_step.py``) over K
independent replica fits that share the target's score params: random
restarts and seed sweeps in one program (``FactorGSM.fit_batch(...,
small_solver="fused")``).

On the TPU the replica axis was the Pallas grid, whose cells ran one after
another on the chip's one core, so K6 bought bit-identity, not throughput.
On the card every launch of K2's sub-steps gains the replica axis instead:
the fat apply's blockIdx.z, one small-space cluster per replica (side
by side on the SMs), and one K3 score launch over the K·B stacked rows.  A
sub-step is the same six launches for any K, and a full block is one CUDA
graph replay on persistent buffers, as K2's (``FusedBlocks``,
``ops/fused_step.py``).  Each replica's tiles and accumulation order are
those of a single K2 call, so replica i reproduces the single K2 fit with
its seed bit for bit.

The wrapper runs its plain version, ``eps_batch_multistep_reference``
(``eps_multistep_reference`` one replica at a time, so each replica equals
the single-fit plain path bit for bit), on CPU tensors, and the kernels on
CUDA tensors, raising on what they do not take; it never falls back.
"""

from __future__ import annotations

from .fused_step import (KERNEL_WRAPPERS, FusedBlocks,
                         eps_multistep_reference, ns_iters_for_batch,
                         over_replicas)


def eps_batch_multistep_reference(score_fn, params, nmax: int, eps_blocks,
                                  means, factors, *, batch: int, iters=None,
                                  precision: str = "highest"):
    """K6's plain version: ``eps_multistep_reference`` on each replica's
    (eps block, mean, factor); returns (means (K, D), factors (K, D, D),
    n_accepted (K,) int32)."""
    return over_replicas(
        lambda e, m, f: eps_multistep_reference(score_fn, params, nmax, e, m,
                                                f, batch=batch, iters=iters,
                                                precision=precision),
        eps_blocks, means, factors)


def make_fused_eps_batch_multistep(score_fn, n_params: int, batch: int,
                                   d: int, k: int, steps_per_call: int,
                                   iters=None, precision: str = "highest"):
    """K6: ``steps_per_call`` whole GSM steps of K replicas per call.

    Returns a ``FusedBlocks``, ``step(nmax, eps_blocks, means, factors,
    *params) -> (means, factors, n_acc)``, advancing every replica by the
    first ``nmax`` (<= spc) sub-steps of its block: ``eps_blocks`` (K,
    spc*B, D) holds replica i's sub-step j draw in rows [j*B, (j+1)*B);
    means (K, D); factors (K, D, D); ``n_acc`` (K,) int32 on the operands'
    device.  The params are shared; ``score_fn(x, *params)`` maps (M, D)
    rows to (M, D) scores row by row (e.g. the port's ``gaussian_score``)
    and on the card must be capturable into a CUDA graph.  ``precision``
    is that of each sub-step's four O(B D^2) products (K2's).
    """
    iters = ns_iters_for_batch(batch, iters)
    return FusedBlocks(
        score_fn, n_params, batch, d, steps_per_call, iters, int(k),
        make_fused_eps_batch_multistep,
        lambda params, nmax, e, m, f: eps_batch_multistep_reference(
            score_fn, params, nmax, e, m, f, batch=batch, iters=iters,
            precision=precision), precision=precision)


make_fused_eps_batch_multistep.launches = 0

KERNEL_WRAPPERS.update(
    {"make_fused_eps_batch_multistep": make_fused_eps_batch_multistep})
