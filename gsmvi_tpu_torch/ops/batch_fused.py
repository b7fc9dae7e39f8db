"""K6: K-replica whole GSM steps, the kernel wrapper and its plain version.

Counterpart of ``gsmvi_tpu/ops/pallas/batch_fused.py``.
``make_fused_eps_batch_multistep`` is K2 (``ops/fused_step.py``) over K
independent replica fits that share the target's score params: random
restarts and seed sweeps in one program (``FactorGSM.fit_batch(...,
small_solver="fused")``).

On the TPU the replica axis was the Pallas grid, whose cells ran one after
another on the chip's one core, so K6 bought bit-identity, not throughput.
On the card every launch of K2's host loop gains the replica axis instead:
the GEMM template's blockIdx.z, one small-space block per replica (side by
side on the SMs), and one K3 score launch over the K·B stacked rows.  The
host issues the same six launches per sub-step for any K, so the launches
per replica-step fall as 1/K.  Each replica's tiles and accumulation order
are those of a single K2 call, so replica i reproduces the single K2 fit
with its seed bit for bit.

The wrapper runs its plain version, ``eps_batch_multistep_reference``
(``eps_multistep_reference`` one replica at a time, so each replica equals
the single-fit plain path bit for bit), on CPU tensors, and the kernels on
CUDA tensors, raising on what they do not take; it never falls back.
"""

from __future__ import annotations

import torch

from .fused_step import (KERNEL_WRAPPERS, _launch_update, _library, _on_cpu,
                         _require, _require_shape_supported, _rows, _stream,
                         _UpdateBuffers, eps_multistep_reference,
                         ns_iters_for_batch, over_replicas)


def eps_batch_multistep_reference(score_fn, params, nmax: int, eps_blocks,
                                  means, factors, *, batch: int, iters=None):
    """K6's plain version: ``eps_multistep_reference`` on each replica's
    (eps block, mean, factor); returns (means (K, D), factors (K, D, D),
    n_accepted (K,) int32)."""
    return over_replicas(
        lambda e, m, f: eps_multistep_reference(score_fn, params, nmax, e, m,
                                                f, batch=batch, iters=iters),
        eps_blocks, means, factors)


def make_fused_eps_batch_multistep(score_fn, n_params: int, batch: int,
                                   d: int, k: int, steps_per_call: int,
                                   iters=None):
    """K6: ``steps_per_call`` whole GSM steps of K replicas per call.

    Returns ``step(nmax, eps_blocks, means, factors, *params) -> (means,
    factors, n_acc)`` advancing every replica by the first ``nmax``
    (<= spc) sub-steps of its block: ``eps_blocks`` (K, spc*B, D) holds
    replica i's sub-step j draw in rows [j*B, (j+1)*B); means (K, D);
    factors (K, D, D); ``n_acc`` (K,) int32 on the operands' device.  The
    params are shared; ``score_fn(x, *params)`` maps (M, D) rows to (M, D)
    scores row by row (e.g. the port's ``gaussian_score``).
    """
    spc = int(steps_per_call)
    iters = ns_iters_for_batch(batch, iters)

    def step(nmax, eps_blocks, means, factors, *params):
        nmax = int(nmax)
        if not 0 <= nmax <= spc:
            raise ValueError(f"nmax={nmax} outside [0, {spc}]")
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        eps_blocks = eps_blocks.reshape(k, spc * batch, d)
        if _on_cpu(eps_blocks, means, factors):
            return eps_batch_multistep_reference(
                score_fn, params, nmax, eps_blocks, means, factors,
                batch=batch, iters=iters)
        _require_shape_supported(batch, d)
        for name, t, shape in (("eps_blocks", eps_blocks, (k, spc * batch, d)),
                               ("means", means, (k, d)),
                               ("factors", factors, (k, d, d))):
            _require(name, t, shape)
        lib = _library()
        dev = eps_blocks.device
        stream = _stream(dev)
        # Scratch once per call; the working (means, factors) are updated
        # in place sub-step after sub-step.
        means_w, f_w = means.clone(), factors.clone()
        acc = torch.zeros(k, dtype=torch.int32, device=dev)
        ef = torch.empty((k, batch, d), dtype=torch.float32, device=dev)
        x = torch.empty_like(ef)
        buf = _UpdateBuffers(batch, d, dev, k)
        make_fused_eps_batch_multistep.launches += 1 if nmax else 0
        for j in range(nmax):
            e = eps_blocks[:, j * batch:(j + 1) * batch]
            _rows(lib, stream, e, f_w, ef, trans=True, mu=means_w, x_out=x)
            v = score_fn(x.reshape(k * batch, d), *params)
            _require("score", v, (k * batch, d))
            _launch_update(lib, stream, e, v.reshape(k, batch, d), ef,
                           means_w, means_w, f_w, f_w, buf, iters, nacc=acc)
        return means_w, f_w, acc

    return step


make_fused_eps_batch_multistep.launches = 0

KERNEL_WRAPPERS.update(
    {"make_fused_eps_batch_multistep": make_fused_eps_batch_multistep})
