"""The dense GSM update: the K5 kernel wrapper and its plain version.

Counterpart of ``gsmvi_tpu/ops/pallas/gsm_step.py``.  K5
``gsm_update_fused(samples, vs, mu0, S0) -> (mu, S)`` is the dense route's
update (``ops/gsm.py::gsm_update``) on the card: T = V S0, the row scalars,
mu += mean_b dmu_b and S = S0 + (A^T A - Bm^T Bm) / B, in four launches of
``ops/cuda/csrc/gsm_step.cu`` on the current stream.  A leading replica
axis K on every operand updates K independent fits in the same four
launches (the dense ``GSM.fit_batch``).

The wrapper runs its plain version, ``gsm_update_replicas_reference``
(``gsm_update`` one replica at a time), on CPU tensors, and its kernel on
CUDA tensors, raising on a dtype, shape, device or contiguity the kernel
does not take; it never falls back.  ``gsm_update_fused.launches`` counts
its calls on the card.

K5 has no small space and no shared-memory budget, so its range is wide:
B in ``GSM_STEP_BATCH_RANGE`` and D in ``GSM_STEP_DIM_RANGE`` keep every
element offset inside a replica under 2^31 (2 B D <= 2^30) and the grid
inside CUDA's limits; K runs to 65535 (a grid dimension).  The JAX package
gates its kernel on a VMEM budget and on ``B * D >= 4096`` ("tiny configs
stay on XLA", a TPU crossover); neither applies on the card.
"""

from __future__ import annotations

import torch

from .fused_step import (KERNEL_WRAPPERS, _library, _on_cpu, _ptr, _require,
                         _stream, over_replicas)
from .gsm import gsm_update

GSM_STEP_BATCH_RANGE = (1, 65536)
GSM_STEP_DIM_RANGE = (1, 8192)
GSM_STEP_MAX_REPLICAS = 65535


def gsm_step_supports(b: int, d: int) -> bool:
    """True iff the K5 kernel takes batch ``b`` and dimension ``d``."""
    return (GSM_STEP_BATCH_RANGE[0] <= b <= GSM_STEP_BATCH_RANGE[1]
            and GSM_STEP_DIM_RANGE[0] <= d <= GSM_STEP_DIM_RANGE[1])


def gsm_update_replicas_reference(samples, vs, mu0, S0):
    """K5's plain version: ``gsm_update`` with an optional leading replica
    axis, one replica at a time."""
    if samples.dim() == 2:
        return gsm_update(samples, vs, mu0, S0)
    return over_replicas(gsm_update, samples, vs, mu0, S0)


def gsm_update_fused(samples, vs, mu0, S0):
    """K5: the dense GSM update, returns the new (mu, S).

    samples, vs (B, D); mu0 (D,); S0 (D, D) — or each with a leading
    replica axis K.  S comes out exactly symmetric when S0 is (the Gram's
    two halves accumulate the same products in the same order).
    """
    if _on_cpu(samples, vs, mu0, S0):
        return gsm_update_replicas_reference(samples, vs, mu0, S0)
    b, d = samples.shape[-2:]
    lead = tuple(samples.shape[:-2])
    k = lead[0] if lead else 1
    if len(lead) > 1 or not 1 <= k <= GSM_STEP_MAX_REPLICAS:
        raise ValueError(f"samples: (B, D) or (K, B, D) with K <= "
                         f"{GSM_STEP_MAX_REPLICAS} required, got "
                         f"{tuple(samples.shape)}")
    if not gsm_step_supports(b, d):
        raise ValueError(
            f"the K5 kernel takes B in {list(GSM_STEP_BATCH_RANGE)} and D in "
            f"{list(GSM_STEP_DIM_RANGE)}, got B={b}, D={d}")
    for name, t, shape in (("samples", samples, (b, d)), ("vs", vs, (b, d)),
                           ("mu0", mu0, (d,)), ("S0", S0, (d, d))):
        _require(name, t, lead + shape)
    dev = samples.device
    empty = lambda *s: torch.empty((*lead, *s), dtype=torch.float32,
                                   device=dev)
    t, wden, opr = empty(b, d), empty(b), empty(b)
    l, r = empty(2 * b, d), empty(2 * b, d)
    mu, s = torch.empty_like(mu0), torch.empty_like(S0)
    gsm_update_fused.launches += 1
    _library().call("gsmvi_gsm_update", _ptr(samples), _ptr(vs), _ptr(mu0),
                    _ptr(S0), _ptr(t), _ptr(wden), _ptr(opr), _ptr(l),
                    _ptr(r), _ptr(mu), _ptr(s), b, d, k, _stream(dev))
    return mu, s


gsm_update_fused.launches = 0

KERNEL_WRAPPERS.update({"gsm_update_fused": gsm_update_fused})
