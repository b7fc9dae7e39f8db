"""The dense GSM update: the K5 kernel wrapper and its plain version.

Counterpart of ``gsmvi_tpu/ops/pallas/gsm_step.py``.  K5
``gsm_update_fused(samples, vs, mu0, S0) -> (mu, S)`` is the dense route's
update (``ops/gsm.py::gsm_update``) on the card: T = V S0, the row scalars,
mu += mean_b dmu_b and S = S0 + (A^T A - Bm^T Bm) / B, in two
thread-block-cluster launches of ``ops/cuda/csrc/gsm_step.cu`` on the
current stream (``k5_launch_plan``): T on the split-k thin product with
the rows' per-tile dot products in its epilogue, then the upper-triangle
tiles of the Gram with its k range (the B sample rows) split over a
cluster (``gram_split``), A and Bm formed as the slabs are staged, the
mean and S = S0 + ds / B in its epilogue.  A leading replica axis K on
every operand updates K independent fits in the same two launches (the
dense ``GSM.fit_batch``); every split is a function of B or D alone, so
replica z equals a call on replica z alone, bit for bit.

The scratch (T and the dot products) persists from call to call in
buffers keyed by (device, stream, K, B, D): calls reuse it in stream order
on the current stream.  The held scratch is bounded by bytes: the most
recently used keys are kept while they fit in ``SCRATCH_MAX_BYTES``
together, and a key whose scratch alone is larger is never held: its
scratch is a per-call temporary of the caching allocator, at a size where
the launches' own device time (T alone is 2 K B D^2 FLOPs) dwarfs the
allocator's host cost.  Below it only the outputs mu and S are allocated
per call (callers keep them).

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

from collections import OrderedDict

import torch

from .fused_step import (CLUSTER_MAX_BLOCKS, KERNEL_WRAPPERS, SLAB, _library,
                         _on_cpu, _ptr, _require, _stream, over_replicas,
                         thin_split)
from .gsm import gsm_update

GSM_STEP_BATCH_RANGE = (1, 65536)
GSM_STEP_DIM_RANGE = (1, 8192)
GSM_STEP_MAX_REPLICAS = 65535
SCRATCH_MAX_BYTES = 1 << 24


def gsm_step_supports(b: int, d: int) -> bool:
    """True iff the K5 kernel takes batch ``b`` and dimension ``d``."""
    return (GSM_STEP_BATCH_RANGE[0] <= b <= GSM_STEP_BATCH_RANGE[1]
            and GSM_STEP_DIM_RANGE[0] <= d <= GSM_STEP_DIM_RANGE[1])


def gram_split(b: int) -> tuple:
    """(S, k_per): the Gram launch's split of the B sample rows over a
    cluster of S <= 8 blocks, block r taking rows [r k_per, (r+1) k_per) in
    whole 32-row slabs, none empty.  A function of B alone, so a replica's
    Gram and mean sums do not depend on K."""
    slabs = -(-b // SLAB)
    per = -(-slabs // CLUSTER_MAX_BLOCKS)
    return -(-slabs // per), per * SLAB


def k5_launch_plan(b: int, d: int) -> dict:
    """K5's two launches at batch ``b`` and dimension ``d``: for each, the
    grid's x and y (blockIdx.z carries the K replicas), the cluster's
    blocks along x, and the split (S, k_per) of its k range.  A function of
    (B, D) alone, never of K."""
    nt = -(-d // SLAB)
    t_split, g_split = thin_split(d), gram_split(b)
    return {
        "thin": {"grid": (nt * t_split[0], -(-b // SLAB)),
                 "cluster": t_split[0], "split": t_split},
        "gram": {"grid": (nt * (nt + 1) // 2 * g_split[0], 1),
                 "cluster": g_split[0], "split": g_split},
    }


class _Scratch:
    """K5's scratch on one device and stream: T (K, B, D) and the rows'
    per-tile dot products (K, ceil(D/32), 3, B); and the launches' splits,
    the (S, k_per) of ``thin_split(D)`` then of ``gram_split(B)``."""

    def __init__(self, lead: tuple, b: int, d: int, device):
        self.t = torch.empty((*lead, b, d), dtype=torch.float32,
                             device=device)
        self.dots = torch.empty((*lead, -(-d // SLAB), 3, b),
                                dtype=torch.float32, device=device)
        plan = k5_launch_plan(b, d)
        self.splits = (*plan["thin"]["split"], *plan["gram"]["split"])
        self.nbytes = 4 * (self.t.numel() + self.dots.numel())


_SCRATCH = OrderedDict()


def _scratch(lead: tuple, b: int, d: int, device, stream) -> _Scratch:
    """The scratch of (device, stream, K, B, D): held from call to call
    while the most recent keys' scratch fits in ``SCRATCH_MAX_BYTES``; a
    scratch larger than that alone is this call's own."""
    key = (device, getattr(stream, "value", None), lead, b, d)
    buf = _SCRATCH.pop(key, None) or _Scratch(lead, b, d, device)
    if buf.nbytes > SCRATCH_MAX_BYTES:
        return buf
    held = sum(x.nbytes for x in _SCRATCH.values())
    while held + buf.nbytes > SCRATCH_MAX_BYTES:
        held -= _SCRATCH.popitem(last=False)[1].nbytes
    _SCRATCH[key] = buf
    return buf


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
    stream = _stream(dev)
    buf = _scratch(lead, b, d, dev, stream)
    mu, s = torch.empty_like(mu0), torch.empty_like(S0)
    gsm_update_fused.launches += 1
    _library().call("gsmvi_gsm_update", _ptr(samples), _ptr(vs), _ptr(mu0),
                    _ptr(S0), _ptr(buf.t), _ptr(buf.dots), _ptr(mu), _ptr(s),
                    b, d, k, *buf.splits, stream)
    return mu, s


gsm_update_fused.launches = 0

KERNEL_WRAPPERS.update({"gsm_update_fused": gsm_update_fused})
