"""Checkpoint and resume of a fit's state as one npz file.

Counterpart of ``gsmvi_tpu/utils/checkpoint.py:32-87`` (``save_state``,
``load_state``).  The array fields keep the JAX package's names
(``_FIELDS``, ``_FACTOR_FIELDS``: ``ns_stats`` included; a factor state
saves its real fields, not the materialized cov/chol); the port's ``seed``
takes the key's place (an int64, or a (K,) array for stacked replicas);
``finv`` is saved where the state carries one (FactorGSM's twophase and qr
methods).  A loaded state resumes its fit exactly through
``fit(..., state=...)``: the eps stream is a function of (seed, step).
Orbax checkpoints (``save_orbax``/``restore_orbax``) are JAX-only and not
ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import resolve_device
from ..state import FactorVIState, VIState

_FIELDS = ("mean", "cov", "chol", "step", "n_accepted", "n_rejected")
_FACTOR_FIELDS = ("mean", "factor", "step", "n_accepted", "n_rejected",
                  "ns_stats")


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state) -> None:
    """Write a ``VIState`` or ``FactorVIState`` (single or stacked) to
    ``path`` (``.npz`` appended if missing)."""
    factor = isinstance(state, FactorVIState)
    arrays = {}
    for name in _FACTOR_FIELDS if factor else _FIELDS:
        value = getattr(state, name)
        if torch.is_tensor(value):
            arrays[name] = value.detach().cpu().numpy()
        elif name == "ns_stats":
            arrays[name] = np.asarray(value, dtype=np.float32)
        else:
            arrays[name] = np.asarray(value, dtype=np.int64)
    arrays["seed"] = np.asarray(state.seed, dtype=np.int64)
    if factor:
        arrays["_factor_state"] = np.asarray(True)
        if state.finv is not None:
            arrays["finv"] = state.finv.detach().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz_path(path), **arrays)


def load_state(path: str, device=None):
    """The ``VIState`` or ``FactorVIState`` saved by ``save_state``, its
    tensors on ``device`` (default: the CUDA card) in their saved dtypes."""
    device = resolve_device(device)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        t = lambda name: torch.as_tensor(data[name], device=device)
        seed = data["seed"]
        seed = (int(seed) if seed.ndim == 0
                else tuple(int(s) for s in seed))
        step = int(data["step"])
        counts = (t("n_accepted").to(torch.int32),
                  t("n_rejected").to(torch.int32))
        if "_factor_state" in data:
            stats = data["ns_stats"].tolist()
            stats = (tuple(stats) if data["ns_stats"].ndim == 1
                     else tuple(tuple(pair) for pair in stats))
            finv = t("finv") if "finv" in data else None
            return FactorVIState(t("mean"), t("factor"), seed, step, *counts,
                                 stats, finv)
        return VIState(t("mean"), t("cov"), t("chol"), seed, step, *counts)
