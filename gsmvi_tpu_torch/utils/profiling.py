"""Timing and tracing helpers.

Counterpart of ``gsmvi_tpu/utils/profiling.py:19-57``:

- ``time_fn``        — median wall time of a call, warm-up excluded, the
  card synchronized around each call (JAX's ``block_until_ready``);
- ``fit_throughput`` — iterations/s and score evaluations/s of a fit;
- ``trace``          — a context manager that profiles its block with
  ``torch.profiler`` (host and, on a card, CUDA activity) and writes a
  Chrome trace into ``logdir``, as ``tools/profile_gpu.profile_window``
  profiles its windows.

``nan_debug`` (JAX's ``jax_debug_nans`` switch) is not ported.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync() -> None:
    """Wait for the card's queued work, if this process uses a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Median wall time in seconds of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup`` calls, each call synchronized."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def fit_throughput(fit_fn: Callable, niter: int, batch_size: int,
                   warmup_fit: bool = True) -> dict:
    """Run ``fit_fn()`` (a zero-argument closure performing a fit of
    ``niter`` iterations, i.e. ``niter + 1`` steps) and report
    {seconds, iters_per_s, score_evals_per_s}; one warm-up fit first."""
    if warmup_fit:
        fit_fn()
    _sync()
    t0 = time.perf_counter()
    fit_fn()
    _sync()
    dt = time.perf_counter() - t0
    total_iters = niter + 1
    return {
        "seconds": dt,
        "iters_per_s": total_iters / dt,
        "score_evals_per_s": total_iters * batch_size / dt,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write its Chrome trace (viewable in
    ``chrome://tracing`` or Perfetto) to ``logdir/trace.json``.  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
