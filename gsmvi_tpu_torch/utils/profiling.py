"""Timing and tracing helpers.

Counterpart of ``gsmvi_tpu/utils/profiling.py:19-57``:

- ``time_fn``        — median wall time of a call, warm-up excluded, the
  card synchronized around each call (JAX's ``block_until_ready``);
- ``fit_throughput`` — iterations/s and score evaluations/s of a fit;
- ``trace``          — a context manager that profiles its block with
  ``torch.profiler`` (host and, on a card, CUDA activity) and writes a
  Chrome trace into ``logdir``, the port's own spans among its host
  records, as ``tools/profile_gpu.profile_window`` profiles its windows.

``nan_debug`` (JAX's ``jax_debug_nans`` switch) is not ported.

The port's own spans and counters, which the JAX package has not:

- ``span(name)`` — a host span in the profiler's record while a
  ``torch.profiler`` session records (``trace``, or the caller's own
  ``torch.profiler.profile``), so it shares the profiler's clock with the
  card's activity; otherwise one shared no-op context (no allocation, no
  record).  The fitters open ``gsmvi.fit`` once per public fit call
  (``fit``, ``fit_batch``, ``fit_fused``) with the phases
  ``gsmvi.fit.setup``, ``gsmvi.fit.loop`` and ``gsmvi.fit.finish`` inside
  (``fit_call``); in the loop ``gsmvi.block.draw`` (a block's or a step's
  draws), ``gsmvi.block.report`` (a read of a kernel's report),
  ``gsmvi.block.replay`` (a stiff step replayed on the plain route),
  ``gsmvi.block.retry`` (a resample attempt), ``gsmvi.block.launch`` (a
  kernel call: a block's copies in, graph replay or eager launches and
  copies out) and ``gsmvi.graph.capture`` (a block's eager warm run and its
  CUDA-graph capture).  No span lies inside a captured graph.
- ``fit_counts`` — every fitter's dict of what its last public fit call did,
  reset at each call's start: ``FIT_COUNTS`` (updates issued, kernel calls,
  generator seedings, graph replays and captures, runner builds) and the
  fitter's own keys.  Host integers, always kept; nothing reads the card.
- ``recent_fits()`` — a copy of each of the last ``RECENT_FITS`` completed
  public fit calls' ``fit_counts``, newest last, under the fitter's class
  name (``"fitter"``); a call nested in another (``GSM`` handing its fit to
  ``FactorGSM``) is part of the outer call's record.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import threading
import time
from typing import Callable

import torch

# The counters every fitter's ``fit_counts`` holds (each fitter adds its
# own): updates issued (replicas counted apart; K8 the steps its report
# says it ran plus the replayed ones), kernel-wrapper calls, generator
# seedings of the draws (``driver.EpsStream``), CUDA-graph replays and
# captures of the fused blocks, and chunk runners built (cache misses).
FIT_COUNTS = ("steps", "kernel_calls", "draws", "graph_replays",
              "graph_captures", "runner_builds")
RECENT_FITS = 64

_profiling = torch.autograd._profiler_enabled
# The lighter of torch's two host spans: about 1 us a span while the
# profiler records, against record_function's 12, and no annotation mirrored
# onto the card's timeline (torch 2.11 on an H100's host).
_Span = torch._C._profiler._RecordFunctionFast


class _NoSpan:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A host span named ``name`` while a ``torch.profiler`` session
    records, else ``NO_SPAN``."""
    if _profiling():
        return _Span(name)
    return NO_SPAN


def reset_counts(counts: dict, **extra) -> dict:
    """Empty ``counts`` in place (runners hold the dict) and start it over:
    every ``FIT_COUNTS`` key at 0, then ``extra``."""
    counts.clear()
    counts.update(dict.fromkeys(FIT_COUNTS, 0), **extra)
    return counts


_recent = collections.deque(maxlen=RECENT_FITS)
_open = threading.local()


def recent_fits() -> list:
    """Copies of the last ``RECENT_FITS`` completed public fit calls'
    counts, oldest first: ``{"fitter": class name, **fit_counts}`` each."""
    return copy.deepcopy(list(_recent))


class fit_call:
    """``with fit_call(fitter) as call:`` around a public fit call's body.

    Resets ``fitter.fit_counts`` (``fitter._reset_counts()``).  The
    outermost call on a thread opens ``gsmvi.fit`` and returns itself;
    ``call.phase("setup" | "loop" | "finish")`` closes the phase span open
    (if another) and opens ``gsmvi.fit.<phase>``.  A call nested inside it
    returns the outer call, so its phases are the outer call's: one
    ``gsmvi.fit`` and one span of each phase, in order, per public call.
    When the outermost call ends without an exception its fitter's counts
    go to ``recent_fits()`` (a fitter that hands its fit to another copies
    the inner fitter's counts into its own first)."""

    __slots__ = ("fitter", "_fit", "_phase", "_name")

    def __init__(self, fitter):
        self.fitter = fitter

    def __enter__(self):
        self.fitter._reset_counts()
        outer = getattr(_open, "call", None)
        if outer is not None:
            return outer
        _open.call = self
        self._name, self._phase = None, NO_SPAN
        self._fit = span("gsmvi.fit")
        self._fit.__enter__()
        return self

    def phase(self, name: str) -> None:
        if name != self._name:
            self._phase.__exit__(None, None, None)
            self._name = name
            self._phase = span("gsmvi.fit." + name)
            self._phase.__enter__()

    def __exit__(self, exc_type, exc, tb):
        if getattr(_open, "call", None) is not self:
            return False
        _open.call = None
        self._phase.__exit__(None, None, None)
        self._fit.__exit__(None, None, None)
        if exc_type is None:
            _recent.append({"fitter": type(self.fitter).__name__,
                            **copy.deepcopy(self.fitter.fit_counts)})
        return False


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
