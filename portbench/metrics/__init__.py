"""Metric readers, one file per metric of ``BENCHMARK.json``, found by name.

An end-to-end metric's ``<metric>.py`` defines ``read(window) -> float |
None`` (``window.Window``: the host clock's jobs and set-up); a per-layer
metric's defines ``read(trace) -> float | None`` (``trace.Trace``: the
traced window).  None where there is nothing to read: the run then leaves
the metric out of its line."""
