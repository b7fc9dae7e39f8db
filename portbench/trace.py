"""The traced window: one profiler record of the cell's jobs, reduced to
what the per-layer readers take.

``profile_window`` and ``busy_s`` are frozen copies of the program
repository's ``tools/profile_gpu.py`` arithmetic (a window the profiler hands
back with no device record is run again, up to three runs; busy time is the
union of the device records' intervals).  ``Trace`` is what a reader in
``metrics/`` gets: the device records, the host's records, the host's CUDA
runtime calls by name, the window's host-clock seconds and fit steps, the
cell and configuration, and the configuration's work model.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

# Host runtime calls that start device work: kernel launches of every form
# (the runtime's and the driver's, clusters and cooperative grids included)
# and CUDA graph replays.
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                   "cuGraphLaunch")

# The harness's own host spans (``record_function``); the profiler also
# draws each on the device's timeline, where it is no device work.
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    """What the readers read.  Times in seconds; intervals on the
    profiler's clock, in microseconds, as (name, start, end)."""

    device: list
    host: list
    runtime: dict
    window_s: float
    steps: int
    jobs: int
    cell: dict
    config: dict
    work: object = None

    @property
    def batch(self) -> int:
        return int(self.cell["job"]["batch_size"])

    @property
    def dim(self) -> int:
        return int(self.config["dim"])

    def kernels(self, names) -> list:
        """Device records whose kernel is one of ``names`` (the function's
        name as a whole word of the record's name: ``thin_kernel`` matches
        ``void thin_kernel<2>(ThinArgs)``, not ``thin_mma_kernel``)."""
        return [r for r in self.device if any(_names(r[0], n) for n in names)]

    def launches(self) -> int:
        """Host runtime calls that started device work."""
        return sum(n for name, n in self.runtime.items()
                   if name.startswith(LAUNCH_PREFIXES))


def _names(record: str, name: str) -> bool:
    i = record.find(name)
    while i >= 0:
        before = record[i - 1] if i else " "
        j = i + len(name)
        after = record[j] if j < len(record) else " "
        if not (before.isalnum() or before == "_") and not (
                after.isalnum() or after == "_"):
            return True
        i = record.find(name, i + 1)
    return False


def busy_s(device) -> float:
    """Length of the union of the records' [start, end) intervals (s)."""
    return sum(e - s for s, e in merged(device)) * 1e-6


def merged(device) -> list:
    """The union of the records' intervals as sorted disjoint (start, end)."""
    out = []
    for s, e in sorted((r[1], r[2]) for r in device):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def profile_window(window, tries: int = 3):
    """(profile, ``window()``'s value): one run of ``window`` under
    ``torch.profiler`` (host and CUDA activity).  Now and then the profiler
    hands back a window with no device record although the device ran; such
    a window is run again, up to ``tries`` runs in all, each empty one
    reported on stderr.  Raises if every run came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = window()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof, out
        print(json.dumps({"profile_window": "no device records",
                          "run": attempt, "of": tries}),
              file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler saw no device time in {tries} runs")


def records(prof) -> tuple:
    """(device records, host records, runtime calls by name) of a profile.
    Device records are the device's operations (kernels, copies, sets), not
    the user annotations the profiler mirrors onto its timeline; runtime
    calls are the host's ``cuda*``/``cu*`` records, the final synchronise
    left out."""
    from torch.autograd import DeviceType

    device, host, runtime = [], [], {}
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                device.append(rec)
            continue
        host.append(rec)
        if e.name.startswith("cu") and e.name != "cudaDeviceSynchronize":
            runtime[e.name] = runtime.get(e.name, 0) + 1
    return device, host, runtime


def short_name(name: str, width: int = 96) -> str:
    """A record's name without ``void `` and anonymous namespaces, cut to
    ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def host_at(host, points) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    record open there (the latest started of those that cover it; records
    nest), or None."""
    host = sorted(host, key=lambda r: (r[1], -r[2]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][1] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps' time
    summed by what the host was doing (the innermost host record open at
    each gap's middle), in seconds, ``top`` of each."""
    by_op = {}
    for name, s, e in trace.device:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-6
    spans = merged(trace.device)
    gaps = [(spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)]
    labels = host_at(trace.host, [0.5 * (s + e) for s, e in gaps])
    by_host = {}
    for (s, e), label in zip(gaps, labels):
        key = short_name(label or "no host record")
        by_host[key] = by_host.get(key, 0.0) + (e - s) * 1e-6
    order = lambda d: sorted(([k, v] for k, v in d.items()),
                             key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_op), "idle_gaps": order(by_host)}
