#!/usr/bin/env python3
"""Where the time of the port's main path goes on one NVIDIA GPU.

    python3 tools/profile_gpu.py [--steps 64]

Profiles ``--steps`` steps of the two main-path fits at the headline cell
(dense-Gaussian target, D=256, B=32) with ``torch.profiler``:
``GSM(..., device="cuda")`` (K1 per step) and
``FactorGSM(..., fused_score=...)`` (K2 with K3 inside, spc=8).  For each it
prints one JSON line: the host wall time per step (profiler on, so inflated),
the device busy time per step (union of kernel intervals), the device's idle
share of the profiled window, and device time per kernel name.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(kernels) -> float:
    """Length of the union of the kernels' [start, end) intervals (us)."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_fit(name, fitter, steps, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fitter.fit(1, batch_size=32, niter=15, verbose=False)      # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fitter.fit(0, batch_size=32, niter=steps - 1, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for k in kernels:
        key = k.name[:90]
        by_name[key] = by_name.get(key, 0.0) + (k.time_range.end
                                                - k.time_range.start)
    busy = busy_us(kernels)
    print(json.dumps({
        "path": name, "steps": steps,
        "wall_us_per_step_profiled": wall_us / steps,
        "device_busy_us_per_step": busy / steps,
        "device_idle_share": (1.0 - busy / wall_us) if kernels else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "device_us_per_step_by_kernel": {
            k: v / steps for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])},
    }), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=64)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_gpu: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch import GSM, FactorGSM
    from gsmvi_tpu_torch.models import dense_gaussian

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t = dense_gaussian(0, 256, device="cuda")
    profile_fit("GSM (K1 per step)", GSM(256, t.lp, t.lp_g, device="cuda"),
                args.steps, torch)
    profile_fit("FactorGSM fused_score (K2+K3, spc=8)",
                FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                          device="cuda"), args.steps, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
