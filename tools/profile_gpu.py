#!/usr/bin/env python3
"""Where the time of the port's main path goes on one NVIDIA GPU.

    python3 tools/profile_gpu.py [--steps 64]

Profiles ``--steps`` steps of the GSM paths at the headline cell
(dense-Gaussian target, D=256, B=32) with ``torch.profiler``:
``GSM(..., device="cuda")`` (K1 per step),
``FactorGSM(..., fused_score=...)`` (K2 with K3 inside, spc=8), the dense
route ``GSM(..., use_factor=False)`` (K5 and the ``cholesky_ex``
accept/revert per step) and ``fit_batch`` of K=8 replicas on its "fused"
(K6) and "ns" (batched K1) routes.  For each it prints one JSON line: the
host wall time per step (profiler on, so inflated), the device busy time
per step (union of kernel intervals), the device's idle share of the
profiled window, and device time per kernel name (per step of all the
replicas together for ``fit_batch``).  The profiler slows the host, so it
also times the same fit unprofiled and prints the idle share that the
profiled device time leaves of that wall time.  First, before any
profiler has run in the process, the host cost of the eps draws per step of
K = 1, 8, 32 replicas (one generator reseed and one ``randn`` per replica
and step, what keeps replica i on the stream of ``fit(seed_i)``), three
readings each.
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


def profile_fit(name, fitter, steps, torch, replicas=None, **kw):
    """Profile ``steps`` steps of ``fitter.fit`` (or of ``fit_batch`` over
    ``replicas`` seeds, with ``kw``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(seed, niter):
        if replicas is None:
            return fitter.fit(seed, batch_size=32, niter=niter,
                              verbose=False)
        return fitter.fit_batch(range(seed, seed + replicas), batch_size=32,
                                niter=niter, **kw)

    run(1, 15)                                                  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, steps - 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    run(0, steps - 1)
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for k in kernels:
        key = k.name[:90]
        by_name[key] = by_name.get(key, 0.0) + (k.time_range.end
                                                - k.time_range.start)
    busy = busy_us(kernels)
    print(json.dumps({
        "path": name, "steps": steps, "replicas": replicas or 1,
        "wall_us_per_step_profiled": wall_us / steps,
        "device_busy_us_per_step": busy / steps,
        "device_idle_share": (1.0 - busy / wall_us) if kernels else None,
        "wall_us_per_step_unprofiled": plain_wall_us / steps,
        "device_idle_share_unprofiled": 1.0 - busy / plain_wall_us,
        "kernel_launches_per_step": len(kernels) / steps,
        "device_us_per_step_by_kernel": {
            k: v / steps for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])},
    }), flush=True)


def draw_cost(fitter, k, torch, blocks=50, spc=8):
    """Host microseconds per step of a K6 block's eps draws for ``k``
    replicas (K2's block for k=1), synchronized at the end."""
    from gsmvi_tpu_torch.state import FactorVIState

    seed = tuple(range(k)) if k > 1 else 0
    state = FactorVIState(None, None, seed, 0, None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(blocks):
        torch.cat([fitter._draw(state, 32, j) for j in range(spc)], dim=-2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / (blocks * spc)


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
    fused = FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                      device="cuda")
    draw_cost(fused, 8, torch, blocks=5)                        # warm up
    print(json.dumps({"eps_draw_host_us_per_step": {
        f"K={k}": [draw_cost(fused, k, torch) for _ in range(3)]
        for k in (1, 8, 32)}}), flush=True)
    profile_fit("GSM (K1 per step)", GSM(256, t.lp, t.lp_g, device="cuda"),
                args.steps, torch)
    profile_fit("FactorGSM fused_score (K2+K3, spc=8)", fused, args.steps,
                torch)
    profile_fit("GSM use_factor=False (K5 + cholesky_ex per step)",
                GSM(256, t.lp, t.lp_g, device="cuda", use_factor=False),
                args.steps, torch)
    profile_fit("FactorGSM.fit_batch fused (K6+K3, spc=8), K=8", fused,
                args.steps, torch, replicas=8, small_solver="fused")
    profile_fit("FactorGSM.fit_batch ns (batched K1), K=8",
                FactorGSM(256, t.lp, t.lp_g, device="cuda"), args.steps,
                torch, replicas=8, small_solver="ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
