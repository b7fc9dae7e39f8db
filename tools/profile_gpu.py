#!/usr/bin/env python3
"""Where the time of the port's main path goes on one NVIDIA GPU.

    python3 tools/profile_gpu.py [--steps 64] [--bam-steps 2001]
                                 [--only-bam | --only-dense]

Profiles ``--steps`` steps of the GSM paths at the headline cell
(dense-Gaussian target, D=256, B=32) with ``torch.profiler``:
``GSM(..., device="cuda")`` (K1 per step),
``FactorGSM(..., fused_score=...)`` (K2 with K3 inside, spc=8), the same
at ``steps_per_call=1`` (K4 with K3 inside, one call per step), the dense
route ``GSM(..., use_factor=False)`` (K5 and the ``cholesky_ex``
accept/revert per step) and ``fit_batch`` of K=8 replicas on its "fused"
(K6) and "ns" (batched K1) routes; then ``--bam-steps`` steps (a whole
2001-step fit by default, so that the NS tiers mix as in a fit) of the BaM
paths, ``BaM.fit`` (K7 per step) and ``FactorBaM(fused_score=...)`` (K8
with K3 inside, spc=8), with ``Regularizers().linear(100.0)`` and
retries=0, each with its steps per NS tier (``--only-bam``: these
alone).  For each it prints one JSON line: the host wall time per step
(profiler on, so inflated), the device busy time per step (union of
kernel intervals), the device's idle share of the profiled window,
device time per kernel name (per step of all the replicas together for
``fit_batch``), and the device's kernels per step (a CUDA graph's nodes
included) and the host's runtime calls per step (kernel launches, graph
launches, copies) apart.  ``--only-dense``: the dense route's family
alone, ``GSM(..., use_factor=False)`` at B=32, ``GSM.fit`` at B=512 (the
huge-batch guard sends it dense) and ``GSM(..., use_factor=False)
.fit_batch`` of K=8 replicas at B=32, then K5 (``gsm_update_fused``) alone
per call at B=32, B=512 and K=8 x B=32, with its device allocations per
call.  Then the same device breakdown per
call of K4 alone (``make_fused_eps_step``, ns and chol) and K4a
(``gsm_eps_update_fused(method="chol")``), 64 calls back to back from
(0, I).  The profiler slows the host, so it
also times the same fit unprofiled and prints the idle share that the
profiled device time leaves of that wall time.  First, before any
profiler has run in the process, the host cost of the eps draws per step of
K = 1, 8, 32 replicas (one generator reseed and one in-place ``normal_``
per replica and step, what keeps replica i on the stream of
``fit(seed_i)``), three readings each.
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


def runtime_calls(prof, DeviceType) -> dict:
    """The CUDA runtime calls the host made in a profile, by name (kernel
    launches, graph launches, copies; not the final synchronize).  With
    CUDA graphs, ``kernel_launches_per_step`` counts the device's kernels
    (a graph's nodes included) and these the host's calls."""
    api = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA and e.name.startswith("cuda")
                and e.name != "cudaDeviceSynchronize"):
            api[e.name] = api.get(e.name, 0) + 1
    return api


def profile_fit(name, fitter, steps, torch, replicas=None, fit_args=(),
                counts=None, batch=32, **kw):
    """Profile ``steps`` steps of ``fitter.fit(seed, *fit_args, **kw)`` (or
    of ``fit_batch`` over ``replicas`` seeds, with ``kw``) at batch
    ``batch``; ``counts()``, when given, adds the fitter's counts of the
    profiled fit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(seed, niter):
        if replicas is None:
            return fitter.fit(seed, *fit_args, batch_size=batch, niter=niter,
                              verbose=False, **kw)
        return fitter.fit_batch(range(seed, seed + replicas),
                                batch_size=batch, niter=niter, **kw)

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
    api = runtime_calls(prof, DeviceType)
    print(json.dumps({
        "path": name, "steps": steps, "batch": batch,
        "replicas": replicas or 1,
        **({"fit_counts": counts()} if counts is not None else {}),
        "wall_us_per_step_profiled": wall_us / steps,
        "device_busy_us_per_step": busy / steps,
        "device_idle_share": (1.0 - busy / wall_us) if kernels else None,
        "wall_us_per_step_unprofiled": plain_wall_us / steps,
        "device_idle_share_unprofiled": 1.0 - busy / plain_wall_us,
        "kernel_launches_per_step": len(kernels) / steps,
        "host_kernel_launches_per_step": sum(
            v for k, v in api.items() if k.startswith("cudaLaunchKernel"))
        / steps,
        "graph_launches_per_step": api.get("cudaGraphLaunch", 0) / steps,
        "host_runtime_calls_per_step": {k: v / steps
                                        for k, v in sorted(api.items())},
        "device_us_per_step_by_kernel": {
            k: v / steps for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])},
    }), flush=True)


def profile_calls(name, fn, calls, torch, quiet=False) -> dict:
    """Device time per call, by kernel, of ``calls`` calls of ``fn``, and
    the device allocations it requests per call (the caching allocator's
    count, outside the profiled window).  Returns the record and prints it
    as a JSON line unless ``quiet``.  The profiler may drop a device
    record of a launch, so each kernel's
    records are counted (``launches_by_kernel``) beside the host's kernel
    launches (``host_launches_per_call``), and its mean per launch is
    given beside its total per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):                                          # warm up
        fn()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {}
    for k in kernels:
        spans.setdefault(k.name[:90], []).append(k.time_range.end
                                                 - k.time_range.start)
    api = runtime_calls(prof, DeviceType)
    rec = {
        "call": name, "calls": calls,
        "device_busy_us_per_call": busy_us(kernels) / calls,
        "kernel_launches_per_call": len(kernels) / calls,
        "host_launches_per_call": sum(
            v for k, v in api.items() if k.startswith("cudaLaunchKernel"))
        / calls,
        "allocations_per_call": allocs / calls,
        "launches_by_kernel": {k: len(v) for k, v in sorted(spans.items())},
        "device_us_per_launch_by_kernel": {
            k: sum(v) / len(v) for k, v in sorted(spans.items())},
        "device_us_per_call_by_kernel": {
            k: sum(v) / calls for k, v in sorted(
                spans.items(), key=lambda kv: -sum(kv[1]))},
    }
    if not quiet:
        print(json.dumps(rec), flush=True)
    return rec


def draw_cost(fitter, k, torch, blocks=50, spc=8):
    """Host microseconds per step of a K6 block's eps draws for ``k``
    replicas (K2's block for k=1), written in place into a block as the
    fit runner writes them (``driver.draw_block``), synchronized at the
    end."""
    from gsmvi_tpu_torch.driver import draw_block

    seed = tuple(range(k)) if k > 1 else 0
    lead = (k,) if k > 1 else ()
    out = torch.empty((*lead, spc * 32, fitter.D), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(blocks):
        draw_block(fitter._eps, out, seed, i * spc, spc, 32)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / (blocks * spc)


def profile_dense(t, steps, torch):
    """The dense route's family (``--only-dense``): its three fits, then
    K5 alone per call."""
    from gsmvi_tpu_torch import GSM
    from gsmvi_tpu_torch.ops import gsm_step as gs

    d = t.mean.shape[-1]
    profile_fit("GSM use_factor=False (K5 + cholesky_ex per step), B=32",
                GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False),
                steps, torch)
    profile_fit("GSM huge batch (K5 + cholesky_ex per step), B=512",
                GSM(d, t.lp, t.lp_g, device="cuda"), steps, torch, batch=512)
    profile_fit("GSM use_factor=False fit_batch (batched K5), K=8, B=32",
                GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False),
                steps, torch, replicas=8)
    gen = torch.Generator(device="cuda").manual_seed(19)
    for b, k in ((32, None), (512, None), (32, 8)):
        lead = () if k is None else (k,)
        a = torch.randn((*lead, d, d), generator=gen, device="cuda")
        s0 = a @ a.mT / d + torch.eye(d, device="cuda")
        s0 = 0.5 * (s0 + s0.mT)
        mu = torch.randn((*lead, d), generator=gen, device="cuda")
        x = mu[..., None, :] + torch.randn((*lead, b, d), generator=gen,
                                           device="cuda")
        v = torch.randn((*lead, b, d), generator=gen, device="cuda")
        profile_calls(f"K5 gsm_update_fused B={b} K={k or 1}",
                      lambda: gs.gsm_update_fused(x, v, mu, s0), 64, torch)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--bam-steps", type=int, default=2001)
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--only-bam", action="store_true")
    only.add_argument("--only-dense", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_gpu: no CUDA device", file=sys.stderr)
        return 1
    from gsmvi_tpu_torch import BaM, FactorBaM, FactorGSM, GSM, Regularizers
    from gsmvi_tpu_torch.models import dense_gaussian

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t = dense_gaussian(0, 256, device="cuda")
    if args.only_dense:
        profile_dense(t, args.steps, torch)
        return 0
    if not args.only_bam:
        fused = FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                          device="cuda")
        draw_cost(fused, 8, torch, blocks=5)                    # warm up
        print(json.dumps({"eps_draw_host_us_per_step": {
            f"K={k}": [draw_cost(fused, k, torch) for _ in range(3)]
            for k in (1, 8, 32)}}), flush=True)
        profile_fit("GSM (K1 per step)",
                    GSM(256, t.lp, t.lp_g, device="cuda"), args.steps, torch)
        profile_fit("FactorGSM fused_score (K2+K3, spc=8)", fused,
                    args.steps, torch)
        profile_fit("FactorGSM fused_score spc=1 (K4+K3 per step)",
                    FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                              steps_per_call=1, device="cuda"), args.steps,
                    torch)
        profile_fit("GSM use_factor=False (K5 + cholesky_ex per step)",
                    GSM(256, t.lp, t.lp_g, device="cuda", use_factor=False),
                    args.steps, torch)
        profile_fit("FactorGSM.fit_batch fused (K6+K3, spc=8), K=8", fused,
                    args.steps, torch, replicas=8, small_solver="fused")
        profile_fit("FactorGSM.fit_batch ns (batched K1), K=8",
                    FactorGSM(256, t.lp, t.lp_g, device="cuda"), args.steps,
                    torch, replicas=8, small_solver="ns")
    regf = Regularizers().linear(100.0)
    bam = BaM(256, t.lp, t.lp_g, device="cuda")
    profile_fit("BaM (K7 per step)", bam, args.bam_steps, torch,
                fit_args=(regf,), retries=0,
                counts=lambda: dict(bam._get_factor_fitter().fit_counts))
    fbam = FactorBaM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                     device="cuda")
    profile_fit("FactorBaM fused_score (K8+K3, spc=8)", fbam, args.bam_steps,
                torch, fit_args=(regf,), retries=0,
                counts=lambda: dict(fbam.fit_counts))
    if args.only_bam:
        return 0
    from gsmvi_tpu_torch.ops import fused_step as fs

    score_fn, params = t.fused_score
    gen = torch.Generator(device="cuda").manual_seed(17)
    e = torch.randn((32, 256), generator=gen, device="cuda")
    mean, f = torch.zeros(256, device="cuda"), torch.eye(256, device="cuda")
    v = t.lp_g(mean + e @ f.T)
    for method in ("ns", "chol"):
        step = fs.make_fused_eps_step(score_fn, len(params), 32, 256,
                                      external_eps=True, method=method)
        profile_calls(f"K4 make_fused_eps_step ({method}, external draw)",
                      lambda: step(e, mean, f, *params), 64, torch)
    profile_calls("K4a gsm_eps_update_fused(method='chol')",
                  lambda: fs.gsm_eps_update_fused(e, v, mean, f,
                                                  method="chol"), 64, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
