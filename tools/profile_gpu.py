#!/usr/bin/env python3
"""Where the time of the port's main path goes on one NVIDIA GPU.

    python3 tools/profile_gpu.py [--steps 64] [--bam-steps 2001]
                                 [--only-gsm | --only-bam | --only-dense |
                                  --only-advi | --only-chol]

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
alone; ``--only-gsm``: the GSM paths alone).  For each it prints one JSON line: the host wall time per step
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
call.  ``--only-advi``: ``ADVI.fit_fused`` alone, the analytic
estimator (K9 with K3 inside, spc=8, lr 1e-2) from a fresh start, the STL
estimator (K10, lr 3e-3) from the state of a 3,000-step analytic bulk (the
two-phase recipe), and the zoo's funnel on K9 (K11a inside); then K9 and
K10 alone per 8-step block on a benign state, with each fit's device
allocations per block (two fits of ``--steps`` and 2 ``--steps`` steps,
their difference over the extra blocks).  Then the same device breakdown per
call of K4 alone (``make_fused_eps_step``, ns and chol) and K4a
(``gsm_eps_update_fused(method="chol")``), 64 calls back to back from
(0, I).  ``--only-chol``: those K4 chol and K4a calls alone, at (B, D) =
(32, 256) and (64, 256), each beside one ``torch.linalg.cholesky_ex`` of
the step's jittered (2B, 2B) Gram (a partial library yardstick: the first
of K4a's two factorizations), and the K4a call's CUDA-event time per call
(200 calls); then the Philox draw of K4's on-card route
(``philox_normal``) at (32, 256).  The profiler slows the host, so it
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


def profile_window(window, tries: int = 3) -> tuple:
    """(profile, its device kernel records, ``window()``'s value): one run
    of ``window`` under ``torch.profiler`` (host and CUDA activity).  Now
    and then the profiler hands back a window with no device record at
    all, although the device ran; such a window is run again, up to
    ``tries`` runs in all, each empty one reported on stderr.  Raises if
    every run came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = window()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            return prof, kernels, out
        print(json.dumps({"profile_window": "no device records",
                          "run": attempt, "of": tries}),
              file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler saw no device time in {tries} runs")


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
                counts=None, batch=32, method="fit", **kw):
    """Profile ``steps`` steps of ``fitter.fit(seed, *fit_args, **kw)`` (or
    of the fitter's ``method``, or of ``fit_batch`` over ``replicas``
    seeds, with ``kw``) at batch ``batch``; ``counts()``, when given, adds
    the fitter's counts of the profiled fit."""
    from torch.autograd import DeviceType

    def run(seed, niter):
        if replicas is None:
            return getattr(fitter, method)(seed, *fit_args,
                                           batch_size=batch, niter=niter,
                                           verbose=False, **kw)
        return fitter.fit_batch(range(seed, seed + replicas),
                                batch_size=batch, niter=niter, **kw)

    run(1, 15)                                                  # warm up
    torch.cuda.synchronize()

    def window():
        t0 = time.perf_counter()
        run(0, steps - 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    prof, kernels, wall_us = profile_window(window)
    t0 = time.perf_counter()
    run(0, steps - 1)
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
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

    for _ in range(5):                                          # warm up
        fn()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    torch.cuda.synchronize()

    def window():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    prof, kernels, _ = profile_window(window)
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


def fit_allocations(fit, steps, torch, spc=8) -> float:
    """Device allocations per block of a fit: ``fit(niter)`` run for
    ``steps`` and for 2 ``steps`` steps, the difference over the extra
    blocks (what a fit allocates once, at its start and end, cancels)."""
    counts = []
    for n in (steps, 2 * steps):
        fit(n - 1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fit(n - 1)
        torch.cuda.synchronize()
        counts.append(torch.cuda.memory_stats()["allocation.all.allocated"]
                      - before)
    return (counts[1] - counts[0]) / (steps / spc)


def profile_advi(t, steps, torch):
    """``--only-advi``: ``ADVI.fit_fused`` analytic, STL after an analytic
    bulk, and on the funnel; then K9 and K10 alone per block."""
    from gsmvi_tpu_torch import ADVI
    from gsmvi_tpu_torch.models import funnel
    from gsmvi_tpu_torch.ops import advi_fused as af

    d, b, spc = 256, 32, 8
    g = ADVI(d, t.lp, fused_score=t.fused_score, device="cuda")
    bulk = g.fit_fused(0, learning_rate=1e-2, batch_size=b, niter=3000,
                       verbose=False, return_state=True)[0]
    zoo = funnel(d, device="cuda")
    gz = ADVI(d, zoo.lp, fused_score=zoo.fused_score, device="cuda")
    runs = (
        ("ADVI.fit_fused analytic (K9+K3, spc=8)", g,
         {"learning_rate": 1e-2}),
        ("ADVI.fit_fused STL after the analytic bulk (K10+K3, spc=8)", g,
         {"learning_rate": 3e-3, "estimator": "stl", "state": bulk}),
        ("ADVI.fit_fused funnel (K9+K11a, spc=8)", gz,
         {"learning_rate": 1e-2}))
    for name, fitter, kw in runs:
        profile_fit(name, fitter, steps, torch, method="fit_fused",
                    counts=lambda f=fitter: dict(f.fit_counts), **kw)
        allocs = fit_allocations(
            lambda n, f=fitter, kw=kw: f.fit_fused(
                0, batch_size=b, niter=n, verbose=False, **kw), steps,
            torch, spc)
        print(json.dumps({"path": name, "allocations_per_block": allocs}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(23)
    cu = lambda x: x.to("cuda").contiguous()
    l = torch.tril(torch.eye(d) + 0.02 * torch.randn(
        (d, d), generator=torch.Generator().manual_seed(23)))
    l, ainv = cu(l), cu(torch.linalg.inv(l.double()).tril().float())
    loc = 0.1 * torch.randn(d, generator=gen, device="cuda")
    block = torch.randn((spc * b, d), generator=gen, device="cuda")
    z, zz = torch.zeros(d, device="cuda"), torch.zeros((d, d), device="cuda")
    score_fn, params = t.fused_score
    lrs = [1e-3] * spc
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    k9 = af.make_fused_advi_multistep(score_fn, len(params), b, d, spc)
    k10 = af.make_fused_advi_stl_multistep(score_fn, len(params), b, d, spc)
    n_done = int(k10(lrs, bc1s, bc2s, spc, block, loc, l, ainv, z, z, zz, zz,
                     *params)[-2])
    if n_done != spc:
        raise RuntimeError(f"K10's profiled block stopped at {n_done}")
    profile_calls("K9 make_fused_advi_multistep, one 8-step block",
                  lambda: k9(lrs, bc1s, bc2s, spc, block, loc, l, z, z, zz,
                             zz, *params), 64, torch)
    profile_calls("K10 make_fused_advi_stl_multistep, one 8-step block",
                  lambda: k10(lrs, bc1s, bc2s, spc, block, loc, l, ainv, z,
                              z, zz, zz, *params), 64, torch)


def jittered_gram(e, v, f, jitter: float = 1e-6):
    """The K4a update's (2B, 2B) Gram Z^T Z + jitter (tr / 2B + 1) I of
    rows e, scores v and factor f, in their dtype (``_eps_update_core``)."""
    import torch

    b = e.shape[0]
    a = -(e @ f.T)
    vf = v @ f
    t = vf @ f.T
    vsv = (v * t).sum(1, keepdim=True)
    mv = (a * v).sum(1, keepdim=True)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    w = (v * (t - a)).sum(1, keepdim=True)
    inv1r = 1.0 / (1.0 + rho)
    gamma = 1.0 - (1.0 + w / (1.0 + rho + mv)) * inv1r
    zt = torch.cat([-e, -e * gamma + vf * inv1r]) / b ** 0.5
    g = zt @ zt.T
    eye = torch.eye(2 * b, dtype=e.dtype, device=e.device)
    return g + jitter * (torch.trace(g) / (2 * b) + 1.0) * eye


def profile_chol(t, torch, d: int = 256) -> None:
    """``--only-chol``: K4's chol step and K4a per call at (32, d) and
    (64, d) on the device, beside ``cholesky_ex`` of the jittered Gram
    (``t`` a target of dimension d); then the Philox draw at (32, d)."""
    from gsmvi_tpu_torch.ops import fused_step as fs

    score_fn, params = t.fused_score
    for b in (32, 64):
        gen = torch.Generator(device="cuda").manual_seed(17)
        e = torch.randn((b, d), generator=gen, device="cuda")
        mean, f = torch.zeros(d, device="cuda"), torch.eye(d, device="cuda")
        v = t.lp_g(mean + e @ f.T)
        step = fs.make_fused_eps_step(score_fn, len(params), b, d,
                                      external_eps=True, method="chol")
        profile_calls(f"K4 make_fused_eps_step (chol, external draw) B={b}",
                      lambda: step(e, mean, f, *params), 64, torch)
        k4a = lambda: fs.gsm_eps_update_fused(e, v, mean, f, method="chol")
        rec = profile_calls(f"K4a gsm_eps_update_fused(method='chol') B={b}",
                            k4a, 64, torch, quiet=True)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            k4a()
        stop.record()
        torch.cuda.synchronize()
        rec["events_us_per_call"] = start.elapsed_time(stop) * 1e3 / 200
        rec["good"] = bool(k4a()[2])
        print(json.dumps(rec), flush=True)
        g = jittered_gram(e, v, f)
        profile_calls(f"library cholesky_ex of the jittered (2B)^2 Gram B={b} "
                      "(partial: the first factorization)",
                      lambda: torch.linalg.cholesky_ex(g), 64, torch)
    profile_calls("Philox draw philox_normal B=32",
                  lambda: fs.philox_normal(7, 32, d, device="cuda"), 64, torch)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--bam-steps", type=int, default=2001)
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--only-gsm", action="store_true")
    only.add_argument("--only-bam", action="store_true")
    only.add_argument("--only-dense", action="store_true")
    only.add_argument("--only-advi", action="store_true")
    only.add_argument("--only-chol", action="store_true")
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
    if args.only_advi:
        profile_advi(t, args.steps, torch)
        return 0
    if args.only_chol:
        profile_chol(t, torch)
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
    if args.only_gsm:
        return 0
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
