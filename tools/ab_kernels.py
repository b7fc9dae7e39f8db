#!/usr/bin/env python3
"""Device time of the bf16/bf16x3 thin product, BaM's fat apply and the
blocks around them, in one checkout of the port, on one NVIDIA GPU.

    python3 tools/ab_kernels.py CHECKOUT      # one JSON line

Run it on two checkouts in turns (A, B, B, A) in one call to compare them:
a card's neighbours and power limit vary between calls.  Every time is the
device time per call under ``torch.profiler`` (ns), the functions of a
group timed in one profiled window between one-element marker kernels:

- ``thin_ns MxD``: ``thin_product`` at "bf16" and "high" (``vf`` = rows F,
  ``t`` = rows F^T, ``ef`` = rows F^T with x = mu + ef), the float32 thin
  product's ``t`` and ``torch.mm`` on bf16 operands converted ahead, at
  (M, D) = (32, 256), (8, 200), (128, 256), (512, 1024);
- ``bam_apply_ns BxD``: BaM's fat apply at k = 2(B+1) (``bam_apply`` where
  the checkout has it), the 32x32 template (``gsmvi_bam_apply_oracle``, or
  ``gsmvi_bam_apply`` where the template is still the apply) and
  ``torch.addmm`` + the two sums of squares, at (B, D) = (32, 256),
  (128, 256), (32, 1024), (8, 33);
- ``bam_apply_by_k2_ns``: ``bam_apply`` at D=256 for k = 64, 66, 96, 128,
  130, 258 (where the checkout has it);
- ``blocks_ns``: K7 (tier 0) and a K8 8-step block at (32, 256) from (0,
  I), and a K2 8-step block at "highest", "high" and "bf16".
"""

from __future__ import annotations

import json
import os
import sys


def each(fns, calls, torch, profile_window, dev):
    """{key: device ns a call} of each function, one profiled window."""
    marker = torch.zeros(1, dtype=torch.float64, device=dev)
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()

    def window():
        for fn in fns.values():
            marker.neg_()
            for _ in range(calls):
                fn()
        marker.neg_()
        torch.cuda.synchronize()

    for _ in range(3):     # a window that lost a marker record runs again
        _, ks, _ = profile_window(window)
        ks = sorted(ks, key=lambda k: k.time_range.start)
        cuts = [i for i, k in enumerate(ks) if "neg_kernel" in k.name]
        if len(cuts) == len(fns) + 1:
            break
    assert len(cuts) == len(fns) + 1, f"{len(cuts)} markers, {len(fns)} fns"
    return {key: round(1e3 * sum(k.time_range.end - k.time_range.start
                                 for k in ks[lo + 1:hi]) / calls, 2)
            for key, lo, hi in zip(fns, cuts, cuts[1:])}


def main() -> int:
    checkout = os.path.abspath(sys.argv[1])
    sys.path.insert(0, checkout)
    import torch

    from tools.profile_gpu import profile_window
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.ops import bam_fused as bf
    from gsmvi_tpu_torch.ops import fused_step as fs

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    timed = lambda fns, calls: each(fns, calls, torch, profile_window, dev)
    res = {"checkout": checkout}
    g = torch.Generator(device=dev).manual_seed(1)
    for m, d in ((32, 256), (8, 200), (128, 256), (512, 1024)):
        rows = torch.randn((m, d), generator=g, device=dev)
        f = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
        mu = torch.randn(d, generator=g, device=dev)
        r16, f16 = rows.bfloat16(), f.bfloat16()
        fns = {}
        for p in ("bf16", "high"):
            fns[f"vf_{p}"] = lambda p=p: fs.thin_product(
                rows, f, trans=False, precision=p)
            fns[f"t_{p}"] = lambda p=p: fs.thin_product(
                rows, f, trans=True, precision=p)
            fns[f"ef_{p}"] = lambda p=p: fs.thin_product(
                rows, f, trans=True, mu=mu, precision=p)
        fns["t_f32"] = lambda: fs.thin_product(rows, f, trans=True)
        fns["mm_t"] = lambda: torch.mm(r16, f16.T)
        res[f"thin_ns {m}x{d}"] = timed(fns, 50 if d <= 256 else 20)

    lib, stream = fs._library(), fs._stream(dev)
    new = hasattr(bf, "bam_apply")
    template = "gsmvi_bam_apply_oracle" if new else "gsmvi_bam_apply"
    for b, d in ((32, 256), (128, 256), (32, 1024), (8, 33)):
        k2 = 2 * (b + 1)
        su = torch.randn((k2, d), generator=g, device=dev)
        sw = 0.1 * torch.randn((k2, d), generator=g, device=dev)
        f = torch.randn((d, d), generator=g, device=dev)
        out = torch.empty_like(f)
        part = torch.empty(2 * (-(-d // 32)) ** 2, device=dev)
        fns = {}
        if new:
            fns["bam_apply"] = lambda su=su, sw=sw, f=f: bf.bam_apply(su, sw,
                                                                      f)
        fns["template"] = lambda su=su, sw=sw, f=f, out=out, part=part, \
            k2=k2, d=d: lib.call(template, fs._ptr(su), fs._ptr(sw),
                                 fs._ptr(f), fs._ptr(out), fs._ptr(part),
                                 None, k2, d, 1, stream)
        fns["addmm_sums"] = lambda su=su, sw=sw, f=f: (lambda fp: (
            (fp * fp).sum(), (f * f).sum()))(torch.addmm(f, su.T, sw))
        res[f"bam_apply_ns {b}x{d}"] = timed(fns, 50)
    if new:
        fns = {}
        for k2 in (64, 66, 96, 128, 130, 258):
            su = torch.randn((k2, 256), generator=g, device=dev)
            sw = torch.randn((k2, 256), generator=g, device=dev)
            f = torch.randn((256, 256), generator=g, device=dev)
            fns[f"k{k2}"] = lambda su=su, sw=sw, f=f: bf.bam_apply(su, sw, f)
        res["bam_apply_by_k2_ns"] = timed(fns, 50)

    t = dense_gaussian(0, 256, device=dev)
    score_fn, params = t.fused_score
    b, d, spc = 32, 256, 8
    eps = torch.randn((b, d), generator=g, device=dev)
    mean, fac = torch.zeros(d, device=dev), torch.eye(d, device=dev)
    v = t.lp_g(mean + eps)
    block = torch.randn((spc * b, d), generator=g, device=dev)
    k8 = bf.make_fused_bam_multistep(score_fn, len(params), b, d, spc)
    reg = 100.0 / 2001
    fns = {"k7": lambda: bf.bam_eps_update_fused(eps, v, mean, fac, reg),
           "k8": lambda: k8([reg] * spc, spc, 0, block, mean, fac, *params)}
    for p in ("highest", "high", "bf16"):
        k2 = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc,
                                         precision=p)
        fns[f"k2_{p}"] = lambda k2=k2: k2(spc, block, mean, fac, *params)
    res["blocks_ns"] = timed(fns, 10)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
