#!/usr/bin/env python3
"""The eps-NS small space of the large batches (B 129-512,
``eps_smallspace_large``) on one NVIDIA GPU: device time by kernel, times
per call, and the B=256 fit that runs it.

    python3 tools/profile_large_b.py [--shapes 256x256 512x256 512x1024]
                                     [--fit-steps 64] [--no-fit]

For each (B, D), on K1's inputs of ``chip_smoke.py`` (a random factor
F = chol(A A^T / D + I), eps ~ N(0, 1), v = 0.3 N(0, 1), numpy seed 7000 +
B + D):

- ``small_space``: the small space alone (``fs.eps_smallspace`` on the
  rows e, v, vf = v F, t = vf F^T, ef = e F^T), ``tools/profile_gpu.py``'s
  ``profile_calls`` over 8 calls: device µs per call by kernel name and
  the kernels per call; and its mean ms per call between CUDA events over
  20 calls after 3 warm-up calls;
- ``k1``: K1 (``fs.gsm_eps_update_fused``, ``ef`` given) the same way;
- ``plain``: the small space's plain version
  (``fs.eps_smallspace_stacks_reference``) by CUDA events over 5 calls.

Then (unless ``--no-fit``) ``FactorGSM(fused_score)`` on
``dense_gaussian(0, 256)`` at B=256 (K2 at spc=8 with the small space in
every sub-step, as ``chip_smoke.py`` phase 18 runs it): one warm-up fit,
then three timed fits of ``--fit-steps`` steps, it/s each (host clock
around ``fit`` and a synchronize).  One JSON line per record, after the
card's name and power limit.  To time another checkout's port, copy this
script and ``profile_gpu.py`` into that checkout's ``tools/`` and run it
there: it puts its own checkout first on ``sys.path``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def inputs(np, torch, b, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    f = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (eps, v, mu, f)]


def events_ms(torch, fn, reps, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", nargs="*",
                        default=["256x256", "512x256", "512x1024"])
    parser.add_argument("--fit-steps", type=int, default=64)
    parser.add_argument("--no-fit", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_large_b: no CUDA device", file=sys.stderr)
        return 1
    from profile_gpu import profile_calls

    from gsmvi_tpu_torch import FactorGSM
    from gsmvi_tpu_torch.config import pin_fp32
    from gsmvi_tpu_torch.models import dense_gaussian
    from gsmvi_tpu_torch.ops import fused_step as fs

    pin_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for shape in args.shapes:
        b, d = map(int, shape.split("x"))
        e, v, mu, f = inputs(np, torch, b, d, 7000 + b + d)
        vf = v @ f
        t, ef = vf @ f.T, e @ f.T
        rows = (e, v, vf, t, ef, mu)
        small = lambda: fs.eps_smallspace(*rows)
        k1 = lambda: fs.gsm_eps_update_fused(e, v, mu, f, ef=ef)
        plain = lambda: fs.eps_smallspace_stacks_reference(
            e, v, vf, t, ef, mu.reshape(1, d), batch=b)
        rec = {"B": b, "D": d}
        for name, fn in (("small_space", small), ("k1", k1)):
            prof = profile_calls(f"{name} B={b} D={d}", fn, 8, torch,
                                 quiet=True)
            rec[name] = {
                "events_ms": events_ms(torch, fn, 20, 3),
                "device_us": prof["device_busy_us_per_call"],
                "kernels_per_call": prof["kernel_launches_per_call"],
                "host_launches_per_call": prof["host_launches_per_call"],
                "device_us_by_kernel": prof["device_us_per_call_by_kernel"]}
        rec["plain"] = {"events_ms": events_ms(torch, plain, 5, 1)}
        print(json.dumps(rec), flush=True)
    if args.no_fit:
        return 0
    tgt = dense_gaussian(0, 256, device="cuda")
    fg = FactorGSM(256, tgt.lp, tgt.lp_g, fused_score=tgt.fused_score,
                   device="cuda")
    rates = []
    for run in range(4):
        fs.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fg.fit(0, batch_size=256, niter=args.fit_steps, verbose=False)
        torch.cuda.synchronize()
        if run:
            rates.append((args.fit_steps + 1) / (time.perf_counter() - t0))
    print(json.dumps({"fit": "FactorGSM(fused_score) dense_gaussian(0, 256)",
                      "B": 256, "niter": args.fit_steps,
                      "iters_per_s": rates,
                      "launches": {k: n for k, n in fs.launch_counts().items()
                                   if n}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
