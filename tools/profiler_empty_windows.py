#!/usr/bin/env python3
"""How often ``torch.profiler`` hands back a window with no device record.

    python3 tools/profiler_empty_windows.py [--windows 900] [--calls 50]

Runs ``--windows`` profiled windows of ``--calls`` back-to-back calls each,
taking in turn the Student-t score's library yardstick (``addmm``), a plain
``mm`` of the same shape and the port's Student-t kernel, at B=32, D=256,
with each window under its own ``profile()`` as ``chip_smoke.py``'s
``device_ms`` opens it (without its re-runs).  For each call it prints one
JSON line: the windows, those with no device record, and the device records
a window (least, median, most).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=900)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gsmvi_tpu_torch import models

    if not torch.cuda.is_available():
        print("profiler_empty_windows: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    b, d = 32, 256
    score_fn, params = models.student_t(0, d, df=6.0, device=dev).fused_score
    x = torch.randn((b, d), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    loc, prec = params[0], params[1]
    lp = loc @ prec
    fns = {"addmm": lambda: torch.addmm(lp, x, prec, beta=-1.0),
           "mm": lambda: torch.mm(x, prec),
           "student_t_score": lambda: score_fn(x, *params)}
    records = {k: [] for k in fns}
    for i in range(args.windows):
        name = list(fns)[i % len(fns)]
        fn = fns[name]
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        records[name].append(sum(e.device_type == DeviceType.CUDA
                                 for e in prof.events()))
    for name, r in records.items():
        r = np.array(r)
        print(json.dumps({"call": name, "calls_a_window": args.calls,
                          "windows": len(r), "empty": int((r == 0).sum()),
                          "records_min": int(r.min()),
                          "records_median": float(np.median(r)),
                          "records_max": int(r.max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
