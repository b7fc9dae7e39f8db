#!/usr/bin/env python3
"""it/s of two checkouts of the port, alternated on one NVIDIA GPU.

    python3 tools/ab_fits.py DIR_A DIR_B [--pairs 6] [--family gsm|bam]

For each pair, in turns (A then B, then B then A, ...), a fresh process per
checkout times two fits of each fitter of the family at the headline cell
(D=256, B=32, after a 200-step warm-up) with that checkout's
``gsmvi_tpu_torch`` on ``sys.path``, and prints one JSON line.  Family
``gsm``: ``GSM.fit`` (K1 per step) and ``FactorGSM(fused_score=...)`` (K2,
spc=8), niter=3000.  Family ``bam``: ``BaM.fit`` (K7 per step) and
``FactorBaM(fused_score=...)`` (K8, spc=8), niter=2000 with
``Regularizers().linear(100.0)`` and retries=0, as ``chip_smoke.py``
runs them.  The first
use in each checkout builds its kernels, so build both before timing.
Compare two versions only inside one call: a card's neighbours and power
limit vary between calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)


def one(checkout: str, family: str) -> dict:
    """Time the fits of ``family`` with the port of ``checkout``."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from gsmvi_tpu_torch import BaM, FactorBaM, FactorGSM, GSM, Regularizers
    from gsmvi_tpu_torch.models import dense_gaussian

    t = dense_gaussian(0, 256, device="cuda")
    if family == "gsm":
        niter, args, kw = 3000, (), {}
        fitters = {
            "GSM.fit": GSM(256, t.lp, t.lp_g, device="cuda"),
            "FactorGSM_k2": FactorGSM(256, t.lp, t.lp_g,
                                      fused_score=t.fused_score,
                                      device="cuda"),
        }
    else:
        niter, args, kw = 2000, (Regularizers().linear(100.0),), {
            "retries": 0}
        fitters = {
            "BaM.fit": BaM(256, t.lp, t.lp_g, device="cuda"),
            "FactorBaM_k8": FactorBaM(256, t.lp, t.lp_g,
                                      fused_score=t.fused_score,
                                      device="cuda"),
        }
    out = {}
    for name, g in fitters.items():
        g.fit(1, *args, batch_size=32, niter=200, verbose=False, **kw)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.fit(0, *args, batch_size=32, niter=niter, verbose=False, **kw)
            torch.cuda.synchronize()
            rates.append((niter + 1) / (time.perf_counter() - t0))
        out[name] = rates
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", nargs="*")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--family", choices=("gsm", "bam"), default="gsm")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.family)), flush=True)
        return 0
    if len(args.checkouts) != 2:
        parser.error("give two checkout directories")
    a, b = (os.path.abspath(c) for c in args.checkouts)
    for pair in range(args.pairs):
        for side in ((a, b) if pair % 2 == 0 else (b, a)):
            res = subprocess.run([sys.executable, HERE, "--one", side,
                                  "--family", args.family],
                                 capture_output=True, text=True, timeout=600,
                                 cwd=side)
            if res.returncode != 0:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            print(json.dumps({"pair": pair, "checkout": side,
                              "family": args.family,
                              **json.loads(res.stdout.splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
