#!/usr/bin/env python3
"""it/s of two checkouts of the port, alternated on one NVIDIA GPU.

    python3 tools/ab_fits.py DIR_A DIR_B [--pairs 6]

For each pair, in turns (A then B, then B then A, ...), a fresh process per
checkout times two fits of ``GSM.fit`` (K1 per step) and two of
``FactorGSM(fused_score=...)`` (K2, spc=8) at the headline cell (D=256,
B=32, niter=3000, after a 200-step warm-up) with that checkout's
``gsmvi_tpu_torch`` on ``sys.path``, and prints one JSON line.  The first
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


def one(checkout: str) -> dict:
    """Time the fits with the port of ``checkout``."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from gsmvi_tpu_torch import GSM, FactorGSM
    from gsmvi_tpu_torch.models import dense_gaussian

    t = dense_gaussian(0, 256, device="cuda")
    fitters = {
        "GSM.fit": GSM(256, t.lp, t.lp_g, device="cuda"),
        "FactorGSM_k2": FactorGSM(256, t.lp, t.lp_g,
                                  fused_score=t.fused_score, device="cuda"),
    }
    out = {}
    for name, g in fitters.items():
        g.fit(1, batch_size=32, niter=200, verbose=False)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.fit(0, batch_size=32, niter=3000, verbose=False)
            torch.cuda.synchronize()
            rates.append(3001 / (time.perf_counter() - t0))
        out[name] = rates
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", nargs="*")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    if len(args.checkouts) != 2:
        parser.error("give two checkout directories")
    a, b = args.checkouts
    for pair in range(args.pairs):
        for side in ((a, b) if pair % 2 == 0 else (b, a)):
            res = subprocess.run([sys.executable, HERE, "--one", side],
                                 capture_output=True, text=True, timeout=600,
                                 cwd=side)
            if res.returncode != 0:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            print(json.dumps({"pair": pair, "checkout": side,
                              **json.loads(res.stdout.splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
