#!/usr/bin/env python3
"""it/s of two checkouts of the port, alternated on one NVIDIA GPU.

    python3 tools/ab_fits.py DIR_A DIR_B [--pairs 6]
                             [--family gsm|bam|batch|b128|dense|advi|zoo|
                                       prec]

For each pair, in turns (A then B, then B then A, ...), a fresh process per
checkout times two fits of each fitter of the family at the headline cell
(D=256, B=32, after a 200-step warm-up) with that checkout's
``gsmvi_tpu_torch`` on ``sys.path``, and prints one JSON line.  Family
``gsm``: ``GSM.fit`` (K1 per step) and ``FactorGSM(fused_score=...)`` (K2,
spc=8), niter=3000.  Family ``bam``: ``BaM.fit`` (K7 per step) and
``FactorBaM(fused_score=...)`` (K8, spc=8), niter=2000 with
``Regularizers().linear(100.0)`` and retries=0, as ``chip_smoke.py``
runs them.  Family ``batch``: ``FactorGSM(fused_score=...).fit_batch(
range(8), ..., small_solver="fused")`` (K6, K=8 replicas, spc=8),
niter=3000; its rate is per replica (the aggregate is 8 times it).
Family ``b128``: the large-batch small spaces' fits at D=256, B=128,
``FactorGSM(fused_score=...)`` (K2, spc=8) with niter=3000 and
``FactorBaM(fused_score=...)`` (K8) with niter=200, as ``chip_smoke.py``
runs them (after a 200- and a 50-step warm-up).  Family ``dense``: the
dense route on K5, ``GSM(..., use_factor=False)`` at B=32, ``GSM.fit`` at
B=512 (the huge-batch guard sends it dense) and ``GSM(...,
use_factor=False).fit_batch(range(8), ...)`` at B=32 (batched K5; per
replica), niter=1000 each after a 100-step warm-up.  Family ``advi``:
``ADVI(..., fused_score=...).fit_fused`` (spc=8) as ``chip_smoke.py``'s
phase 9 runs it, the analytic estimator (K9) for 3000 steps at lr 1e-2,
then the STL estimator (K10) for 2000 steps at lr 3e-3 from the analytic
fit's state, and the two-phase recipe's rate over both (``bench.py``'s
"analytic bulk, STL polish"), after a 200- and a 50-step warm-up.
Family ``zoo``: the zoo paths whose scores are products,
``FactorGSM(fused_score=...)`` (K2 with K11a or K11b inside, spc=8) on
``student_t(0, 256, df=6)`` and ``logistic_regression(0, 256)`` (N=200),
niter=3000, as ``chip_smoke.py``'s phase 20 runs them.  Family
``prec``: ``FactorGSM(fused_score=..., pallas_precision=p)`` (K2 with its
row products and fat apply on the bf16 tensor-core kernels, spc=8) for p
in "bf16" and "high", niter=3000, as ``chip_smoke.py``'s phase 24 runs
them.  A last
line gives, per
fit, the median and quartiles of each checkout's readings and the pairs
in which the second checkout was faster.  The first use in each
checkout builds its kernels, so build both before timing.
Compare two versions only inside one call: a card's neighbours and power
limit vary between calls.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
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
    if family == "advi":
        from gsmvi_tpu_torch import ADVI

        g = ADVI(256, t.lp, fused_score=t.fused_score, device="cuda")
        fit = lambda n, **kw: g.fit_fused(0, batch_size=32, niter=n,
                                          verbose=False, return_state=True,
                                          **kw)[0]
        warm = fit(200, learning_rate=1e-2)
        fit(50, learning_rate=3e-3, estimator="stl", state=warm)
        out = {"ADVI_fused_analytic": [], "ADVI_fused_stl": [],
               "ADVI_two_phase": []}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bulk = fit(3000, learning_rate=1e-2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fit(2000, learning_rate=3e-3, estimator="stl", state=bulk)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out["ADVI_fused_analytic"].append(3001 / (t1 - t0))
            out["ADVI_fused_stl"].append(2001 / (t2 - t1))
            out["ADVI_two_phase"].append(5002 / (t2 - t0))
        return out
    if family == "dense":
        dense = GSM(256, t.lp, t.lp_g, device="cuda", use_factor=False)
        huge = GSM(256, t.lp, t.lp_g, device="cuda")
        runs = {
            "GSM_dense_b32": lambda s, n: dense.fit(
                s, batch_size=32, niter=n, verbose=False),
            "GSM_huge_b512": lambda s, n: huge.fit(
                s, batch_size=512, niter=n, verbose=False),
            "GSM_dense_fit_batch_K8": lambda s, n: dense.fit_batch(
                range(s, s + 8), batch_size=32, niter=n),
        }
        out = {}
        for name, run in runs.items():
            run(1, 100)
            rates = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(0, 1000)
                torch.cuda.synchronize()
                rates.append(1001 / (time.perf_counter() - t0))
            out[name] = rates
        return out
    if family == "batch":
        g = FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                      device="cuda")
        run = lambda n: g.fit_batch(range(8), batch_size=32, niter=n,
                                    small_solver="fused")
        run(200)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(3000)
            torch.cuda.synchronize()
            rates.append(3001 / (time.perf_counter() - t0))
        return {"FactorGSM_fit_batch_k6_K8": rates}
    if family in ("gsm", "b128"):
        niter, args, kw = 3000, (), {}
        fitters = {
            "GSM.fit": GSM(256, t.lp, t.lp_g, device="cuda"),
            "FactorGSM_k2": FactorGSM(256, t.lp, t.lp_g,
                                      fused_score=t.fused_score,
                                      device="cuda"),
        }
    elif family == "prec":
        niter, args, kw = 3000, (), {}
        fitters = {
            f"FactorGSM_k2_{p}": FactorGSM(256, t.lp, t.lp_g,
                                           fused_score=t.fused_score,
                                           pallas_precision=p, device="cuda")
            for p in ("bf16", "high")}
    elif family == "zoo":
        from gsmvi_tpu_torch.models import logistic_regression, student_t

        niter, args, kw = 3000, (), {}
        fitters = {
            f"FactorGSM_k2_{z.name}": FactorGSM(
                256, z.lp, z.lp_g, fused_score=z.fused_score, device="cuda")
            for z in (student_t(0, 256, df=6.0, device="cuda"),
                      logistic_regression(0, 256, device="cuda"))}
    else:
        niter, args, kw = 2000, (Regularizers().linear(100.0),), {
            "retries": 0}
        fitters = {
            "BaM.fit": BaM(256, t.lp, t.lp_g, device="cuda"),
            "FactorBaM_k8": FactorBaM(256, t.lp, t.lp_g,
                                      fused_score=t.fused_score,
                                      device="cuda"),
        }
    # name: (fitter, fit args, fit kwargs, batch, warm-up steps, niter)
    runs = {name: (g, args, kw, 32, 200, niter) for name, g in fitters.items()}
    if family == "b128":
        runs = {
            "FactorGSM_k2_b128": (
                FactorGSM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                          device="cuda"), (), {}, 128, 200, 3000),
            "FactorBaM_k8_b128": (
                FactorBaM(256, t.lp, t.lp_g, fused_score=t.fused_score,
                          device="cuda"), (Regularizers().linear(100.0),),
                {"retries": 0}, 128, 50, 200),
        }
    out = {}
    for name, (g, fargs, fkw, batch, warm, n) in runs.items():
        g.fit(1, *fargs, batch_size=batch, niter=warm, verbose=False, **fkw)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.fit(0, *fargs, batch_size=batch, niter=n, verbose=False, **fkw)
            torch.cuda.synchronize()
            rates.append((n + 1) / (time.perf_counter() - t0))
        out[name] = rates
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkouts", nargs="*")
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--family", choices=("gsm", "bam", "batch", "b128",
                                             "dense", "advi", "zoo", "prec"),
                        default="gsm")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.family)), flush=True)
        return 0
    if len(args.checkouts) != 2:
        parser.error("give two checkout directories")
    a, b = (os.path.abspath(c) for c in args.checkouts)
    rates = {}
    for pair in range(args.pairs):
        for side in ((a, b) if pair % 2 == 0 else (b, a)):
            res = subprocess.run([sys.executable, HERE, "--one", side,
                                  "--family", args.family],
                                 capture_output=True, text=True, timeout=600,
                                 cwd=side)
            if res.returncode != 0:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            got = json.loads(res.stdout.splitlines()[-1])
            for name, vals in got.items():
                rates.setdefault(name, {}).setdefault(side, []).append(vals)
            print(json.dumps({"pair": pair, "checkout": side,
                              "family": args.family, **got}), flush=True)
    print(json.dumps({"summary": summary(rates, a, b)}), flush=True)
    return 0


def summary(rates: dict, a: str, b: str) -> dict:
    """Per fit and checkout: the median and quartiles (linear
    interpolation) of every reading, and the pairs in which B's mean
    reading beat A's."""
    quartiles = lambda xs: statistics.quantiles(xs, n=4, method="inclusive")
    out = {}
    for name, by_side in rates.items():
        mean = {s: [sum(v) / len(v) for v in by_side[s]] for s in (a, b)}
        out[name] = {
            "A_q25_median_q75": quartiles([x for v in by_side[a] for x in v]),
            "B_q25_median_q75": quartiles([x for v in by_side[b] for x in v]),
            "pairs_B_faster": sum(y > x for x, y in zip(mean[a], mean[b])),
            "pairs": len(mean[a])}
    return out


if __name__ == "__main__":
    sys.exit(main())
