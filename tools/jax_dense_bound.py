#!/usr/bin/env python3
"""Errors of the JAX package's own dense GSM fits, the reference behind the
bound of ``chip_smoke.py``'s huge-batch phase.

    JAX_PLATFORMS=cpu python3 tools/jax_dense_bound.py --batch 512 \
        --niter 400 --keys 0 1 2 3

Fits ``gsmvi_tpu.GSM(use_factor=False)`` (the dense route, float32, on the
CPU) to the port's ``dense_gaussian(0, D)`` target, rebuilt here from the
same numpy seed (uniform mean, cov = L L^T + 1e-3 I with normal L), with
``PRNGKey(k)`` for each key, and prints one JSON line per fit with the
errors as ``bench.py:207-211`` defines them, then the worst of each.  This
script runs the JAX reference only; it imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def target_arrays(seed: int, d: int):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return mean.astype(np.float32), cov.astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--niter", type=int, default=400)
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gsmvi_tpu import GSM
    from gsmvi_tpu.models.gaussian import _gaussian_target

    mean, cov = target_arrays(0, args.d)
    t = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "dense")
    g = GSM(D=args.d, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32,
            use_factor=False)
    scale = max(1.0, float(np.abs(cov).max()))
    worst = [0.0, 0.0]
    for k in args.keys:
        t0 = time.perf_counter()
        m, c = g.fit(jax.random.PRNGKey(k), batch_size=args.batch,
                     niter=args.niter, verbose=False)
        em = float(np.abs(np.asarray(m) - mean).max())
        ec = float(np.abs(np.asarray(c) - cov).max()) / scale
        worst = [max(worst[0], em), max(worst[1], ec)]
        print(json.dumps({"key": k, "D": args.d, "B": args.batch,
                          "niter": args.niter, "mean_err": em,
                          "cov_err": ec,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"worst_mean_err": worst[0],
                      "worst_cov_err": worst[1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
