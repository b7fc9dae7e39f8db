#!/usr/bin/env python3
"""Errors of the JAX package's own CPU ``fit_batch`` replicas behind the
bounds of ``chip_smoke.py``'s phase 22 on ``BaM.fit_batch`` and
``ADVI.fit_batch``.

    JAX_PLATFORMS=cpu python3 tools/jax_fit_batch_bound.py [--keys 8] [--niter 500]

The target is rebuilt from the port's numpy recipe of ``dense_gaussian(0,
256)`` (``tools/jax_example_bound.dense_arrays``).  With ``PRNGKey(k)`` for
k in 0..keys-1, at B=32 and float32, the JAX package runs
``BaM(use_factor=False).fit_batch`` (its dense step vmapped over the
replicas, ``gsmvi_tpu/bam.py:282-311``) with
``Regularizers().linear(100.0)`` and retries=0, and ``ADVI.fit_batch``
(``gsmvi_tpu/advi.py:620-655``) with ``optax.adam(1e-2)``, each for
``niter`` steps.  It prints one JSON line per replica (errors as
``bench.py:207-211`` defines them) and one per fitter with the worst of
each.  This script runs the JAX reference only; it imports nothing of the
port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, B, REGF0, ADVI_LR = 256, 32, 100.0, 1e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--niter", type=int, default=500)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    import gsmvi_tpu as g
    from chip_smoke import moment_errs
    from gsmvi_tpu.models.gaussian import _gaussian_target
    from tools.jax_example_bound import dense_arrays

    mean_t, cov_t = dense_arrays(0, D)
    t = _gaussian_target(jnp.asarray(mean_t), jnp.asarray(cov_t), "dense")
    keys = jnp.stack([jax.random.PRNGKey(k) for k in range(args.keys)])
    runs = {
        "bam_fit_batch": lambda: g.BaM(
            D=D, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32,
            use_factor=False).fit_batch(
                keys, g.Regularizers().linear(REGF0), batch_size=B,
                niter=args.niter, retries=0),
        "advi_fit_batch": lambda: g.ADVI(
            D=D, lp=t.lp, dtype=jnp.float32).fit_batch(
                keys, optax.adam(ADVI_LR), batch_size=B,
                niter=args.niter)[:2],
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        means, covs = run()
        seconds = time.perf_counter() - t0
        worst = [0.0, 0.0]
        for k in range(args.keys):
            em, ec = moment_errs(np.asarray(means[k], np.float64),
                                 np.asarray(covs[k], np.float64),
                                 mean_t.astype(np.float64),
                                 cov_t.astype(np.float64))
            worst = [max(worst[0], em), max(worst[1], ec)]
            print(json.dumps({"config": name, "key": k, "D": D, "B": B,
                              "niter": args.niter, "mean_err": em,
                              "cov_err": ec}), flush=True)
        print(json.dumps({"config": name, "keys": args.keys,
                          "niter": args.niter, "worst_mean_err": worst[0],
                          "worst_cov_err": worst[1], "seconds": seconds}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
