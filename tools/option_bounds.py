#!/usr/bin/env python3
"""CPU errors behind the bounds of ``chip_smoke.py``'s phases 24 and 25.

    JAX_PLATFORMS=cpu python3 tools/option_bounds.py                # all
    JAX_PLATFORMS=cpu python3 tools/option_bounds.py --only high qr

Every fit is the main path's configuration: ``dense_gaussian(0, 256)``'s
arrays, B=32, niter=3000, float32, errors as ``bench.py:207-211`` defines
them, one fit per key.

- high, bf16: the port's ``FactorGSM(fused_score=t.fused_score,
  pallas_precision=p)`` on its kernel path, whose wrappers run their plain
  versions on CPU tensors (``gsmvi_tpu_torch.gsm_factor.on_gpu`` patched):
  K2's plain version with the products at ``p`` (``ops/fused_step.mm_prec``,
  the semantics the card's tensor-core kernels implement), seeded with the
  key.  The JAX package cannot give these numbers on the CPU: XLA's CPU
  backend ignores ``Precision.DEFAULT``/``HIGH`` and computes float32.
- qr, twophase: the JAX package's ``FactorGSM(method=m)`` (its XLA step,
  ``refresh_every=1000``) with ``PRNGKey(key)``.

It prints one JSON line per fit and one per configuration with the worst
of each error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, B, NITER = 256, 32, 3000


def moment_errs(mean, cov, true_mean, true_cov) -> tuple:
    scale = max(1.0, float(np.abs(true_cov).max()))
    return (float(np.abs(mean - true_mean).max()),
            float(np.abs(cov - true_cov).max()) / scale)


def port_precision_fit(precision: str, key: int) -> tuple:
    import torch

    import gsmvi_tpu_torch.gsm_factor as t_gf
    from gsmvi_tpu_torch import FactorGSM
    from gsmvi_tpu_torch.models import dense_gaussian

    torch.set_num_threads(max(1, os.cpu_count() // 2))
    t_gf.on_gpu = lambda device: True
    t = dense_gaussian(0, D, device="cpu")
    fg = FactorGSM(D, t.lp, t.lp_g, fused_score=t.fused_score,
                   pallas_precision=precision, device="cpu")
    st = fg.fit(key, batch_size=B, niter=NITER, verbose=False,
                return_state=True)
    em, ec = moment_errs(st.mean.numpy(), st.cov.numpy(), t.mean.numpy(),
                         t.cov.numpy())
    return em, ec, int(st.n_accepted)


def jax_method_fit(method: str, key: int) -> tuple:
    import jax
    import jax.numpy as jnp

    from gsmvi_tpu import FactorGSM as JFactorGSM
    from gsmvi_tpu.models.gaussian import _gaussian_target

    rng = np.random.default_rng(0)
    mean = rng.uniform(size=D)
    l = rng.standard_normal((D, D))
    cov = (l @ l.T + 1e-3 * np.eye(D)).astype(np.float32)
    mean = mean.astype(np.float32)
    t = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    st = JFactorGSM(D=D, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32,
                    method=method).fit(jax.random.PRNGKey(key), batch_size=B,
                                       niter=NITER, verbose=False,
                                       return_state=True)
    from gsmvi_tpu.ops.gsm_factor import factor_to_cov

    em, ec = moment_errs(np.asarray(st.mean),
                         np.asarray(factor_to_cov(st.factor)), mean, cov)
    return em, ec, int(st.n_accepted)


CONFIGS = {"high": lambda k: port_precision_fit("high", k),
           "bf16": lambda k: port_precision_fit("bf16", k),
           "qr": lambda k: jax_method_fit("qr", k),
           "twophase": lambda k: jax_method_fit("twophase", k)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(CONFIGS))
    ap.add_argument("--keys", type=int, default=8)
    args = ap.parse_args()
    for name in args.only:
        worst = [0.0, 0.0]
        for key in range(args.keys):
            t0 = time.perf_counter()
            em, ec, nacc = CONFIGS[name](key)
            worst = [max(worst[0], em), max(worst[1], ec)]
            print(json.dumps({"config": name, "key": key, "mean_err": em,
                              "cov_err": ec, "n_accepted": nacc,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        print(json.dumps({"config": name, "keys": args.keys,
                          "worst_mean_err": worst[0],
                          "worst_cov_err": worst[1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
