#!/usr/bin/env python3
"""Errors of the JAX package's own CPU fits behind the bounds of
``chip_smoke.py``'s phases 18 and 20.

    JAX_PLATFORMS=cpu python3 tools/jax_example_bound.py              # all
    JAX_PLATFORMS=cpu python3 tools/jax_example_bound.py --only gsm10 bam5

Each configuration is fitted with ``PRNGKey(k)`` for every key, on every
route the JAX package runs it on the CPU, to a target rebuilt here from the
same numpy recipe as the port's (``gsmvi_tpu_torch.models``):

- gsm10, gsm16: ``dense_gaussian`` of numpy seeds 3 (D=10) and 11 (D=16),
  the shapes of ``examples/example_gsm.py`` (B=2, niter=500) and
  ``examples/example_initializers.py`` (B=1, niter=500); ``GSM`` (its dense
  route off the TPU) and ``FactorGSM`` (its XLA eps step).
- bam5: ``dense_gaussian`` of numpy seed 5, D=5, ``examples/example_bam.py``
  (``BaM(use_lowrank=True)``, B=2, niter=100, regf 100/(1+i)); ``BaM`` and
  ``FactorBaM(use_pallas=False)``.
- gsm_b128: ``dense_gaussian`` of numpy seed 0, D=256, ``FactorGSM`` at
  B=128 (the bench's batch sweep, ``bench.py:551-590``).
- banana, student_t: ``banana(256)`` and the port's ``student_t(0, 256,
  df=6)`` arrays, ``FactorGSM`` at B=32, niter=3000; the errors are
  against the analytic moments (banana: mean 0, cov diag(s^2,
  1 + 2 b^2 s^4, 1, ...); Student-t: loc and df/(df-2) sigma).
- gmm, logreg: the port's ``gaussian_mixture(0, 256)`` (K=3, separation
  3) and ``logistic_regression(0, 256)`` (N=200, ps=2) arrays, ``FactorGSM``
  at B=32, niter=3000 (keys 0..3 and 0..7).  gmm's errors are against the
  component nearest the fit, N(m_k*, I) (GSM's fixed point there), logreg's
  against the Laplace approximation (Newton MAP and inverse Hessian in
  float64), both as ``chip_smoke.py`` computes them
  (``nearest_component_errs``, ``laplace_moments``).
- large_d: ``dense_gaussian`` of numpy seed 4, D=512, the configuration of
  ``examples/example_large_d_torch.py`` (B=32, niter=4000): ``GSM`` on its
  dense route with ``chol_block=128`` (the blocked Cholesky; JAX's result
  does not depend on the mesh, so none is made).

It prints one JSON line per fit (errors as ``bench.py:207-211`` defines
them) and one per configuration with the worst of each.  This script runs
the JAX reference only; it imports nothing of the port (from
``chip_smoke.py`` only its numpy reference moments).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dense_arrays(seed: int, d: int):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return mean.astype(np.float32), cov.astype(np.float32)


def gmm_means(seed: int, d: int, k: int = 3, separation: float = 3.0):
    """The port's ``gaussian_mixture`` means (K, D), float32."""
    rng = np.random.default_rng(seed)
    return (separation * rng.standard_normal((k, d))).astype(np.float32)


def logreg_arrays(seed: int, d: int, n: int = 200):
    """The port's ``logistic_regression`` data X (N, D) and y (N,)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d)
    x = rng.standard_normal((n, d)) / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return x.astype(np.float32), y


def student_t_arrays(seed: int, d: int, df: float):
    """loc, sigma (float64), prec (float32): the port's ``student_t``."""
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal(d)
    l = rng.standard_normal((d, d)) / math.sqrt(d)
    sigma = l @ l.T + np.eye(d)
    return (loc.astype(np.float32), sigma,
            np.linalg.inv(sigma).astype(np.float32))


# name: (target, fitters, batch, niter, keys)
CONFIGS = {
    "gsm10": ("dense:3:10", ("GSM", "FactorGSM"), 2, 500, range(8)),
    "gsm16": ("dense:11:16", ("GSM", "FactorGSM"), 1, 500, range(8)),
    "bam5": ("dense:5:5", ("BaM", "FactorBaM"), 2, 100, range(8)),
    "gsm_b128": ("dense:0:256", ("FactorGSM",), 128, 3000, range(4)),
    "banana": ("banana:256", ("FactorGSM",), 32, 3000, range(4)),
    "student_t": ("student_t:0:256:6", ("FactorGSM",), 32, 3000, range(4)),
    "gmm": ("gmm:0:256", ("FactorGSM",), 32, 3000, range(4)),
    "logreg": ("logreg:0:256", ("FactorGSM",), 32, 3000, range(8)),
    "large_d": ("dense:4:512", ("GSM_chol128",), 32, 4000, range(4)),
}


def build_target(spec: str):
    """(lp, lp_g, D, errs) with ``errs(mean, cov) -> (mean_err, cov_err)``
    on numpy arrays."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import gammaln, logsumexp

    from chip_smoke import (laplace_moments, moment_errs,
                            nearest_component_errs)
    from gsmvi_tpu.models import banana
    from gsmvi_tpu.models.base import make_target
    from gsmvi_tpu.models.gaussian import _gaussian_target

    def analytic(mean, cov):
        return lambda m, c: moment_errs(m, c, mean, cov)

    kind, *args = spec.split(":")
    if kind == "dense":
        mean, cov = dense_arrays(int(args[0]), int(args[1]))
        t = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "dense")
        return t.lp, t.lp_g, mean.shape[0], analytic(mean, cov)
    if kind == "banana":
        d = int(args[0])
        t = banana(d)
        var = np.ones(d, np.float32)
        var[0] = 2.0 ** 2
        var[1] = 1.0 + 2.0 * 0.5 ** 2 * 2.0 ** 4
        return t.lp, t.lp_g, d, analytic(np.zeros(d, np.float32),
                                          np.diag(var))
    if kind == "gmm":
        means = gmm_means(int(args[0]), int(args[1]))
        k, d = means.shape
        means_j = jnp.asarray(means)

        def log_prob(x):
            diff = x[..., None, :] - means_j
            return (logsumexp(-0.5 * jnp.sum(diff * diff, axis=-1), axis=-1)
                    - 0.5 * d * math.log(2.0 * math.pi) - math.log(k))

        t = make_target(log_prob, d, name="gmm")
        return t.lp, t.lp_g, d, lambda m, c: nearest_component_errs(
            m, c, means.astype(np.float64))
    if kind == "logreg":
        x, y = logreg_arrays(int(args[0]), int(args[1]))
        ps = 2.0
        x_j, y_j = jnp.asarray(x), jnp.asarray(y)

        def log_prob(w):
            z = w @ x_j.T
            return (jnp.sum(y_j * z - jax.nn.softplus(z), axis=-1)
                    - 0.5 * jnp.sum((w / ps) ** 2, axis=-1))

        t = make_target(log_prob, x.shape[1], name="logreg")
        return t.lp, t.lp_g, x.shape[1], analytic(*laplace_moments(x, y, ps))
    seed, d, df = int(args[0]), int(args[1]), float(args[2])
    loc, sigma, prec = student_t_arrays(seed, d, df)
    logdet = float(np.linalg.slogdet(sigma)[1])
    const = (float(gammaln((df + d) / 2.0) - gammaln(df / 2.0))
             - 0.5 * d * math.log(df * math.pi) - 0.5 * logdet)
    loc_j, prec_j = jnp.asarray(loc), jnp.asarray(prec)

    def log_prob(x):
        diff = x - loc_j
        maha = jnp.sum((diff @ prec_j) * diff, axis=-1)
        return const - 0.5 * (df + d) * jnp.log1p(maha / df)

    t = make_target(log_prob, d, name="student_t")
    return t.lp, t.lp_g, d, analytic(
        loc, (df / (df - 2.0) * sigma).astype(np.float32))


def fit_once(fitter: str, lp, lp_g, d: int, key, batch: int, niter: int):
    import jax.numpy as jnp

    import gsmvi_tpu as g

    if fitter == "GSM_chol128":
        return g.GSM(D=d, lp=lp, lp_g=lp_g, dtype=jnp.float32,
                     chol_block=128).fit(key, batch_size=batch, niter=niter,
                                         verbose=False)
    if fitter in ("GSM", "FactorGSM"):
        cls = g.GSM if fitter == "GSM" else g.FactorGSM
        return cls(D=d, lp=lp, lp_g=lp_g, dtype=jnp.float32).fit(
            key, batch_size=batch, niter=niter, verbose=False)
    regf = g.Regularizers().custom(lambda i: 100 / (1 + i))
    if fitter == "BaM":
        fb = g.BaM(D=d, lp=lp, lp_g=lp_g, use_lowrank=True, dtype=jnp.float32)
    else:
        fb = g.FactorBaM(D=d, lp=lp, lp_g=lp_g, dtype=jnp.float32,
                         use_pallas=False)
    return fb.fit(key, regf=regf, batch_size=batch, niter=niter,
                  verbose=False)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", choices=sorted(CONFIGS))
    args = ap.parse_args()

    import jax

    for name in args.only or list(CONFIGS):
        spec, fitters, batch, niter, keys = CONFIGS[name]
        lp, lp_g, d, target_errs = build_target(spec)
        worst = [0.0, 0.0]
        for fitter in fitters:
            for k in keys:
                t0 = time.perf_counter()
                m, c = fit_once(fitter, lp, lp_g, d, jax.random.PRNGKey(k),
                                batch, niter)
                em, ec = target_errs(np.asarray(m, np.float64),
                                     np.asarray(c, np.float64))
                worst = [max(worst[0], em), max(worst[1], ec)]
                print(json.dumps({"config": name, "fitter": fitter, "key": k,
                                  "D": d, "B": batch, "niter": niter,
                                  "mean_err": em, "cov_err": ec,
                                  "seconds": time.perf_counter() - t0}),
                      flush=True)
        print(json.dumps({"config": name, "worst_mean_err": worst[0],
                          "worst_cov_err": worst[1]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
