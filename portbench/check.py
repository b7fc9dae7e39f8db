"""The comparison that decides ``correct``: the program's answers against the
plain reference's, fit by fit.

A job's answer is its fits' final (mean, cov).  After the window a sample of
the window's fits, drawn from the run's seed, is fitted again by the
reference in float64 from the same seeds and target arrays, and two numbers
are compared, each the worst over the sample:

    mean_gap = max |mu - mu_ref| / max(1, max |mu_ref|)
    cov_gap  = max |S - S_ref|   / max(1, max |S_ref|)

On a Gaussian target a converged fit is the target whatever path it took,
so these two alone cannot see a wrong step that still converges (half of
the batch left out, a wrong step size).  The same fits are therefore also
read before they converge, at each step n of the cell's ``check_steps``:
the program's (mean, cov) after step n against one float64 reference step
from the state the program took it from ((0, I) at n = 1, the fits' own
start; else the program's (mean, factor) after step n - 1, since the draws
x = mu + eps F' follow the program's factor).  ``step_mean_gap`` and
``step_cov_gap`` are the same two measures, the worst over the sample and
the steps.
"""

from __future__ import annotations

import random

import torch

from . import manifest, seeds

NUMBERS = ("mean_gap", "cov_gap", "step_mean_gap", "step_cov_gap")


def sample(fits: list, k: int, seed: int) -> list:
    """``k`` of ``fits`` (or all, if fewer), drawn from ``seed``."""
    if len(fits) <= k:
        return list(fits)
    return random.Random(seeds.derive(seed, seeds.CHECK)).sample(fits, k)


def gaps(means, covs, ref_means, ref_covs, prefix: str = "") -> dict:
    """The two numbers over K fits ((K, D) and (K, D, D) each; the
    program's may be float32), inf where an answer is not finite."""
    out = {}
    for key, got, ref in ((prefix + "mean_gap", means, ref_means),
                          (prefix + "cov_gap", covs, ref_covs)):
        got = got.to(torch.float64).flatten(1)
        ref = ref.to(torch.float64).flatten(1)
        scale = torch.clamp(ref.abs().amax(1), min=1.0)
        gap = (got - ref).abs().amax(1) / scale
        gap = torch.where(torch.isfinite(got).all(1), gap,
                          torch.full_like(gap, float("inf")))
        out[key] = float(gap.max())
    return out


def reference(cell: dict, config: dict, arrays: dict, fit_seeds: list,
              starts: list, device, precision: str = "float64") -> tuple:
    """The plain reference's answers for the fits seeded with
    ``fit_seeds``: (means, covs, [(n, means, covs)]), the whole fits and,
    for each (n, start) of ``starts``, step n alone from ``start`` (None:
    from the fits' own start)."""
    job = cell["job"]
    fitter = manifest.reference(config["reference"])
    score_of = manifest.reference(config["target"]["recipe"]).score
    kw = dict(batch_size=int(job["batch_size"]), precision=precision,
              device=device, **config.get("fit_kwargs", {}))
    means, covs = fitter.fit(score_of, arrays, fit_seeds,
                             niter=int(job["niter"]), **kw)
    steps = []
    for n, start in starts:
        m, c = fitter.fit(score_of, arrays, fit_seeds, niter=0, start=start,
                          first_step=n - 1, **kw)
        steps.append((n, m.cpu(), c.cpu()))
    return means.cpu(), covs.cpu(), steps


def compare(got: tuple, ref: tuple) -> dict:
    """The numbers of ``got`` against ``ref``, each (means, covs, [(n,
    means, covs)]): the whole fits' gaps and the worst of the steps'."""
    readings = gaps(got[0], got[1], ref[0], ref[1])
    for (n, m, c), (n_ref, m_ref, c_ref) in zip(got[2], ref[2]):
        assert n == n_ref
        for k, v in gaps(m, c, m_ref, c_ref, prefix="step_").items():
            readings[k] = max(readings.get(k, v), v)
    return readings


def verdict(readings: dict, limits: dict) -> bool:
    """True iff every number is at or under its limit (a missing limit
    fails)."""
    return all(limits.get(k) is not None and readings[k] <= limits[k]
               for k in NUMBERS)
