"""Adapter for distribution objects.

Counterpart of ``gsmvi_tpu/models/numpyro_compat.py``'s
``from_distribution``: wraps any object with ``log_prob((B, D)) -> (B,)``
(``torch.distributions`` objects qualify) into a Target.
``from_numpyro_model`` is not ported: it needs numpyro, which runs on JAX.
"""

from __future__ import annotations

import torch

from .base import Target, make_target


def from_distribution(dist, d: int, name: str = "numpyro_dist") -> Target:
    """Target of ``dist.log_prob``; ``dist.loc`` and
    ``dist.covariance_matrix``, where present, become the target's mean and
    cov, and ``dist.sample`` its sampler.  A torch distribution's ``sample``
    takes no generator, so the sampler draws under ``torch.random.fork_rng``
    seeded from the caller's generator: the same generator state gives the
    same draw, and the global generators are left as they were."""
    t = make_target(lambda x: dist.log_prob(x), d, name=name)
    if hasattr(dist, "sample"):
        def sample(generator, n):
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            with torch.random.fork_rng():
                torch.manual_seed(seed)
                return dist.sample((n,))

        t.sample = sample
    if hasattr(dist, "loc"):
        t.mean = torch.as_tensor(dist.loc)
    if hasattr(dist, "covariance_matrix"):
        t.cov = torch.as_tensor(dist.covariance_matrix)
    return t
