"""Posterior: the serving-side wrapper around a finished fit.

Counterpart of ``gsmvi_tpu/posterior.py:26-97``.  A fit returns a bare
``(mean, cov)``; ``Posterior`` holds the fitted Gaussian as (mean, chol)
tensors on one device with batched primitives:

    post = Posterior.from_fit(mean, cov)
    xs   = post.sample(seed, 4096)          # (4096, D), one product
    lps  = post.log_prob(xs)                # (4096,)
    m, s = post.marginal(idx)               # marginal mean/std of coordinates

``Posterior.from_state`` takes a ``VIState`` or a ``FactorVIState``.
``save``/``load`` write and read the npz of (mean, chol) that the JAX
package writes and reads, with its ``.npz`` suffix rule, so a file written
by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import resolve_device
from .distributions import (as_generator, mvn_entropy, mvn_kl, mvn_logpdf,
                            mvn_sample, safe_cholesky)


class Posterior:
    """Fitted Gaussian N(mean, chol chol^T) with sample/log_prob.

    ``mean`` (D,) and ``chol`` (D, D) are tensors or arrays; arrays land on
    ``device`` (default: the CUDA card), a tensor keeps its device unless
    ``device`` is given."""

    def __init__(self, mean, chol, device=None):
        if device is None and torch.is_tensor(mean):
            device = mean.device
        device = resolve_device(device)
        self.mean = torch.as_tensor(mean, device=device)
        self.chol = torch.as_tensor(chol, dtype=self.mean.dtype,
                                    device=device)

    @classmethod
    def from_fit(cls, mean, cov, device=None) -> "Posterior":
        if device is not None or not torch.is_tensor(mean):
            mean = torch.as_tensor(mean, device=resolve_device(device))
        cov = torch.as_tensor(cov, dtype=mean.dtype, device=mean.device)
        return cls(mean, safe_cholesky(cov))

    @classmethod
    def from_state(cls, state) -> "Posterior":
        """A ``VIState`` (has ``chol``) or a ``FactorVIState`` (has
        ``factor``; its covariance is factored anew, as JAX does)."""
        if hasattr(state, "chol"):
            return cls(state.mean, state.chol)
        return cls.from_fit(state.mean, state.cov)

    @property
    def d(self) -> int:
        return self.mean.shape[-1]

    @property
    def cov(self) -> torch.Tensor:
        return self.chol @ self.chol.T

    def sample(self, seed, n: int) -> torch.Tensor:
        """(n, D) draws; ``seed`` an int or a ``torch.Generator`` on the
        posterior's device."""
        return mvn_sample(as_generator(seed, self.mean.device), self.mean,
                          self.chol, n)

    def log_prob(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.mean.dtype, device=self.mean.device)
        return mvn_logpdf(x, self.mean, self.chol)

    def entropy(self) -> torch.Tensor:
        return mvn_entropy(self.chol)

    def kl_to(self, other: "Posterior") -> torch.Tensor:
        """KL(self || other)."""
        return mvn_kl(self.mean, self.chol, other.mean, other.chol)

    def marginal(self, idx=None):
        """(mean, std) of the requested coordinates (all by default)."""
        std = torch.sqrt(torch.sum(self.chol * self.chol, dim=1))
        if idx is None:
            return self.mean, std
        idx = torch.as_tensor(idx, device=self.mean.device)
        return self.mean[idx], std[idx]

    # -- serialization (two arrays, no pickle) --------------------------------
    def save(self, path: str) -> None:
        """Write (mean, chol) as an npz; ``.npz`` is appended if missing
        (``np.savez`` appends it on save, so ``load`` must see that name)."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 mean=self.mean.detach().cpu().numpy(),
                 chol=self.chol.detach().cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "Posterior":
        """Read a file written by ``save`` (of either package) onto
        ``device`` (default: the CUDA card)."""
        if not path.endswith(".npz"):
            # save() always writes ``path + '.npz'``: prefer it over an
            # unrelated extensionless file of the same name.
            cand = path + ".npz"
            if os.path.exists(cand) or not os.path.exists(path):
                path = cand
        with np.load(path) as z:
            return cls(z["mean"], z["chol"], device=device)
