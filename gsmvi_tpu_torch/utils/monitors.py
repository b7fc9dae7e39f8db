"""KL-divergence monitor with the reference's hook protocol.

Counterpart of ``gsmvi_tpu/utils/monitors.py:34-147``.  The port's fit
loop (``driver.run_fit_loop``) calls ``monitor(i, [mean, cov], lp, seed,
nevals=...)`` every ``monitor.checkpoint`` iterations and once after the
loop; the monitor appends one entry to each of ``rkl``, ``fkl`` and
``nevals`` per call, ``nevals`` being the cumulative count of score
evaluations offset by ``offset_evals`` (e.g. ``lbfgs_init``'s ``res.nfev``).

Where JAX hands over a PRNG key the port hands over an int seed
(``driver.monitor_seed``): the q-draws come from a generator on the fit's
device seeded with it, the forward-KL subset of ``ref_samples`` from a
CPU generator seeded with ``step_seed(seed, 1)``.  The estimator on given
draws is ``sample_and_logq`` (the port's tests hold it against JAX's on the
same draws).  A failure appends NaN to ``rkl`` and ``fkl`` exactly once,
as the JAX package fixes the reference's double append.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..distributions import mvn_logpdf, safe_cholesky
from ..driver import step_seed


def _total(values) -> float:
    """The sum of an ``lp`` result (a tensor, array or float) as a float."""
    if torch.is_tensor(values):
        return float(torch.sum(values.detach().to(torch.float64)))
    return float(np.sum(np.asarray(values, dtype=np.float64)))


def reverse_kl(samples, lpq, lpp) -> float:
    """Monte-Carlo E_q[log q - log p] from q-samples (reference signature)."""
    return (_total(lpq(samples)) - _total(lpp(samples))) / samples.shape[0]


def forward_kl(samples, lpq, lpp) -> float:
    """Monte-Carlo E_p[log p - log q] from p-samples (reference signature)."""
    return (_total(lpp(samples)) - _total(lpq(samples))) / samples.shape[0]


def sample_and_logq(mean: torch.Tensor, chol: torch.Tensor,
                    eps: torch.Tensor):
    """q-samples ``mean + eps chol^T`` from standard-normal draws ``eps``
    (n, D) and the sum of their log q (``KLMonitor._sample_and_logq`` of
    the JAX package on given draws)."""
    qsamples = mean + eps @ chol.T
    return qsamples, torch.sum(mvn_logpdf(qsamples, mean, chol))


@dataclass
class KLMonitor:
    """Track reverse (and, with ``ref_samples``, forward) KL during a fit.

      batch_size_kl — q-samples per estimate.
      checkpoint    — the fitter calls the monitor every ``checkpoint``
                      iterations (and once after the loop).
      offset_evals  — starting offset of the cumulative-evals axis.
      ref_samples   — optional target samples (array or tensor, (N, D)),
                      which turn on the forward-KL track.
      store_params  — keep each call's (mean, cov) as numpy arrays in
                      ``params_trace``.
    After a fit: ``rkl``, ``fkl`` (floats, NaN where unavailable) and
    ``nevals`` (cumulative score evaluations), one entry per call.
    """

    batch_size_kl: int = 8
    checkpoint: int = 20
    offset_evals: int = 0
    ref_samples: Optional[object] = None
    store_params: bool = False

    def __post_init__(self):
        self.rkl = []
        self.fkl = []
        self.nevals = []
        self.params_trace = []

    def reset(self, batch_size_kl=None, checkpoint=None, offset_evals=None,
              ref_samples=None):
        self.rkl = []
        self.fkl = []
        self.nevals = []
        self.params_trace = []
        if batch_size_kl is not None:
            self.batch_size_kl = batch_size_kl
        if checkpoint is not None:
            self.checkpoint = checkpoint
        if offset_evals is not None:
            self.offset_evals = offset_evals
        if ref_samples is not None:
            self.ref_samples = ref_samples

    def _estimate(self, mean, cov, lp, seed: int) -> None:
        """Append this checkpoint's rkl and fkl; raises on any failure."""
        mean = torch.as_tensor(mean)
        cov = torch.as_tensor(cov, dtype=mean.dtype, device=mean.device)
        chol = safe_cholesky(cov)
        if not bool(torch.isfinite(chol).all()):
            raise FloatingPointError("covariance is not positive definite")
        n = self.batch_size_kl
        gen = torch.Generator(device=mean.device).manual_seed(int(seed))
        eps = torch.randn((n, mean.shape[-1]), generator=gen,
                          dtype=mean.dtype, device=mean.device)
        qsamples, logq = sample_and_logq(mean, chol, eps)
        self.rkl.append((float(logq) - _total(lp(qsamples))) / n)
        if self.ref_samples is None:
            self.fkl.append(float("nan"))
            return
        n_ref = self.ref_samples.shape[0]
        pick = torch.Generator().manual_seed(step_seed(seed, 1))
        idx = torch.randperm(n_ref, generator=pick)[:min(n, n_ref)]
        psamples = torch.as_tensor(self.ref_samples, dtype=mean.dtype)[idx]
        psamples = psamples.to(mean.device)
        logq = _total(mvn_logpdf(psamples, mean, chol))
        self.fkl.append((_total(lp(psamples)) - logq) / psamples.shape[0])

    def __call__(self, i, params, lp, seed, nevals=1):
        """The hook: one (rkl, fkl, nevals) entry for iteration ``i``.
        Returns ``seed`` (the fitters ignore it, as they ignore the key
        JAX's monitor returns)."""
        mean, cov = params[0], params[1]
        n_rkl, n_fkl = len(self.rkl), len(self.fkl)
        try:
            self._estimate(mean, cov, lp, seed)
        except Exception as e:  # reference parity: swallow, append NaN
            print(f"Exception occured in monitor : {e}.\nAppending NaN")
            del self.rkl[n_rkl:], self.fkl[n_fkl:]
            self.rkl.append(float("nan"))
            self.fkl.append(float("nan"))
        if self.store_params:
            self.params_trace.append((_numpy(mean), _numpy(cov)))
        self.nevals.append(self.offset_evals + nevals)
        self.offset_evals = self.nevals[-1]
        return seed


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
