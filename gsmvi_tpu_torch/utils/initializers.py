"""Variational-parameter initializers.

Counterpart of ``gsmvi_tpu/utils/initializers.py:21-71``.  ``lbfgs_init``
finds the MAP with scipy's L-BFGS-B on the host in float64, each function
or gradient evaluation a call of the target's ``lp``/``lp_g`` on the
device, and seeds the covariance with L-BFGS's inverse-Hessian estimate;
its ``res.nfev`` feeds ``KLMonitor.offset_evals``.  ``map_init`` runs Adam
ascent on ``lp`` on the device with the port's ``Adam`` (autograd for the
gradient) and returns an identity-scaled covariance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_dtype, resolve_device


def lbfgs_init(x0, lp, lp_g=None, maxiter=1000, maxfun=1000, device=None,
               dtype=None):
    """MAP-find with scipy L-BFGS-B; returns (mean, cov, result) as float64
    numpy arrays and scipy's ``OptimizeResult``.

    Minimizes ``-lp`` from ``x0``; ``lp`` and ``lp_g`` are called on a
    (D,) tensor of ``dtype`` (torch's default) on ``device`` (default: the
    CUDA card).  The covariance is the dense form of scipy's limited-memory
    inverse-Hessian approximation: a warm start, not a Laplace
    approximation."""
    from scipy.optimize import minimize

    device = resolve_device(device)
    dtype = default_dtype(dtype)
    x0 = np.asarray(x0, dtype=np.float64)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)

    def f(x):
        return -float(lp(as_t(x)))

    f_g = None
    if lp_g is not None:
        def f_g(x):
            g = lp_g(as_t(x)).detach().to(torch.float64).cpu().numpy()
            return -g.reshape(-1)

    res = minimize(f, x0, method="L-BFGS-B", jac=f_g,
                   options={"maxiter": maxiter, "maxfun": maxfun})
    return res.x, np.asarray(res.hess_inv.todense()), res


def map_init(seed, lp, d: int, x0=None, lr: float = 1e-2, niter: int = 500,
             cov_scale: float = 1.0, device=None, dtype=None):
    """On-device MAP initialization: ``niter`` Adam steps of ascent on
    ``lp``; returns (mean, cov_scale * I, niter), ``niter`` being the count
    of gradient evaluations for a monitor's offset.

    ``seed`` is accepted for parity with the JAX package's key and unused
    (the ascent draws nothing).  ``x0`` defaults to zeros; the tensors live
    on ``device`` (default: the CUDA card) in ``dtype`` (torch's
    default)."""
    from ..advi import Adam

    device = resolve_device(device)
    dtype = default_dtype(dtype)
    x = (torch.zeros(d, dtype=dtype, device=device) if x0 is None
         else torch.as_tensor(x0, dtype=dtype, device=device))
    opt = Adam(lr)
    state = opt.init((x,))
    for _ in range(niter):
        z = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(-torch.sum(lp(z)), (z,))
        (x,), state = opt.update((g,), state, (x,))
    cov = cov_scale * torch.eye(d, dtype=dtype, device=device)
    return x.detach(), cov, niter
