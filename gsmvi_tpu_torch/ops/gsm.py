"""Dense GSM update in Gram-matrix form (plain torch).

Counterpart of ``gsmvi_tpu/ops/gsm.py:40-90``:

    a_b   = mu0 - x_b,  t_b = S0 v_b,  vSv_b = <v_b, t_b>,  mv_b = <a_b, v_b>
    rho_b = 0.5 (sqrt(1 + 4 (vSv_b + mv_b^2)) - 1)
    dmu_b = (t_b - a_b - a_b <v_b, t_b - a_b> / (1 + rho_b + mv_b)) / (1 + rho_b)
    mu    = mu0 + mean_b dmu_b,   S = S0 + sym((A^T A - Bm^T Bm) / B)

The dense route runs this off the card and with ``use_fused=False``; on
the card it runs K5, ``ops/gsm_step.py::gsm_update_fused``, whose plain
version this is.
"""

from __future__ import annotations

import torch


def gsm_row_deltas(samples: torch.Tensor, vs: torch.Tensor,
                   mu0: torch.Tensor, t: torch.Tensor):
    """(a, dmu_b): the rows a_b = mu0 - x_b and the per-sample mean deltas,
    from the rows t_b = S0 v_b."""
    a = mu0 - samples                                   # (B, D)
    vsv = torch.sum(vs * t, dim=-1)
    mv = torch.sum(a * vs, dim=-1)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(vs * eps0, dim=-1)
    den = 1.0 + rho + mv
    return a, (eps0 - a * (w / den)[:, None]) / (1.0 + rho)[:, None]


def gsm_update_stats(samples: torch.Tensor, vs: torch.Tensor,
                     mu0: torch.Tensor, S0: torch.Tensor):
    """Per-batch GSM deltas (dmu, dS): mu = mu0 + dmu, S = S0 + dS."""
    b = samples.shape[0]
    a, dmu_b = gsm_row_deltas(samples, vs, mu0, vs @ S0)  # t: rows S0 v_b
    bm = a + dmu_b                                      # rows mu_b - x_b
    dmu = torch.mean(dmu_b, dim=0)
    ds = (a.T @ a - bm.T @ bm) / b
    ds = 0.5 * (ds + ds.T)       # exact symmetry under any gemm schedule
    return dmu, ds


def gsm_update(samples: torch.Tensor, vs: torch.Tensor, mu0: torch.Tensor,
               S0: torch.Tensor):
    """Batched GSM update: returns the new (mu, S)."""
    if samples.ndim != 2 or vs.ndim != 2:
        raise ValueError("samples and vs must be (batch, dim) arrays")
    dmu, ds = gsm_update_stats(samples, vs, mu0, S0)
    return mu0 + dmu, S0 + ds
