"""Exact eps-coordinate GSM update (plain torch, (2B)^2 Choleskys).

Counterpart of ``gsmvi_tpu/ops/gsm_eps.py:51-168``; the derivation is in
that module's docstring.  Samples come from the maintained factor,
x_b = mu + eps_b F^T, so the rank-2B covariance delta is known in factor
coordinates and the new factor is F' = F + (F Z) S2 Z^T with S2 from two
(2B x 2B) Choleskys; the second one succeeds iff the proposal is PD.

``jax.scipy.linalg.solve_triangular(lg, x, lower=True, trans=1)`` solves
Lg^T y = x.  In torch that is ``solve_triangular(lg.mT, x, upper=True)``;
the right solve x Lg^{-1} is ``solve_triangular(lg, x, upper=False,
left=False)``.
"""

from __future__ import annotations

import torch


def gsm_eps_rowwork(eps, vs, vf, f):
    """Row-space math of the eps step: (dmu (D,), zt (2B, D), fz_t (2B, D)),
    with zt = Z^T = [-eps; C]/sqrt(B) and fz_t = (F Z)^T = [A; Bm]/sqrt(B)."""
    b = eps.shape[0]
    a = -(eps @ f.T)                                    # rows mu - x
    t = vf @ f.T                                        # rows S v_b
    vsv = torch.sum(vs * t, dim=-1)
    mv = torch.sum(a * vs, dim=-1)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(vs * eps0, dim=-1)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)[:, None]) * inv1r[:, None]
    dmu = torch.mean(dmu_b, dim=0)
    bm = a + dmu_b                                      # rows mu_new - x
    gamma = 1.0 - (1.0 + w / den) * inv1r
    c = -eps * gamma[:, None] + vf * inv1r[:, None]     # rows F^{-1} b_b
    scale = 1.0 / (b ** 0.5)
    zt = torch.cat([-eps, c], dim=0) * scale
    fz_t = torch.cat([a, bm], dim=0) * scale
    return dmu, zt, fz_t


def _default_jitter(dtype) -> float:
    """G-jitter at the dtype's rounding floor."""
    return 1e-12 if torch.finfo(dtype).bits >= 64 else 1e-6


def _chol_pd(k):
    """(chol(k), pd flag).  ``info`` stays on the device; a NaN input can
    pass LAPACK's pivot test, so finiteness is required as well."""
    ck, info = torch.linalg.cholesky_ex(k)
    good = (info == 0) & torch.isfinite(ck).all()
    return ck, good


def eps_core(zt, n_plus: int, jitter=None):
    """Factor I + Z J Z^T from Z^T rows, J = diag(+1 x n_plus, -1 x rest).
    Returns (s2, good): W = I + Z S2 Z^T has W W^T = I + Z J Z^T."""
    dtype = zt.dtype
    if jitter is None:
        jitter = _default_jitter(dtype)
    k2 = zt.shape[0]
    g = zt @ zt.T
    g = 0.5 * (g + g.T)
    eye = torch.eye(k2, dtype=dtype, device=zt.device)
    g = g + (jitter * (torch.trace(g) / k2 + 1.0)) * eye
    lg = torch.linalg.cholesky_ex(g)[0]
    jj = torch.cat([torch.ones(n_plus, dtype=dtype, device=zt.device),
                    -torch.ones(k2 - n_plus, dtype=dtype, device=zt.device)])
    k = eye + lg.T @ (lg * jj[:, None])            # I + Lg^T J Lg
    k = 0.5 * (k + k.T)
    ck, good = _chol_pd(k)
    ck_safe = torch.where(good, ck, eye)
    # S2 = Lg^{-T} (Ck - I) Lg^{-1}
    y = torch.linalg.solve_triangular(lg.mT, ck_safe - eye, upper=True)
    s2 = torch.linalg.solve_triangular(lg, y, upper=False, left=False)
    return s2, good


def gsm_eps_factor_update(eps, vs, mean, f, jitter=None):
    """One eps-coordinate step: (mean_new, f_new, good) proposals plus the
    exact PD flag; the caller selects (or uses ``apply_eps_step``)."""
    b = eps.shape[0]
    d = f.shape[-1]
    vf = vs @ f
    dmu, zt, fz_t = gsm_eps_rowwork(eps, vs, vf, f)
    if 2 * b >= d:
        # G is singular here: factor the D x D middle matrix directly.
        dtype = f.dtype
        jj = torch.cat([torch.ones(b, dtype=dtype, device=f.device),
                        -torch.ones(b, dtype=dtype, device=f.device)])
        eye = torch.eye(d, dtype=dtype, device=f.device)
        m = eye + zt.T @ (zt * jj[:, None])
        w, good = _chol_pd(0.5 * (m + m.T))
        w = torch.where(good, w, eye)
        return mean + dmu, f @ w, good
    s2, good = eps_core(zt, b, jitter)
    return mean + dmu, f + fz_t.T @ (s2 @ zt), good


def apply_eps_step(state_mean, state_f, eps, vs, jitter=None):
    """Proposal + select: (mean, f, good), old values kept when the
    proposed covariance is not PD."""
    mean_new, f_new, good = gsm_eps_factor_update(eps, vs, state_mean,
                                                  state_f, jitter)
    return (torch.where(good, mean_new, state_mean),
            torch.where(good, f_new, state_f), good)
