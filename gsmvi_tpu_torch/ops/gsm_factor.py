"""The factor-state GSM methods (counterpart of
``gsmvi_tpu/ops/gsm_factor.py``).

State: a square factor F with S = F F^T and its maintained inverse Finv.
The GSM covariance change S' = S + U U^T - V V^T (U = A^T/sqrt(B),
V = Bm^T/sqrt(B)) is a rank-2B correction of F, applied two ways:

- ``factor_gsm_step_stats`` (``method="qr"``): P = Finv [U, V], thin QR
  P = Q R, W = R J R^T; one (k, k) ``eigh`` of I + W (k = min(D, 2B))
  gives C = (I+W)^{1/2} - I and Ct = (I+W)^{-1/2} - I, and F' = F + (F Q)
  C Q^T, Finv' = Finv + Q Ct (Q^T Finv).  ``good`` is min eig(I + W) >
  1e-6, the exact PD test.  A column sign flip of Q (Q D, D = diag(+-1),
  the freedom of any QR) turns R into D R, W into D W D and C into D C D,
  so Q C Q^T and Q Ct Q^T, and the step, do not depend on it.
- ``factor_gsm_step_stats_v2`` (``method="twophase"``): a PSD update by U
  (``_update_corr``), then a PSD downdate by V (``_downdate_corr``, its
  ``good`` the PD test I - Gv > 0), each an exact (B, B) correction.

``factor_refresh`` tightens Finv against F by Newton steps.  Every product
is plain float32 torch (the JAX package runs these methods in XLA at
``default_matmul_precision("float32")``; it has no Pallas kernel for them),
and a step factors nothing D-sized.  The one exception is the small
``eigh`` on the card (``_small_eigh``).
"""

from __future__ import annotations

import torch

from ..distributions import safe_eigh


def _small_eigh(mat: torch.Tensor):
    """``safe_eigh`` of a small-space (k, k) matrix; a float32 one on a CUDA
    device is decomposed in float64 and the result rounded back.  torch's
    float32 ``eigh`` on the card returns eigenvectors orthogonal to only
    1.3e-5-1.4e-5 at k=64 (LAPACK's on the CPU: 0.7e-6-1.2e-6; measured on
    an NVIDIA H100), and both methods carry that error into F at every
    step: a 3000-step qr fit at D=256, B=32 ended at cov_err 1.5e-3 there,
    against 2.3e-4-2.7e-4 with this and 2.2e-4-3.5e-4 for the JAX package's
    CPU fits (twophase: 3.3e-4-4.3e-4, 2.1e-4-2.2e-4, 2.3e-4-2.5e-4)."""
    if mat.is_cuda and mat.dtype == torch.float32:
        w, q = safe_eigh(mat.double())
        return w.float(), q.float()
    return safe_eigh(mat)


def _mean_rows(samples, vs, mu0, f):
    """The GSM mean update of both methods (``gsmvi_tpu/ops/gsm_factor.py
    :72-82``), S applied as F F^T: (dmu (D,), a (B, D), bm (B, D))."""
    a = mu0 - samples
    t = (vs @ f) @ f.T
    vsv = torch.sum(vs * t, dim=-1)
    mv = torch.sum(a * vs, dim=-1)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(vs * eps0, dim=-1)
    dmu_b = (eps0 - a * (w / (1.0 + rho + mv))[:, None]) \
        / (1.0 + rho)[:, None]
    return torch.mean(dmu_b, dim=0), a, a + dmu_b


def factor_gsm_step_stats(samples, vs, mu0, f, finv):
    """One factor GSM update by thin QR (``gsmvi_tpu/ops/gsm_factor.py
    :63-118``).  samples, vs (B, D); mu0 (D,); f, finv (D, D).  Returns
    (dmu, f_new, finv_new, good); callers select old or new on ``good``."""
    b = samples.shape[0]
    dtype = f.dtype
    dmu, a, bm = _mean_rows(samples, vs, mu0, f)
    scale = 1.0 / torch.sqrt(torch.tensor(float(b), dtype=dtype))
    uv = torch.cat([a.T, bm.T], dim=1) * scale             # (D, 2B): [U, V]
    p = finv @ uv
    q, r = torch.linalg.qr(p)                              # (D, k), (k, 2B)
    k = q.shape[1]
    jj = torch.cat([torch.ones(b, dtype=dtype, device=f.device),
                    -torch.ones(b, dtype=dtype, device=f.device)])
    w = (r * jj) @ r.T                                     # R J R^T
    eye_k = torch.eye(k, dtype=dtype, device=f.device)
    mw, mq = _small_eigh(eye_k + 0.5 * (w + w.T))
    good = mw[0] > 1e-6
    sqrt_w = torch.sqrt(torch.clamp(mw, min=1e-12))
    c = (mq * sqrt_w) @ mq.T - eye_k                       # (I+W)^{1/2} - I
    ct = (mq / sqrt_w) @ mq.T - eye_k                      # (I+W)^{-1/2} - I
    f_new = f + (f @ q) @ (c @ q.T)
    finv_new = finv + q @ (ct @ (q.T @ finv))
    return dmu, f_new, finv_new, good


def factor_refresh(f, finv, newton_steps: int = 2):
    """Finv tightened against F by ``newton_steps`` Newton steps, Finv <-
    Finv (2I - F Finv) (``gsmvi_tpu/ops/gsm_factor.py:121-134``)."""
    eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
    for _ in range(int(newton_steps)):
        finv = finv @ (2.0 * eye - f @ finv)
    return finv


def factor_to_cov(F: torch.Tensor) -> torch.Tensor:
    """Dense covariance S = F F^T, exactly symmetric; F may carry a leading
    replica axis."""
    s = F @ F.mT
    return 0.5 * (s + s.mT)


def _update_corr(g: torch.Tensor, newton_iters: int):
    """C = (I + (I+G)^{1/2})^{-1} for PSD ``g``, and the root (I+G)^{1/2}.

    The G-stable form of the factor equation 2C + C G C = I of I + P P^T
    (``gsmvi_tpu/ops/gsm_factor.py:142-158``): I + G has eigenvalues >= 1,
    so its Newton-Schulz root converges, and no inverse root of the possibly
    singular G appears.  ``solve_ex`` gives inf/NaN where JAX's ``solve``
    does, instead of raising.
    """
    from .sqrtm import spd_sqrtm_newton

    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    root = spd_sqrtm_newton(eye + g, newton_iters)
    root = 0.5 * (root + root.T)
    return torch.linalg.solve_ex(root + eye, eye)[0], root


def _downdate_corr(g: torch.Tensor, newton_iters: int):
    """C = -(I + (I-G)^{1/2})^{-1} for the PSD downdate, and ``good``, the
    PD test I - G > 0 (``gsmvi_tpu/ops/gsm_factor.py:161-173``): an
    ``eigh`` with the eigenvalues clamped, since (I-G)^{1/2} can be
    arbitrarily ill-conditioned near the PD boundary.  ``newton_iters`` is
    unused, as in JAX."""
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    w, q = _small_eigh(eye - 0.5 * (g + g.T))
    good = w[0] > 1e-6
    root = (q * torch.sqrt(torch.clamp(w, min=1e-12))) @ q.T
    return -torch.linalg.solve_ex(root + eye, eye)[0], good


def factor_gsm_step_stats_v2(samples, vs, mu0, f, finv,
                             newton_iters: int = 12):
    """One two-phase factor GSM update (``gsmvi_tpu/ops/gsm_factor.py
    :176-226``): S1 = S + U U^T (always PD), then S' = S1 - V V^T (PD iff
    I - Gv > 0), each an exact (B, B) correction, no QR and no D-sized
    factorisation.  Returns (dmu, f_new, finv_new, good) like
    ``factor_gsm_step_stats``."""
    b = samples.shape[0]
    dtype = f.dtype
    dmu, a, bm = _mean_rows(samples, vs, mu0, f)
    scale = 1.0 / torch.sqrt(torch.tensor(float(b), dtype=dtype))
    u = a.T * scale                                        # (D, B)
    v = bm.T * scale
    eye_b = torch.eye(b, dtype=dtype, device=f.device)

    # Phase 1: S1 = S + U U^T.
    pu = finv @ u
    gu = pu.T @ pu
    cu, _ = _update_corr(gu, newton_iters)
    f1 = f + (f @ pu) @ (cu @ pu.T)
    # (I + Pu Cu Pu^T)^{-1} = I - Pu Cu (I + Gu Cu)^{-1} Pu^T
    cu_inv = cu @ torch.linalg.inv_ex(eye_b + gu @ cu)[0]
    f1inv = finv - pu @ (cu_inv @ (pu.T @ finv))

    # Phase 2: S' = S1 - V V^T.
    pv = f1inv @ v
    gv = pv.T @ pv
    cv, good = _downdate_corr(gv, newton_iters)
    f_new = f1 + (f1 @ pv) @ (cv @ pv.T)
    cv_inv = cv @ torch.linalg.inv_ex(eye_b + gv @ cv)[0]
    finv_new = f1inv - pv @ (cv_inv @ (pv.T @ f1inv))
    return dmu, f_new, finv_new, good
