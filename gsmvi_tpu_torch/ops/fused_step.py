"""The eps-NS GSM step: plain torch versions and the Hopper kernel wrappers.

Counterpart of ``gsmvi_tpu/ops/pallas/fused_step.py``.  Three TPU kernels
carry the main path and are ported here:

- K1 ``gsm_eps_update_fused`` (``method="ns"``): the eps-coordinate update
  after the score — row work, the two-phase Newton-Schulz small space with
  its residual gates, one fat (D, 2B) @ (2B, D) factor apply, and the
  accept/revert select.  Plain version: ``gsm_eps_update_ns_reference``
  (twin of ``gsm_eps_update_ns_xla``) over ``eps_smallspace_ns_reference``
  (twin of ``_eps_smallspace_ns``).
- K2 ``make_fused_eps_multistep``: up to ``steps_per_call`` whole steps
  (sampling product, score, K1's math, select) per call.  Plain version:
  ``eps_multistep_reference``.
- K3 ``gaussian_score``: v = (mu_t - x) @ prec.  Plain version:
  ``gaussian_score_reference``.

K1 also takes a leading replica axis K (eps, vs (K, B, D), mean (K, D), f
(K, D, D)): the batched step of ``FactorGSM.fit_batch`` (the JAX package's
``gsm_eps_update_ns_xla`` under vmap).  On the card each of its launches
covers all K replicas; replica i's result equals, bit for bit, a call on
replica i alone.  K3 takes any row count, e.g. K replicas' B rows stacked.

Every wrapper runs its plain version on CPU tensors and launches its CUDA
kernels on CUDA tensors (``ops/cuda/csrc``), raising on a dtype, shape,
device or contiguity the kernels do not take; it never falls back.  Each
wrapper counts its calls on the card in a plain integer attribute
``launches`` (one per wrapper call, however many CUDA launches it makes).

On the card a K1 call is four launches on the current stream: ``vf = v F``
and ``t = vf F^T`` on the GEMM template, the one-block small-space kernel
(which writes ``good`` and the new mean), and the fat apply, whose epilogue
reads ``good`` and writes F or F' (the select).  A K2 call loops its
sub-steps on the host: the ``ef = e F^T`` / ``x = mu + ef`` GEMM, the score,
then K1's launches on a working copy of (mean, F), with the accepted count
accumulated on the device.  No launch waits for the host.
"""

from __future__ import annotations

import ctypes

import torch

# Newton-Schulz sweep counts (sqrt1, inv1, inv2, sqrt2, inv3) of the small
# space.  The short profile is the JAX package's validated frontier for
# B <= 32; at B >= 64 the Grams' spectra widen and the short chains go
# silently biased, so larger batches take the long profile
# (gsmvi_tpu/ops/pallas/fused_step.py:58-78).  CAUTION: the residual gates
# catch catastrophic loss, not slow bias — cutting iters[2] below 6 biases the
# converged covariance with zero rejections.
NS_ITERS_DEFAULT = (5, 4, 6, 7, 4)
NS_ITERS_LARGE_B = (8, 6, 9, 10, 6)
NS_TOL = 3e-3

# Shapes the CUDA kernels take: the small-space kernel holds ten (B, B)
# matrices in one block's shared memory (B <= 64); D is masked at the tile
# edges and needs no alignment.
KERNEL_BATCH_RANGE = (8, 64)
KERNEL_DIM_RANGE = (16, 1024)


def ns_iters_for_batch(b: int, override=None) -> tuple:
    """The NS profile for batch ``b``: ``override`` when given, else the
    short profile for B <= 32 and the long one above."""
    if override is not None:
        return tuple(override)
    return NS_ITERS_DEFAULT if b <= 32 else NS_ITERS_LARGE_B


def kernel_supports(b: int, d: int) -> bool:
    """True iff the CUDA kernels take batch ``b`` and dimension ``d``."""
    return (KERNEL_BATCH_RANGE[0] <= b <= KERNEL_BATCH_RANGE[1]
            and KERNEL_DIM_RANGE[0] <= d <= KERNEL_DIM_RANGE[1])


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _spd_norm_ub(a):
    """Row-sum (infinity) norm: a sharp upper bound on lambda_max of SPD a."""
    return torch.max(torch.sum(torch.abs(a), dim=-1)) + 1e-30


def ns_sqrt_both(a, iters: int):
    """Coupled Newton-Schulz (matmul only): (sqrt(a), a^{-1/2}) for small
    SPD ``a``, the Y and Z iterates on ``a`` over its row-sum norm."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    nrm = _spd_norm_ub(a)
    y = a / nrm
    z = eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    rt = torch.sqrt(nrm)
    return y * rt, z / rt


def _ns_sqrt(a, iters: int):
    """Newton-Schulz SPD square root (matmul only)."""
    return ns_sqrt_both(a, iters)[0]


def _newton_inv(a, iters: int):
    """Newton-Hotelling inverse of SPD a, seeded with I / lambda_max bound."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    x = eye * (1.0 / _spd_norm_ub(a))
    for _ in range(iters):
        x = x @ (2.0 * eye - a @ x)
    return x


def eps_smallspace_ns_reference(e, v, vf, mu, f, *, batch: int,
                                tol: float = NS_TOL, iters=None, ef_t=None):
    """Two-phase (PSD update, then PSD downdate) factorisation of
    M = I + (eps^T eps - C^T C)/B with matmul-only small solves.

    e, v, vf = v F, ef_t = e F^T (optional): (B, D); mu (1, D); f (D, D).
    Returns the proposals (mu_new (1, D), f_new (D, D), good): ``good`` is
    both phase residuals under ``tol`` (NS cannot converge on an indefinite
    downdate, so this is also the PD test).  Scalar functions of the Grams:
        cu = (I + S1)^{-1}, cui = (I + S1 + Gu)^{-1}, S1 = sqrt(I + Gu)
        cv = -(I + S2)^{-1},                          S2 = sqrt(I - Gv)
    and F' = F + stack_u^T stack_w in one (D, 2B) @ (2B, D) product.
    """
    b = batch
    iters = ns_iters_for_batch(b, iters)
    ef = e @ f.T if ef_t is None else ef_t
    a = -ef                                                # rows mu - x
    t = vf @ f.T
    vsv = torch.sum(v * t, dim=1, keepdim=True)
    mv = torch.sum(a * v, dim=1, keepdim=True)
    rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    eps0 = t - a
    w = torch.sum(v * eps0, dim=1, keepdim=True)
    den = 1.0 + rho + mv
    inv1r = 1.0 / (1.0 + rho)
    dmu_b = (eps0 - a * (w / den)) * inv1r
    dmu = torch.sum(dmu_b, dim=0, keepdim=True) / b
    gamma = 1.0 - (1.0 + w / den) * inv1r
    c = -e * gamma + vf * inv1r                            # downdate rows
    scale2 = 1.0 / b
    eye_b = torch.eye(b, dtype=e.dtype, device=e.device)

    # Phase 1: W1 = I + Zu cu Zu^T factors I + Zu Zu^T, Zu = eps^T/sqrt(B).
    gu = (e @ e.T) * scale2
    gu = 0.5 * (gu + gu.T)
    s1 = _ns_sqrt(eye_b + gu, iters[0])
    s1 = 0.5 * (s1 + s1.T)
    res1 = torch.sum((s1 @ s1 - (eye_b + gu)) ** 2) \
        / (torch.sum((eye_b + gu) ** 2) + 1e-30)
    cu = _newton_inv(eye_b + s1, iters[1])
    cui = _newton_inv(eye_b + s1 + gu, iters[2])

    # Xi~ = W1^{-1} Zc, carried transposed on rows.
    ec = (e @ c.T) * scale2
    zc = 1.0 / b ** 0.5
    cuiec = cui @ ec
    xim_t = (c - cuiec.T @ e) * zc

    # Phase 2: downdate by Xi~ Xi~^T.
    gv = xim_t @ xim_t.T
    gv = 0.5 * (gv + gv.T)
    i_gv = eye_b - gv
    s2 = _ns_sqrt(i_gv, iters[3])
    s2 = 0.5 * (s2 + s2.T)
    res2 = torch.sum((s2 @ s2 - i_gv) ** 2) / (torch.sum(i_gv ** 2) + 1e-30)
    cv = -_newton_inv(eye_b + s2, iters[4])
    good = (res1 < tol) & (res2 < tol)

    # F' = F + U1 W1row + (Fw1 Xi~)(cv Xi~^T), all from row objects.
    u1row = a * (-zc)
    w1row = (cu @ e) * zc
    ximf_t = (-gamma * ef + inv1r * t - cuiec.T @ ef) * zc
    fw1xi_t = ximf_t + (xim_t @ w1row.T) @ u1row
    w2row = cv @ xim_t
    stack_u = torch.cat([u1row, fw1xi_t], dim=0)           # (2B, D)
    stack_w = torch.cat([w1row, w2row], dim=0)             # (2B, D)
    return mu + dmu, f + stack_u.T @ stack_w, good


def gsm_eps_update_ns_reference(eps, vs, mean, f, iters=None, ef_t=None):
    """Update + select with the NS small space: (mean, f, good), the old
    values kept where ``good`` is false.  Twin of ``gsm_eps_update_ns_xla``."""
    b, d = eps.shape
    vf = vs @ f
    mu_new, f_new, good = eps_smallspace_ns_reference(
        eps, vs, vf, mean.reshape(1, d), f, batch=b, iters=iters, ef_t=ef_t)
    return (torch.where(good, mu_new[0], mean), torch.where(good, f_new, f),
            good)


def eps_multistep_reference(score_fn, params, nmax: int, eps_block, mean, f,
                            *, batch: int, iters=None):
    """The first ``nmax`` whole steps of an eps block: per sub-step
    ``ef = e F^T``, ``x = mu + ef``, ``v = score_fn(x, *params)``, the NS
    update and the select.  Returns (mean, f, n_accepted int32)."""
    d = f.shape[-1]
    acc = torch.zeros((), dtype=torch.int32, device=f.device)
    for j in range(int(nmax)):
        e = eps_block[j * batch:(j + 1) * batch]
        ef = e @ f.T
        v = score_fn(mean + ef, *params)
        mu_new, f_new, good = eps_smallspace_ns_reference(
            e, v, v @ f, mean.reshape(1, d), f, batch=batch, iters=iters,
            ef_t=ef)
        mean = torch.where(good, mu_new[0], mean)
        f = torch.where(good, f_new, f)
        acc = acc + good.to(torch.int32)
    return mean, f, acc


def gaussian_score_reference(x, mu_t, prec):
    """Dense-Gaussian score v = (mu_t - x) @ prec; mu_t (1, D)."""
    return (mu_t - x) @ prec


# ---------------------------------------------------------------------------
# CUDA launch helpers
# ---------------------------------------------------------------------------

def _library():
    from .cuda._build import load_library

    return load_library()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain path); False for CUDA tensors (kernel
    path); raises for anything else, or for a mix of devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"operands on {dev} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    return False


def _require(name: str, t, shape) -> None:
    """The kernels take contiguous float32 CUDA tensors of exact shapes."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} required, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def _require_dim_supported(d: int) -> None:
    if not KERNEL_DIM_RANGE[0] <= d <= KERNEL_DIM_RANGE[1]:
        raise ValueError(
            f"CUDA kernels take D in [{KERNEL_DIM_RANGE[0]}, "
            f"{KERNEL_DIM_RANGE[1]}], got D={d}")


def _require_shape_supported(b: int, d: int) -> None:
    if not kernel_supports(b, d):
        raise ValueError(
            f"CUDA kernels take B in [{KERNEL_BATCH_RANGE[0]}, "
            f"{KERNEL_BATCH_RANGE[1]}] and D in [{KERNEL_DIM_RANGE[0]}, "
            f"{KERNEL_DIM_RANGE[1]}], got B={b}, D={d}")


def _replicas(rows):
    """(K, replica stride in elements) of a (M, D) or (K, M, D) row tensor
    whose replicas may lie apart (a view into a larger block) but whose own
    rows are packed."""
    if rows.dim() == 2:
        return 1, rows.numel()
    m, d = rows.shape[1:]
    if rows.stride()[1:] != (d, 1) and m > 1:
        raise ValueError("rows: each replica's (M, D) rows must be packed")
    return rows.shape[0], rows.stride(0)


def _rows(lib, stream, rows, f, out, *, trans: bool, mu=None, x_out=None,
          halt=None) -> None:
    """out = rows @ F^T (``trans``) or rows @ F on the GEMM template; with
    ``x_out`` also x_out = mu + out; a no-op while ``*halt`` is non-zero.
    A leading replica axis K on rows (any replica stride), f, mu, out and
    x_out (packed) runs all K in one launch."""
    k, stride = _replicas(rows)
    m, d = rows.shape[-2:]
    lib.call("gsmvi_rows", _ptr(rows), _ptr(f), _ptr(mu), _ptr(out),
             _ptr(x_out), _ptr(halt), m, d, int(trans), k, stride, stream)


class _UpdateBuffers:
    """Scratch of one K1 update on the card (of K replicas: a leading axis
    K), allocated once per call."""

    def __init__(self, b: int, d: int, device, k=None):
        lead = () if k is None else (k,)
        empty = lambda *s: torch.empty((*lead, *s), dtype=torch.float32,
                                       device=device)
        self.vf, self.t = empty(b, d), empty(b, d)
        self.c, self.xim = empty(b, d), empty(b, d)
        self.su, self.sw = empty(2 * b, d), empty(2 * b, d)
        self.good = torch.zeros(lead or (1,), dtype=torch.int32,
                                device=device)


def _launch_update(lib, stream, eps, vs, ef, mean_in, mean_out, f_in, f_out,
                   buf: _UpdateBuffers, iters, nacc=None) -> None:
    """K1's launches: vf, t, small space (mean + good), fat apply (F).
    With a leading replica axis every launch covers the K replicas; eps may
    be a view whose replicas lie apart, the other operands are packed."""
    k, e_stride = _replicas(eps)
    b, d = eps.shape[-2:]
    _rows(lib, stream, vs, f_in, buf.vf, trans=False)
    _rows(lib, stream, buf.vf, f_in, buf.t, trans=True)
    lib.call("gsmvi_eps_smallspace", _ptr(eps), _ptr(vs), _ptr(buf.vf),
             _ptr(buf.t), _ptr(ef), _ptr(mean_in), _ptr(mean_out),
             _ptr(buf.good), _ptr(nacc), _ptr(buf.su), _ptr(buf.sw),
             _ptr(buf.c), _ptr(buf.xim), b, d, *iters, NS_TOL, k, e_stride,
             stream)
    lib.call("gsmvi_factor_apply", _ptr(buf.su), _ptr(buf.sw), _ptr(f_in),
             _ptr(f_out), _ptr(buf.good), 2 * b, d, k, stream)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def over_replicas(fn, *args):
    """``fn`` applied to each replica of the (K, ...) ``args`` in turn, its
    outputs stacked: the plain version of a kernel's replica axis."""
    outs = [fn(*replica_args) for replica_args in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


def gsm_eps_update_replicas_reference(eps, vs, mean, f, iters=None,
                                      ef_t=None):
    """``gsm_eps_update_ns_reference`` with an optional leading replica
    axis, one replica at a time: (mean (K, D), f (K, D, D), good (K,))."""
    one = lambda e, v, m, f_, ef: gsm_eps_update_ns_reference(
        e, v, m, f_, iters=iters, ef_t=ef)
    if eps.dim() == 2:
        return one(eps, vs, mean, f, ef_t)
    efs = [None] * eps.shape[0] if ef_t is None else ef_t
    return over_replicas(one, eps, vs, mean, f, efs)


def gsm_eps_update_fused(eps, vs, mean, f, iters=None, ef=None):
    """K1: eps-coordinate GSM update + residual gates + select.

    eps, vs (B, D); mean (D,); f (D, D); ``ef`` optional ``eps @ f.T`` (the
    sampling product the caller already formed).  Returns (mean, f, good)
    with the old values kept where ``good`` is false.  ``iters=None``
    resolves through ``ns_iters_for_batch(B)``.  With a leading replica
    axis K on every operand it updates K independent fits: (mean (K, D),
    f (K, D, D), good (K,)).
    """
    b, d = eps.shape[-2:]
    lead = tuple(eps.shape[:-2])
    iters = ns_iters_for_batch(b, iters)
    tensors = [eps, vs, mean, f] + ([ef] if ef is not None else [])
    if _on_cpu(*tensors):
        return gsm_eps_update_replicas_reference(eps, vs, mean, f,
                                                 iters=iters, ef_t=ef)
    _require_shape_supported(b, d)
    if len(lead) > 1:
        raise ValueError(f"eps: (B, D) or (K, B, D) required, got "
                         f"{tuple(eps.shape)}")
    for name, t, shape in (("eps", eps, (b, d)), ("vs", vs, (b, d)),
                           ("mean", mean, (d,)), ("f", f, (d, d))):
        _require(name, t, lead + shape)
    lib = _library()
    stream = _stream(eps.device)
    gsm_eps_update_fused.launches += 1
    if ef is None:
        ef = torch.empty_like(eps)
        _rows(lib, stream, eps, f, ef, trans=True)
    else:
        _require("ef", ef, lead + (b, d))
    buf = _UpdateBuffers(b, d, eps.device, *lead)
    mean_out = torch.empty_like(mean)
    f_out = torch.empty_like(f)
    _launch_update(lib, stream, eps, vs, ef, mean, mean_out, f, f_out, buf,
                   iters)
    good = buf.good != 0
    return mean_out, f_out, good if lead else good[0]


gsm_eps_update_fused.launches = 0


def make_fused_eps_multistep(score_fn, n_params: int, batch: int, d: int,
                             steps_per_call: int, iters=None):
    """K2: ``steps_per_call`` whole GSM steps per call.

    Returns ``step(nmax, eps_block, mean, f, *params) -> (mean, f, n_acc)``
    advancing the first ``nmax`` (<= spc) sub-steps of the ``(spc*B, D)``
    eps block; ``n_acc`` is an int32 tensor on the operands' device.
    ``score_fn(x, *params) -> (B, D)`` is the score, e.g. the port's
    ``gaussian_score`` (the counterpart of tracing it into the TPU kernel).
    """
    spc = int(steps_per_call)
    iters = ns_iters_for_batch(batch, iters)

    def step(nmax, eps_block, mean, f, *params):
        nmax = int(nmax)
        if not 0 <= nmax <= spc:
            raise ValueError(f"nmax={nmax} outside [0, {spc}]")
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        eps_block = eps_block.reshape(spc * batch, d)
        if _on_cpu(eps_block, mean, f):
            return eps_multistep_reference(score_fn, params, nmax, eps_block,
                                           mean, f, batch=batch, iters=iters)
        _require_shape_supported(batch, d)
        for name, t, shape in (("eps_block", eps_block, (spc * batch, d)),
                               ("mean", mean, (d,)), ("f", f, (d, d))):
            _require(name, t, shape)
        lib = _library()
        dev = eps_block.device
        stream = _stream(dev)
        mean_w, f_w = mean.clone(), f.clone()
        acc = torch.zeros(1, dtype=torch.int32, device=dev)
        ef = torch.empty((batch, d), dtype=torch.float32, device=dev)
        x = torch.empty_like(ef)
        buf = _UpdateBuffers(batch, d, dev)
        make_fused_eps_multistep.launches += 1 if nmax else 0
        for j in range(nmax):
            e = eps_block[j * batch:(j + 1) * batch]
            _rows(lib, stream, e, f_w, ef, trans=True, mu=mean_w, x_out=x)
            v = score_fn(x, *params)
            _require("score", v, (batch, d))
            _launch_update(lib, stream, e, v, ef, mean_w, mean_w, f_w, f_w,
                           buf, iters, nacc=acc)
        return mean_w, f_w, acc[0]

    return step


make_fused_eps_multistep.launches = 0


def gaussian_score(x, mu_t, prec):
    """K3: dense-Gaussian score v = (mu_t - x) @ prec; x (M, D), mu_t (1, D),
    prec (D, D) symmetric.  A GEMM: any row count M >= 1 (the K replicas'
    B rows of a batched step, stacked), D in ``KERNEL_DIM_RANGE``."""
    if _on_cpu(x, mu_t, prec):
        return gaussian_score_reference(x, mu_t, prec)
    b, d = x.shape
    _require_dim_supported(d)
    for name, t, shape in (("x", x, (b, d)), ("mu_t", mu_t, (1, d)),
                           ("prec", prec, (d, d))):
        _require(name, t, shape)
    v = torch.empty_like(x)
    gaussian_score.launches += 1
    _library().call("gsmvi_gaussian_score", _ptr(x), _ptr(mu_t), _ptr(prec),
                    _ptr(v), b, d, _stream(x.device))
    return v


gaussian_score.launches = 0

KERNEL_WRAPPERS = {
    "gsm_eps_update_fused": gsm_eps_update_fused,
    "make_fused_eps_multistep": make_fused_eps_multistep,
    "gaussian_score": gaussian_score,
}


def launch_counts() -> dict:
    """Calls on the card per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
