"""The whole-step ADVI kernels: plain torch versions and the Hopper wrappers.

Counterpart of ``gsmvi_tpu/ops/pallas/advi_fused.py``.  One ADVI iteration
(reference ``gsmvi/advi.py:68-73``: an Adam step on the reparameterized
negative ELBO) with the gradient taken analytically:

    x_b  = loc + e_b L^T,        s_b = score(x_b)
    dloc = -sum_b s_b,           dL = tril(-S^T E - B diag(1/L_ii))

and optax.adam's update with precomputed bias corrections (``_adam_apply``).
The STL ("sticking the landing") variant replaces the entropy term by the
path derivative through the stopped density, which needs ``L^{-T} e_b``: it
tracks A ~= L^{-1} with Newton sweeps A <- A + A (I - L A), gates on the
first residual's row-sum norm (raised to 2^sweeps against ``res_gate``) and
on a nonfinite gradient, and uses P = E A:

    dloc = -1^T (S + P),         dL = tril(-(S + P)^T E).

A gated sub-step is not consumed: the block freezes there (``stiff``) and
the fitter replays that one step with the exact clamped solve.  Two TPU
kernels are ported here:

- K9 ``make_fused_advi_multistep``; plain version ``advi_multistep_reference``
  (the body at ``advi_fused.py:151-187``).
- K10 ``make_fused_advi_stl_multistep``; plain version
  ``advi_stl_multistep_reference`` (the body at ``advi_fused.py:295-351``).

On the card a K9 sub-step is four launches (``ops/cuda/csrc/advi.cu`` and
the GEMM template): ``x = loc + e L^T``, the score (K3), ``S^T E`` with an
epilogue that forms dL and applies Adam to (L, mL, vL) in place, and a
column kernel that sums dloc in a fixed order and applies Adam to loc.  A
K10 sub-step is twelve at two sweeps: the residual ``R = I - L A`` with
per-tile row sums of |R|, a one-block finalize (the gate), the sweeps into
two ping-pong buffers (A itself must survive an unconsumed step), x, the
score, ``P = E A'``, a column kernel (``G = S + P``, dloc, finiteness), the
``G^T E`` GEMM (dL, finiteness), a one-thread decide and the elementwise
Adam + select.  The finiteness of the WHOLE gradient decides whether ANY
Adam is applied (``advi_fused.py:322-331``), so K10 cannot apply Adam in a
GEMM epilogue as K9 does.  K10 writes a float32 report (``REP_*``) and
every launch of a block returns at once after the block stopped; the
fitter reads the report once per block.  Per-step learning rates and bias
corrections are host floats (``lr_bias_arrays``), passed by value, so no
launch waits for the host.

Wrappers run their plain versions on CPU tensors, launch on CUDA tensors,
and raise on what the kernels do not take; they never fall back.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_step import (KERNEL_WRAPPERS, _library, _on_cpu, _ptr, _require,
                         _rows, _stream)

# Post-sweep tracking-residual bound (row-sum norm of I - L A raised to
# 2^sweeps) above which an STL sub-step is not trusted (advi_fused.py:99-103).
STL_RES_GATE_DEFAULT = 0.05
# Newton sweeps per STL sub-step (advi_fused.py:105-110).
STL_SWEEPS_DEFAULT = 2

# K10 report layout (float32), shared with advi.cu.
REP_NDONE, REP_STIFF, REP_CONSUME, REP_BAD, REP_NONFINITE, REP_RNORM = range(6)
REP_SIZE = 6

# Shapes the kernels take.  Every launch is a GEMM of the template or a
# row, column or elementwise grid kernel, none with a shared-memory buffer
# sized by B or D, so the range is that of the dense kernel K5
# (``ops/gsm_step.py``): B up to 65536, D up to 8192.  K10's (D, D, D)
# sweeps grow as D^3 (17 M FMA each at D=256, 1.1 G at D=1024), which bounds
# its time, not its range.  The JAX package's VMEM gates
# (``advi_fused_supported``/``advi_stl_fused_supported``) are Mosaic budgets
# and do not carry over.
ADVI_KERNEL_BATCH_RANGE = (1, 65536)
ADVI_KERNEL_DIM_RANGE = (1, 8192)


def advi_kernel_supports(b: int, d: int) -> bool:
    """True iff the ADVI CUDA kernels take batch ``b`` and dimension
    ``d``."""
    return (ADVI_KERNEL_BATCH_RANGE[0] <= b <= ADVI_KERNEL_BATCH_RANGE[1]
            and ADVI_KERNEL_DIM_RANGE[0] <= d <= ADVI_KERNEL_DIM_RANGE[1])


def _adam_apply(p, m, v, g, lr, bc1, bc2, b1: float, b2: float, eps: float):
    """One optax.adam-exact parameter update (bias corrections precomputed);
    the CUDA kernels round each operation as this does."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    p = p - lr * (m * bc1) / (torch.sqrt(v * bc2) + eps)
    return p, m, v


def lr_bias_arrays(lr_fn, b1: float, b2: float, steps):
    """Per-step learning rates and Adam bias corrections ``1/(1-b1^t)``,
    ``1/(1-b2^t)`` (t = step + 1) for the absolute step indices ``steps``
    (a 1-d int tensor or sequence), float32 tensors computed in float32 as
    the JAX package computes them (``advi.py:86-94``).  ``lr_fn(step)`` is
    called on each 0-d step tensor.  The fused runners call it with the
    host steps of a block and pass the values to the kernels by value."""
    steps = torch.as_tensor(steps, dtype=torch.int32)
    t = (steps + 1).to(torch.float32)
    bc1 = 1.0 / (1.0 - torch.pow(b1, t))
    bc2 = 1.0 / (1.0 - torch.pow(b2, t))
    lrs = torch.stack([torch.as_tensor(lr_fn(s), dtype=torch.float32,
                                       device=steps.device) for s in steps])
    return lrs, bc1, bc2


def _host_floats(x, n: int, what: str) -> list:
    vals = [float(v) for v in (x.tolist() if torch.is_tensor(x)
                               else np.asarray(x, np.float64).reshape(-1))]
    if len(vals) != n:
        raise ValueError(f"expected {n} {what}, got {len(vals)}")
    return vals


# ---------------------------------------------------------------------------
# Plain torch versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def advi_multistep_reference(score_fn, params, lrs, bc1s, bc2s, nmax: int,
                             eps_block, loc, l, mloc, vloc, ml, vl, *,
                             batch: int, b1: float = 0.9, b2: float = 0.999,
                             eps_adam: float = 1e-8):
    """Twin of K9's body: the first ``nmax`` sub-steps of the eps block,
    each ``x = loc + e L^T``, ``s = score_fn(x, *params)``, the analytic
    gradient and Adam on (loc, L) and their moments.  ``lrs``/``bc1s``/
    ``bc2s`` are host floats per sub-step.  Returns (loc, l, mloc, vloc,
    ml, vl)."""
    d = l.shape[-1]
    tril = torch.ones((d, d), dtype=torch.bool, device=l.device).tril()
    bf = float(batch)
    for j in range(int(nmax)):
        e = eps_block[j * batch:(j + 1) * batch]
        x = loc + e @ l.T
        s = score_fn(x, *params)
        g_loc = -torch.sum(s, dim=0)
        ste = s.T @ e
        inv_diag = 1.0 / torch.diagonal(l)
        g_l = torch.where(tril, -ste - torch.diag(bf * inv_diag), 0.0)
        lr, bc1, bc2 = float(lrs[j]), float(bc1s[j]), float(bc2s[j])
        loc, mloc, vloc = _adam_apply(loc, mloc, vloc, g_loc, lr, bc1, bc2,
                                      b1, b2, eps_adam)
        l, ml, vl = _adam_apply(l, ml, vl, g_l, lr, bc1, bc2, b1, b2,
                                eps_adam)
    return loc, l, mloc, vloc, ml, vl


def stl_gate_first(res_gate: float, sweeps: int) -> float:
    """Bound on the FIRST residual's row-sum norm: ``res_gate`` after the
    sweeps' squaring law, ``res_gate ** (1 / 2^sweeps)``."""
    return float(res_gate) ** (1.0 / (2.0 ** sweeps))


def advi_stl_multistep_reference(score_fn, params, lrs, bc1s, bc2s,
                                 nmax: int, eps_block, loc, l, ainv, mloc,
                                 vloc, ml, vl, *, batch: int,
                                 b1: float = 0.9, b2: float = 0.999,
                                 eps_adam: float = 1e-8,
                                 sweeps: int = STL_SWEEPS_DEFAULT,
                                 res_gate: float = STL_RES_GATE_DEFAULT):
    """Twin of K10's body over the first ``nmax`` sub-steps: Newton refresh
    of the tracked inverse ``ainv``, the residual and nonfinite gates, the
    STL gradient through ``P = E A`` and Adam, consumed only while no gate
    has tripped (the tracked inverse reverts with the rest of an unconsumed
    sub-step).  Masked on the device as the TPU kernel is, so no host read.
    Returns (loc, l, ainv, mloc, vloc, ml, vl, n_done, stiff): int32
    counts, ``stiff`` 1 if the block stopped at a gated sub-step."""
    d = l.shape[-1]
    dev = l.device
    eye = torch.eye(d, dtype=l.dtype, device=dev)
    tril = torch.ones((d, d), dtype=torch.bool, device=dev).tril()
    gate_first = stl_gate_first(res_gate, sweeps)
    n_done = torch.zeros((), dtype=torch.int32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    a = ainv
    for j in range(int(nmax)):
        active = ~stopped
        r = eye - l @ a
        r_norm = torch.max(torch.sum(torch.abs(r), dim=1))
        a_n = a + a @ r
        for _ in range(sweeps - 1):
            r = eye - l @ a_n
            a_n = a_n + a_n @ r
        bad = ~torch.isfinite(r_norm) | (r_norm > gate_first)
        e = eps_block[j * batch:(j + 1) * batch]
        x = loc + e @ l.T
        s = score_fn(x, *params)
        p = e @ a_n                                  # rows (L^-T e_b)^T
        g_all = s + p
        g_loc = -torch.sum(g_all, dim=0)
        g_l = torch.where(tril, -(g_all.T @ e), 0.0)
        bad = bad | ~(torch.isfinite(g_loc).all() & torch.isfinite(g_l).all())
        stop_now = active & bad
        consume = active & ~stop_now
        lr, bc1, bc2 = float(lrs[j]), float(bc1s[j]), float(bc2s[j])
        loc_n, mloc_n, vloc_n = _adam_apply(loc, mloc, vloc, g_loc, lr, bc1,
                                            bc2, b1, b2, eps_adam)
        l_n, ml_n, vl_n = _adam_apply(l, ml, vl, g_l, lr, bc1, bc2, b1, b2,
                                      eps_adam)
        sel = lambda new, old: torch.where(consume, new, old)
        loc, l, a = sel(loc_n, loc), sel(l_n, l), sel(a_n, a)
        mloc, vloc = sel(mloc_n, mloc), sel(vloc_n, vloc)
        ml, vl = sel(ml_n, ml), sel(vl_n, vl)
        n_done = n_done + consume.to(torch.int32)
        stopped = stopped | stop_now
    return (loc, l, a, mloc, vloc, ml, vl, n_done,
            stopped.to(torch.int32))


# ---------------------------------------------------------------------------
# CUDA launch helpers
# ---------------------------------------------------------------------------

def _check_state(spc, batch, d, eps_block, vecs, mats) -> None:
    if not advi_kernel_supports(batch, d):
        raise ValueError(
            f"ADVI CUDA kernels take B in {list(ADVI_KERNEL_BATCH_RANGE)} "
            f"and D in {list(ADVI_KERNEL_DIM_RANGE)}, got B={batch}, D={d}")
    _require("eps_block", eps_block, (spc * batch, d))
    for i, t in enumerate(vecs):
        _require(f"vector operand {i}", t, (d,))
    for i, t in enumerate(mats):
        _require(f"matrix operand {i}", t, (d, d))


def _adam_args(lr, bc1, bc2, b1, b2, eps_adam) -> tuple:
    """(lr, bc1, bc2, b1, 1-b1, b2, 1-b2, eps) as the kernels take them:
    each rounds to float32 at the C boundary, as torch rounds a Python
    scalar against a float32 tensor."""
    return (lr, bc1, bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps_adam)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def make_fused_advi_multistep(score_fn, n_params: int, batch: int, d: int,
                              steps_per_call: int, b1: float = 0.9,
                              b2: float = 0.999, eps_adam: float = 1e-8):
    """K9: up to ``steps_per_call`` whole ADVI iterations per call.

    Returns ``step(lrs, bc1s, bc2s, nmax, eps_block, loc, l, mloc, vloc,
    ml, vl, *params) -> (loc, l, mloc, vloc, ml, vl)`` advancing the first
    ``nmax`` (<= spc) sub-steps of the ``(spc*B, D)`` eps block; ``lrs``,
    ``bc1s``, ``bc2s`` hold spc host floats (``lr_bias_arrays`` of the
    sub-steps' absolute indices).  ``score_fn(x, *params) -> (B, D)`` is
    the score, e.g. ``gaussian_score``."""
    spc = int(steps_per_call)

    def step(lrs, bc1s, bc2s, nmax, eps_block, loc, l, mloc, vloc, ml, vl,
             *params):
        nmax = int(nmax)
        if not 0 <= nmax <= spc:
            raise ValueError(f"nmax={nmax} outside [0, {spc}]")
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        lrs = _host_floats(lrs, spc, "learning rates")
        bc1s = _host_floats(bc1s, spc, "bias corrections")
        bc2s = _host_floats(bc2s, spc, "bias corrections")
        eps_block = eps_block.reshape(spc * batch, d)
        state = (loc, l, mloc, vloc, ml, vl)
        if _on_cpu(eps_block, *state):
            return advi_multistep_reference(
                score_fn, params, lrs, bc1s, bc2s, nmax, eps_block, *state,
                batch=batch, b1=b1, b2=b2, eps_adam=eps_adam)
        _check_state(spc, batch, d, eps_block, (loc, mloc, vloc),
                     (l, ml, vl))
        loc, l, mloc, vloc, ml, vl = (t.clone() for t in state)
        if nmax == 0:
            return loc, l, mloc, vloc, ml, vl
        dev = eps_block.device
        lib = _library()
        stream = _stream(dev)
        make_fused_advi_multistep.launches += 1
        ef = torch.empty((batch, d), dtype=torch.float32, device=dev)
        x = torch.empty_like(ef)
        for j in range(nmax):
            e = eps_block[j * batch:(j + 1) * batch]
            adam = _adam_args(lrs[j], bc1s[j], bc2s[j], b1, b2, eps_adam)
            _rows(lib, stream, e, l, ef, trans=True, mu=loc, x_out=x)
            s = score_fn(x, *params)
            _require("score", s, (batch, d))
            lib.call("gsmvi_advi_l_adam", _ptr(s), _ptr(e), _ptr(l),
                     _ptr(ml), _ptr(vl), batch, d, *adam, float(batch),
                     stream)
            lib.call("gsmvi_advi_loc_adam", _ptr(s), _ptr(loc), _ptr(mloc),
                     _ptr(vloc), batch, d, *adam, stream)
        return loc, l, mloc, vloc, ml, vl

    return step


make_fused_advi_multistep.launches = 0


class _StlBuffers:
    """Scratch of one K10 call on the card, allocated once per call."""

    def __init__(self, b: int, d: int, device):
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        self.r, self.x_a, self.y_a, self.gl = (empty(d, d) for _ in range(4))
        self.ntx = -(-d // 32)                    # gemm.cuh's column tiles
        self.partial = empty(d * self.ntx)
        # x starts defined: the score runs on it even in a halted sub-step.
        self.ef, self.x = empty(b, d), torch.zeros((b, d), device=device)
        self.p, self.g = empty(b, d), empty(b, d)
        self.gloc = empty(d)


def make_fused_advi_stl_multistep(score_fn, n_params: int, batch: int,
                                  d: int, steps_per_call: int,
                                  b1: float = 0.9, b2: float = 0.999,
                                  eps_adam: float = 1e-8,
                                  sweeps: int = STL_SWEEPS_DEFAULT,
                                  res_gate: float = STL_RES_GATE_DEFAULT):
    """K10: up to ``steps_per_call`` whole STL-ADVI iterations per call.

    Returns ``step(lrs, bc1s, bc2s, nmax, eps_block, loc, l, ainv, mloc,
    vloc, ml, vl, *params) -> (loc, l, ainv, mloc, vloc, ml, vl, n_done,
    stiff)``; ``ainv`` must be an exact (or well-tracked) lower-triangular
    inverse of ``l``.  Sub-steps are consumed until the first one whose
    tracking residual trips the gate or whose gradient is nonfinite; the
    block then freezes with ``stiff = 1`` and the caller replays that one
    step exactly and re-seeds ``ainv``.  ``n_done``/``stiff`` are int32
    tensors on the operands' device; ``step.packed(...)`` returns the seven
    state tensors and the float32 report (``REP_*``) instead, for one read
    of both."""
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    spc = int(steps_per_call)
    sweeps = int(sweeps)
    gate_first = stl_gate_first(res_gate, sweeps)

    def packed(lrs, bc1s, bc2s, nmax, eps_block, loc, l, ainv, mloc, vloc,
               ml, vl, *params):
        nmax = int(nmax)
        if not 0 <= nmax <= spc:
            raise ValueError(f"nmax={nmax} outside [0, {spc}]")
        if len(params) != n_params:
            raise ValueError(f"expected {n_params} score params, got "
                             f"{len(params)}")
        lrs = _host_floats(lrs, spc, "learning rates")
        bc1s = _host_floats(bc1s, spc, "bias corrections")
        bc2s = _host_floats(bc2s, spc, "bias corrections")
        eps_block = eps_block.reshape(spc * batch, d)
        state = (loc, l, ainv, mloc, vloc, ml, vl)
        if _on_cpu(eps_block, *state):
            *out, n_done, stiff = advi_stl_multistep_reference(
                score_fn, params, lrs, bc1s, bc2s, nmax, eps_block, *state,
                batch=batch, b1=b1, b2=b2, eps_adam=eps_adam, sweeps=sweeps,
                res_gate=res_gate)
            rep = torch.zeros(REP_SIZE, dtype=torch.float32)
            rep[REP_NDONE], rep[REP_STIFF] = float(n_done), float(stiff)
            return (*out, rep)
        _check_state(spc, batch, d, eps_block, (loc, mloc, vloc),
                     (l, ainv, ml, vl))
        loc, l, a, mloc, vloc, ml, vl = (t.clone() for t in state)
        dev = eps_block.device
        rep = torch.zeros(REP_SIZE, dtype=torch.float32, device=dev)
        if nmax == 0:
            return loc, l, a, mloc, vloc, ml, vl, rep
        lib = _library()
        stream = _stream(dev)
        make_fused_advi_stl_multistep.launches += 1
        buf = _StlBuffers(batch, d, dev)
        halt = rep[REP_STIFF:]
        h = _ptr(halt)
        for j in range(nmax):
            adam = _adam_args(lrs[j], bc1s[j], bc2s[j], b1, b2, eps_adam)
            # Sweeps: A -> X -> Y -> X ...; A survives an unconsumed step.
            lib.call("gsmvi_advi_residual", _ptr(l), _ptr(a), _ptr(buf.r),
                     _ptr(buf.partial), h, d, stream)
            lib.call("gsmvi_advi_residual_finalize", _ptr(buf.partial),
                     buf.ntx, _ptr(rep), d, gate_first, stream)
            lib.call("gsmvi_advi_sweep", _ptr(a), _ptr(buf.r),
                     _ptr(buf.x_a), h, d, stream)
            cur, nxt = buf.x_a, buf.y_a
            for _ in range(sweeps - 1):
                lib.call("gsmvi_advi_residual", _ptr(l), _ptr(cur),
                         _ptr(buf.r), None, h, d, stream)
                lib.call("gsmvi_advi_sweep", _ptr(cur), _ptr(buf.r),
                         _ptr(nxt), h, d, stream)
                cur, nxt = nxt, cur
            e = eps_block[j * batch:(j + 1) * batch]
            _rows(lib, stream, e, l, buf.ef, trans=True, mu=loc,
                  x_out=buf.x, halt=halt)
            s = score_fn(buf.x, *params)
            _require("score", s, (batch, d))
            _rows(lib, stream, e, cur, buf.p, trans=False, halt=halt)
            lib.call("gsmvi_advi_stl_cols", _ptr(s), _ptr(buf.p),
                     _ptr(buf.g), _ptr(buf.gloc), _ptr(rep), batch, d,
                     stream)
            lib.call("gsmvi_advi_grad_l", _ptr(buf.g), _ptr(e), _ptr(buf.gl),
                     _ptr(rep), batch, d, stream)
            lib.call("gsmvi_advi_stl_decide", _ptr(rep), stream)
            lib.call("gsmvi_advi_stl_apply", _ptr(rep), _ptr(buf.gl),
                     _ptr(buf.gloc), _ptr(l), _ptr(ml), _ptr(vl), _ptr(loc),
                     _ptr(mloc), _ptr(vloc), _ptr(cur), _ptr(a), d, *adam,
                     stream)
        return loc, l, a, mloc, vloc, ml, vl, rep

    def step(*args):
        *out, rep = packed(*args)
        counts = rep[REP_NDONE:REP_STIFF + 1].to(torch.int32)
        return (*out, counts[0], counts[1])

    step.packed = packed
    return step


make_fused_advi_stl_multistep.launches = 0

# Registered beside K1-K3 and K7-K8, so ``fused_step.launch_counts()`` and
# ``reset_launch_counts()`` cover every kernel of the package.
KERNEL_WRAPPERS.update({
    "make_fused_advi_multistep": make_fused_advi_multistep,
    "make_fused_advi_stl_multistep": make_fused_advi_stl_multistep,
})
