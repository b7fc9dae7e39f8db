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

On the card (``ops/cuda/csrc/advi.cu``) a block is ``AdviBlocks``: its
buffers persist, the per-step learning rates and bias corrections
(``lr_bias_arrays``) go to a (3, spc) table on the device by one copy per
block, and a full block is one CUDA-graph replay.  A K9 sub-step is three
launches: ``x = loc + e L^T`` on the split-k thin product, the score (K3),
and one launch that forms the lower tiles of dL with Adam on (L, mL, vL) in
their epilogue and, in its other blocks, dloc with Adam on loc.  A K10
sub-step is nine at two sweeps: the residual ``R = I - L A`` with the gate
in its last block, the sweep into one of two ping-pong buffers (A itself
must survive an unconsumed step), the second residual and sweep, x, the
score, ``P = E A'`` (x and P each output one fmaf chain over ascending k,
the 32x32 template's bits, see ``advi.cu``), the gradient (the lower tiles of dL and dloc, with a
nonfinite flag) and the apply (the decision, Adam and A <- A').  The
(D, D, D) products and dL cover only the lower triangle: L and A are lower
triangular, and so are R and A + A R.  The finiteness of the WHOLE
gradient decides whether ANY Adam is applied (``advi_fused.py:322-331``),
so K10 cannot apply Adam in the gradient's epilogue as K9 does.  K10 writes
a float32 report (``REP_*``) and every launch of a block returns at once
after the block stopped; the fitter reads the report once per block.

Wrappers run their plain versions on CPU tensors, launch on CUDA tensors,
and raise on what the kernels do not take; they never fall back.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_step import (KERNEL_WRAPPERS, FusedBlocks, _library, _on_cpu,
                         _ptr, _require, _stream, _thin)

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
    called on each 0-d step tensor; a float ``lr_fn`` is a constant rate
    (the values ``lambda s: lr_fn`` gives, without a call per step).  The
    fused runners call it with the host steps of a block and copy the
    values to the kernels' table on the device."""
    steps = torch.as_tensor(steps, dtype=torch.int32)
    t = (steps + 1).to(torch.float32)
    bc1 = 1.0 / (1.0 - torch.pow(b1, t))
    bc2 = 1.0 / (1.0 - torch.pow(b2, t))
    if not callable(lr_fn):
        return (torch.full(steps.shape, float(lr_fn), dtype=torch.float32,
                           device=steps.device), bc1, bc2)
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
# Blocks on the card: persistent buffers, the scalar table, graph replays
# ---------------------------------------------------------------------------

K9_STATE = ("loc", "l", "mloc", "vloc", "ml", "vl")
K10_STATE = ("loc", "l", "ainv", "mloc", "vloc", "ml", "vl")


def _check_state(batch, d, vecs, mats) -> None:
    if not advi_kernel_supports(batch, d):
        raise ValueError(
            f"ADVI CUDA kernels take B in {list(ADVI_KERNEL_BATCH_RANGE)} "
            f"and D in {list(ADVI_KERNEL_DIM_RANGE)}, got B={batch}, D={d}")
    for i, t in enumerate(vecs):
        _require(f"vector operand {i}", t, (d,))
    for i, t in enumerate(mats):
        _require(f"matrix operand {i}", t, (d, d))


class _ScalarTable:
    """The (3, spc) float32 table of a block's learning rates and bias
    corrections on the card, which the kernels read, filled by one
    asynchronous copy per block from a ring of pinned host slots.  A slot is
    written again only after the copies of its half of the ring have run
    (one event per half, recorded once per SLOTS / 2 blocks), so the host
    never overwrites a slot a pending copy still reads."""

    SLOTS = 32

    def __init__(self, spc: int, device):
        cuda = torch.device(device).type == "cuda"
        self.table = torch.empty((3, spc), dtype=torch.float32, device=device)
        self.host = torch.empty((self.SLOTS, 3, spc), dtype=torch.float32,
                                pin_memory=cuda)
        # Off the card (the CPU tests' stand-in library) a copy is done when
        # it returns.
        self.events = [torch.cuda.Event(), torch.cuda.Event()] if cuda else []
        self.recorded = [False, False]
        self.slot = 0

    def fill(self, rows: torch.Tensor) -> None:
        i, half = self.slot, self.SLOTS // 2
        if self.events and i % half == 0 and self.recorded[i // half]:
            self.events[i // half].synchronize()
        self.host[i].copy_(rows)
        self.table.copy_(self.host[i], non_blocking=True)
        if self.events and i % half == half - 1:
            self.events[i // half].record()
            self.recorded[i // half] = True
        self.slot = (i + 1) % self.SLOTS


class _AdviBuffers:
    """A K9/K10 object's buffers on one device (the card), kept from block
    to block: the eps block, the working state that the sub-steps update in
    place, the scalar table, the sampling rows and, for K10, the products'
    outputs (zeros above the diagonal, never written there), the gate's
    row partials, the gradient, the report and the two tickets."""

    def __init__(self, eps, batch: int, d: int, spc: int, stl: bool):
        device = eps.device
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        self.eps = eps
        names = K10_STATE if stl else K9_STATE
        self.state = tuple(zeros(d, d) if n in ("l", "ainv", "ml", "vl")
                           else zeros(d) for n in names)
        self.table = _ScalarTable(spc, device)
        # x starts defined: K10's score runs on it even in a halted sub-step.
        self.ef, self.x = empty(batch, d), zeros(batch, d)
        if stl:
            self.r, self.x_a, self.y_a, self.gl = (zeros(d, d)
                                                   for _ in range(4))
            # The gate's row sums of |R| per 32-column tile (advi.cu).
            self.partial = empty(d * -(-d // 32))
            self.p, self.gloc = empty(batch, d), empty(d)
            self.rep = zeros(REP_SIZE)
            self.tickets = torch.zeros(2, dtype=torch.int32, device=device)


class AdviBlocks(FusedBlocks):
    """K9 (``stl=False``) and K10 (``stl=True``): ``spc`` whole ADVI
    iterations per block, on the card one CUDA-graph replay per full block.

    Two ways in.  The fit runner chains blocks through the working state:
    ``load(*state)`` copies a state in, each ``run(lrs, bc1s, bc2s, nmax,
    *params)`` advances ``nmax`` sub-steps on the draws the runner wrote
    into ``eps_block(device)``, ``report()`` is K10's report (``REP_*``) on
    the device and ``state()`` copies the state out, so a chunk copies the
    state twice, whatever its length.  Calling the object, ``step(lrs,
    bc1s, bc2s, nmax, eps_block, *state, *params, graph=True)``, does all
    four for one block and returns the state (K10: with int32 ``n_done``
    and ``stiff``; ``step.packed`` with the report instead).  ``lrs``,
    ``bc1s`` and ``bc2s`` hold spc values (``lr_bias_arrays`` of the
    sub-steps' absolute indices); a tensor returned never aliases the
    working state, so a later block never writes a tensor a caller holds.

    On the card the buffers (``_AdviBuffers``) persist from block to block.
    Each block copies its scalars into the device table (``_ScalarTable``);
    a full block (nmax == spc) then replays one ``torch.cuda.CUDAGraph`` of
    the spc sub-steps' launches, keyed on the score params' addresses and
    layouts, its first block of a key run eagerly and then captured; a
    block with nmax < spc, and any block with ``graph=False``, runs the same
    launches eagerly on the same buffers, so the two routes give the same
    numbers bit for bit.  The launch counters are recorded at capture and
    added per replay, as ``FusedBlocks`` does.  A score that cannot be
    captured raises, naming the score.  L and A must be lower triangular
    with exact zeros above the diagonal (every state the fitter makes is):
    the kernels neither read nor write that triangle.  CPU tensors run the
    plain versions."""

    def __init__(self, score_fn, n_params: int, batch: int, d: int,
                 steps_per_call: int, counter, *, stl: bool, b1: float,
                 b2: float, eps_adam: float, sweeps: int = STL_SWEEPS_DEFAULT,
                 res_gate: float = STL_RES_GATE_DEFAULT):
        super().__init__(score_fn, n_params, batch, d, steps_per_call, (),
                         None, counter, None)
        self.stl = stl
        self.names = K10_STATE if stl else K9_STATE
        self.b1, self.b2, self.eps_adam = b1, b2, eps_adam
        self.sweeps, self.res_gate = int(sweeps), res_gate
        self.gate_first = stl_gate_first(res_gate, sweeps)
        self._cpu = None        # the working state and report off the card
        self._loaded = None     # the device of the working state on the card

    def _buffers(self, device) -> _AdviBuffers:
        bufs = self._bufs.get(device)
        if bufs is None:
            bufs = _AdviBuffers(self.eps_block(device), self.batch, self.d,
                                self.spc, self.stl)
            self._bufs[device] = bufs
        return bufs

    def _check(self, state) -> bool:
        """True when ``state`` lies on the CPU; else checks it for the
        kernels."""
        if len(state) != len(self.names):
            raise ValueError(f"expected the {len(self.names)} state tensors "
                             f"{self.names}, got {len(state)}")
        if _on_cpu(*state):
            return True
        mats = [t for n, t in zip(self.names, state)
                if n in ("l", "ainv", "ml", "vl")]
        vecs = [t for n, t in zip(self.names, state)
                if n in ("loc", "mloc", "vloc")]
        _check_state(self.batch, self.d, vecs, mats)
        return False

    def load(self, *state) -> None:
        """Copy ``state`` into the working state (kept as it is on the
        CPU, where nothing is written in place)."""
        if self._check(state):
            self._cpu = [tuple(state), None]
            return
        self._cpu, self._loaded = None, state[0].device
        bufs = self._buffers(self._loaded)
        for w, t in zip(bufs.state, state):
            w.copy_(t)

    def _scalars(self, lrs, bc1s, bc2s) -> torch.Tensor:
        """The (3, spc) float32 host table of a block: learning rates and
        the two bias corrections per sub-step."""
        rows = []
        for x, what in ((lrs, "learning rates"), (bc1s, "bias corrections"),
                        (bc2s, "bias corrections")):
            if not (torch.is_tensor(x) and x.dtype == torch.float32
                    and x.device.type == "cpu"):
                x = torch.tensor(_host_floats(x, self.spc, what),
                                 dtype=torch.float32)
            if x.numel() != self.spc:
                raise ValueError(f"expected {self.spc} {what}, got "
                                 f"{x.numel()}")
            rows.append(x.reshape(-1))
        return torch.stack(rows)

    def _check_run(self, nmax, params) -> int:
        nmax = int(nmax)
        if not 0 <= nmax <= self.spc:
            raise ValueError(f"nmax={nmax} outside [0, {self.spc}]")
        if len(params) != self.n_params:
            raise ValueError(f"expected {self.n_params} score params, got "
                             f"{len(params)}")
        return nmax

    def run(self, lrs, bc1s, bc2s, nmax, *params, graph: bool = True):
        """Advance the working state by the first ``nmax`` sub-steps of
        the eps block on the working state's device."""
        nmax = self._check_run(nmax, params)
        rows = self._scalars(lrs, bc1s, bc2s)
        if self._cpu is not None:
            state = self._cpu[0]
            kw = dict(batch=self.batch, b1=self.b1, b2=self.b2,
                      eps_adam=self.eps_adam)
            ref = advi_multistep_reference
            if self.stl:
                kw.update(sweeps=self.sweeps, res_gate=self.res_gate)
                ref = advi_stl_multistep_reference
            out = ref(self.score_fn, params, *rows, nmax,
                      self.eps_block(state[0].device), *state, **kw)
            rep = None
            if self.stl:
                *out, n_done, stiff = out
                rep = torch.zeros(REP_SIZE, dtype=torch.float32)
                rep[REP_NDONE], rep[REP_STIFF] = float(n_done), float(stiff)
            self._cpu = [tuple(out), rep]
            return
        if self._loaded is None:
            raise RuntimeError("run before load")
        bufs = self._buffers(self._loaded)
        if nmax == 0:
            if self.stl:
                bufs.rep.zero_()
            return
        bufs.table.fill(rows)
        self._counter.launches += 1
        if graph and nmax == self.spc:
            self._replay(bufs, params)
        else:
            self._body(bufs, nmax, params)

    def state(self) -> tuple:
        """The working state, copied out (on the CPU: the state itself)."""
        if self._cpu is not None:
            return self._cpu[0]
        return tuple(t.clone() for t in self._buffers(self._loaded).state)

    def report(self) -> torch.Tensor:
        """K10's report of the last block (``REP_*``), on the working
        state's device: one read of it gives n_done and stiff."""
        if self._cpu is not None:
            return self._cpu[1]
        return self._buffers(self._loaded).rep

    def _body(self, bufs: _AdviBuffers, nmax: int, params) -> None:
        """The block's launches on the current stream: ``nmax`` sub-steps
        on the working state (K10: after the report's reset)."""
        lib = _library()
        stream = _stream(bufs.eps.device)
        b, d, spc = self.batch, self.d, self.spc
        adam = (self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2,
                self.eps_adam)
        sc = _ptr(bufs.table.table)
        if not self.stl:
            loc, l = bufs.state[:2]
            for j in range(nmax):
                e = bufs.eps[j * b:(j + 1) * b]
                _thin(lib, stream, e, l, bufs.ef, trans=True, mu=loc,
                      x_out=bufs.x)
                s = self.score_fn(bufs.x, *params)
                _require("score", s, (b, d))
                lib.call("gsmvi_advi_update", _ptr(s), _ptr(e), sc, j, spc,
                         *map(_ptr, bufs.state), b, d, *adam, float(b),
                         stream)
            return
        bufs.rep.zero_()
        loc, l, a, mloc, vloc, ml, vl = bufs.state
        rep, halt = _ptr(bufs.rep), bufs.rep[REP_STIFF:]
        tickets = (_ptr(bufs.tickets), _ptr(bufs.tickets[1:]))
        for j in range(nmax):
            # Sweeps: A -> X -> Y -> X ...; A survives an unconsumed step.
            lib.call("gsmvi_advi_residual", _ptr(l), _ptr(a), _ptr(bufs.r),
                     _ptr(bufs.partial), rep, tickets[0], d,
                     self.gate_first, stream)
            lib.call("gsmvi_advi_sweep", _ptr(a), _ptr(bufs.r),
                     _ptr(bufs.x_a), rep, d, stream)
            cur, nxt = bufs.x_a, bufs.y_a
            for _ in range(self.sweeps - 1):
                lib.call("gsmvi_advi_residual", _ptr(l), _ptr(cur),
                         _ptr(bufs.r), None, rep, None, d, self.gate_first,
                         stream)
                lib.call("gsmvi_advi_sweep", _ptr(cur), _ptr(bufs.r),
                         _ptr(nxt), rep, d, stream)
                cur, nxt = nxt, cur
            e = bufs.eps[j * b:(j + 1) * b]
            lib.call("gsmvi_advi_rows", _ptr(e), _ptr(l), _ptr(loc),
                     _ptr(bufs.ef), _ptr(bufs.x), _ptr(halt), b, d, 1, stream)
            s = self.score_fn(bufs.x, *params)
            _require("score", s, (b, d))
            lib.call("gsmvi_advi_rows", _ptr(e), _ptr(cur), None,
                     _ptr(bufs.p), None, _ptr(halt), b, d, 0, stream)
            lib.call("gsmvi_advi_stl_grad", _ptr(s), _ptr(bufs.p), _ptr(e),
                     _ptr(bufs.gl), _ptr(bufs.gloc), rep, b, d, stream)
            lib.call("gsmvi_advi_stl_apply", rep, tickets[1], _ptr(bufs.gl),
                     _ptr(bufs.gloc), _ptr(l), _ptr(ml), _ptr(vl), _ptr(loc),
                     _ptr(mloc), _ptr(vloc), _ptr(cur), _ptr(a), sc, j, spc,
                     d, *adam, stream)

    def packed(self, lrs, bc1s, bc2s, nmax, eps_block, *args,
               graph: bool = True):
        """One block from ``state``: (*state, report) for K10, the state for
        K9.  A caller's eps block is copied into the persistent one."""
        n = len(self.names)
        state, params = args[:n], args[n:]
        eps_block = eps_block.reshape(self.spc * self.batch, self.d)
        if not _on_cpu(eps_block, *state):
            _require("eps_block", eps_block, (self.spc * self.batch, self.d))
        self.load(*state)
        eps = self.eps_block(eps_block.device)
        if eps_block.data_ptr() != eps.data_ptr():
            eps.copy_(eps_block)
        self.run(lrs, bc1s, bc2s, nmax, *params, graph=graph)
        out = self.state()
        return (*out, self.report().clone()) if self.stl else out

    def __call__(self, *args, graph: bool = True):
        out = self.packed(*args, graph=graph)
        if not self.stl:
            return out
        *out, rep = out
        counts = rep[REP_NDONE:REP_STIFF + 1].to(torch.int32)
        return (*out, counts[0], counts[1])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def make_fused_advi_multistep(score_fn, n_params: int, batch: int, d: int,
                              steps_per_call: int, b1: float = 0.9,
                              b2: float = 0.999, eps_adam: float = 1e-8):
    """K9: up to ``steps_per_call`` whole ADVI iterations per block.

    Returns an ``AdviBlocks``, ``step(lrs, bc1s, bc2s, nmax, eps_block,
    loc, l, mloc, vloc, ml, vl, *params) -> (loc, l, mloc, vloc, ml, vl)``
    advancing the first ``nmax`` (<= spc) sub-steps of the ``(spc*B, D)``
    eps block; ``lrs``, ``bc1s``, ``bc2s`` hold spc values
    (``lr_bias_arrays`` of the sub-steps' absolute indices).
    ``score_fn(x, *params) -> (B, D)`` is the score, e.g.
    ``gaussian_score``; on the card it must be capturable into a CUDA
    graph.  On the card a sub-step is three launches: ``x = loc + e L^T``
    (``thin_product``), the score and ``gsmvi_advi_update``."""
    return AdviBlocks(score_fn, n_params, batch, d, steps_per_call,
                      make_fused_advi_multistep, stl=False, b1=b1, b2=b2,
                      eps_adam=eps_adam)


make_fused_advi_multistep.launches = 0


def make_fused_advi_stl_multistep(score_fn, n_params: int, batch: int,
                                  d: int, steps_per_call: int,
                                  b1: float = 0.9, b2: float = 0.999,
                                  eps_adam: float = 1e-8,
                                  sweeps: int = STL_SWEEPS_DEFAULT,
                                  res_gate: float = STL_RES_GATE_DEFAULT):
    """K10: up to ``steps_per_call`` whole STL-ADVI iterations per block.

    Returns an ``AdviBlocks``, ``step(lrs, bc1s, bc2s, nmax, eps_block,
    loc, l, ainv, mloc, vloc, ml, vl, *params) -> (loc, l, ainv, mloc,
    vloc, ml, vl, n_done, stiff)``; ``ainv`` must be an exact (or
    well-tracked) lower-triangular inverse of ``l``.  Sub-steps are
    consumed until the first one whose tracking residual trips the gate or
    whose gradient is nonfinite; the block then freezes with ``stiff = 1``
    and the caller replays that one step exactly and re-seeds ``ainv``.
    ``n_done``/``stiff`` are int32 tensors on the operands' device;
    ``step.packed(...)`` returns the seven state tensors and the float32
    report (``REP_*``) instead, for one read of both.  On the card a
    sub-step is 5 + 2 sweeps launches (9 at two sweeps)."""
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    return AdviBlocks(score_fn, n_params, batch, d, steps_per_call,
                      make_fused_advi_stl_multistep, stl=True, b1=b1, b2=b2,
                      eps_adam=eps_adam, sweeps=sweeps, res_gate=res_gate)


make_fused_advi_stl_multistep.launches = 0

# Registered beside K1-K3 and K7-K8, so ``fused_step.launch_counts()`` and
# ``reset_launch_counts()`` cover every kernel of the package.
KERNEL_WRAPPERS.update({
    "make_fused_advi_multistep": make_fused_advi_multistep,
    "make_fused_advi_stl_multistep": make_fused_advi_stl_multistep,
})
