"""How the zoo scores' one-launch kernels cut their work
(``zoo_student_t.cu``, ``zoo_logreg.cu``, the mixture's in
``zoo_score_b.cu`` and the funnel's in ``zoo_score.cu``), checked on the
CPU.

- numpy float32 emulations of each kernel's partition and sum orders
  (products as fused multiply-add chains, ``_fma32``):
  - Student-t: P = (x - loc) Prec on K3's split-k partition (rank r of
    ``thin_split(D)`` walks its k range ascending, the ranks' partials
    summed in rank order), maha's part of each 32-column tile by the warp's
    butterfly, the tiles summed in ascending tile order, then the scale;
  - logreg: resid's 32-column tiles split over the cluster's ranks as
    ``logreg_plan`` says, each z the group-ordered sum of the block's
    ``LOGREG_GROUPS`` fmaf chains over D (chain g over the 32-wide k slabs
    g mod 8), then resid X the same way over N with its slabs gathered
    from the ranks that hold them, less w/ps^2.
  - mixture: a row over the warps of ``thin_split(D)``, each warp's
    partial logits x . m_k and partial ||m_k||^2 a lane's fmaf chain over
    its columns l, l + 32, ... and then the butterfly, the warps summed in
    warp order, logmask added once, the softmax's sum a lane's chain over
    k = lane, lane + 32, ... and then the butterfly, and v = r M - x a fmaf
    chain over ascending k;
  - funnel: a row over the warps of ``thin_split(D)``, each warp's part of
    rest^2 a lane's fmaf chain over its columns and then the butterfly,
    the parts added in warp order, g0's products rounded on their own.
  Each emulation is held against the JAX package's kernel of the same name
  (``student_t_score_kernel``, ``logreg_score_kernel``,
  ``mixture_score_kernel``, ``funnel_score_kernel``: plain jnp functions,
  called on the CPU) and against the port's plain twins, at
  ``chip_smoke.py``'s ``ZOO_TOL`` (1e-4 x max(1, max|v|) for the
  Student-t, 1e-5 for the others; the mixture, like ``chip_smoke.py``'s,
  at the larger of that and 8x the plain float32 twin's own distance from
  float64, since its logits cancel terms ~1e3).  The Student-t's orders
  are new (K3's split of k, maha by tiles), so it is also held to
  float64 within 8x the plain float32 twin's own distance from float64
  (the rule the port holds new sum orders to).  logreg's chains, like the
  single chain per output of the 32x32 template it ran on before, sum a
  row of 256 unit terms with up to ~10x the rounding of torch's blocked
  sums, so it is held to ``ZOO_TOL`` alone.  Inputs are made with numpy
  from a seed at D {1, 10, 256} x M {1, 3, 32} (x N {1, 24, 200} for
  logreg), and on logreg rows with |z| > 100.  The mixture and funnel: D
  {1, 10, 256, 1024} x M {1, 3, 32, 512}, the mixture at K {1, 3, 8 padded
  with -1e30, 1024} and K=3 at separation 0.3 (also held to float64 within
  8x the plain twin's distance), the funnel also with rows whose x0 < -88
  (e^{-x0} = inf: those rows equal the references' infinities).
- ``logreg_plan``: every resid tile is held by exactly one rank and
  phase 2 finds it there, every output tile has one rank, and the shared
  route's blocks fit in a block's shared memory.
- The wrappers' launches on a stand-in library: one entry call a score
  call with the plan's splits, the scratch held from call to call
  (``_held_scratch``), bounded by bytes, never an output; the mixture and
  funnel hold none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas.fused_step import (funnel_score_kernel,
                                             logreg_score_kernel,
                                             mixture_score_kernel,
                                             student_t_score_kernel)
from gsmvi_tpu_torch.ops import fused_step as fs

DIMS = [1, 10, 256]
ROWS = [1, 3, 32]
DATA = [1, 24, 200]
DF = 6.0
ZOO_TOL = {"student_t": 1e-4, "logreg": 1e-5, "mixture": 1e-5,
           "funnel": 1e-5}                       # chip_smoke.py's
SPLIT_DIMS = [1, 10, 256, 1024]
SPLIT_ROWS = [1, 3, 32, 512]
MIXTURE_CASES = ["K=1", "K=3", "K=8 padded", "K=1024", "separation 0.3"]
FLOOR_FACTOR = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _chain(a, b, ks):
    """a[:, k] b[k, :] accumulated over ``ks`` in order, one fmaf each."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in ks:
        out = _fma32(a[:, k:k + 1], b[k:k + 1, :], out)
    return out


def _grouped(a, b, kext):
    """a b over k < kext as ``logreg_kernel`` sums it: group g's fmaf chain
    over the 32-wide k slabs g, g + G, ... ascending, the G chains added in
    group order."""
    g_n = fs.LOGREG_GROUPS
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for g in range(g_n):
        ks = [k for k0 in range(g * fs.SLAB, kext, g_n * fs.SLAB)
              for k in range(k0, min(kext, k0 + fs.SLAB))]
        out = (out + _chain(a, b, ks)).astype(np.float32)
    return out


def _butterfly(vals):
    """The warp's xor-butterfly sum over the last axis (32 lanes): lane 0's
    result, lane l adding lane l ^ o at o = 16, 8, 4, 2, 1 (lanes l and
    l ^ o then hold the same value, so the lower half carries on)."""
    for o in (16, 8, 4, 2, 1):
        vals = (vals[..., :o] + vals[..., o:2 * o]).astype(np.float32)
    return vals[..., 0]


def _tiles(z):
    """(M, D) -> (M, ceil(D/32), 32), zero-padded."""
    m, d = z.shape
    nt = -(-d // fs.SLAB)
    return np.pad(z, ((0, 0), (0, nt * fs.SLAB - d))).reshape(m, nt, fs.SLAB)


def _student_t_emulated(x, loc, prec, df, dd):
    """``student_t_kernel``'s orders in float32."""
    d = x.shape[1]
    s, k_per = fs.thin_split(d)
    diff = (x - loc).astype(np.float32)
    p = np.zeros_like(x)
    for r in range(s):                       # rank order
        p = (p + _chain(diff, prec, range(r * k_per, min(d, (r + 1) * k_per)))
             ).astype(np.float32)
    parts = _butterfly(_tiles((p * diff).astype(np.float32)))  # (M, tiles)
    maha = np.zeros(x.shape[0], np.float32)
    for t in range(parts.shape[1]):          # tile order
        maha = (maha + parts[:, t]).astype(np.float32)
    scale = (-(np.float32(df) + np.float32(dd))
             / (np.float32(df) + maha)).astype(np.float32)
    return (scale[:, None] * p).astype(np.float32)


def _logreg_emulated(w, xd, y, inv_ps2):
    """``logreg_kernel``'s partition and orders in float32: resid's tiles
    held by the ranks of ``logreg_plan``, the output tiles' k walk over N
    gathering each slab from its rank."""
    (m, d), n = w.shape, xd.shape[0]
    s, t, _ = fs.logreg_plan(n, d)
    ntn, ntd = -(-n // fs.SLAB), -(-d // fs.SLAB)
    xd_pad = np.pad(xd, ((0, ntn * fs.SLAB - n), (0, 0)))
    held = {}                                # rank -> (M, T * 32) resid
    for rank in range(s):
        block = np.zeros((m, t * fs.SLAB), np.float32)
        for tl in range(t):
            nt = rank * t + tl
            if nt >= ntn:
                break
            cols = np.arange(nt * fs.SLAB, (nt + 1) * fs.SLAB)
            z = _grouped(w, xd_pad[cols].T, d)
            yz = np.pad(y, (0, ntn * fs.SLAB - n))[cols]
            with np.errstate(over="ignore"):
                r = (yz - np.float32(1) / (np.float32(1) + np.exp(-z))
                     ).astype(np.float32)
            block[:, tl * fs.SLAB:(tl + 1) * fs.SLAB] = np.where(
                cols < n, r, np.float32(0))
        held[rank] = block
    resid = np.concatenate(
        [held[nt // t][:, (nt % t) * fs.SLAB:(nt % t + 1) * fs.SLAB]
         for nt in range(ntn)], axis=1)      # slab nt from rank nt // T
    inv = np.float32(inv_ps2)
    v = np.zeros((m, ntd * fs.SLAB), np.float32)
    wp = np.pad(w, ((0, 0), (0, ntd * fs.SLAB - d)))
    xp = np.pad(xd_pad, ((0, 0), (0, ntd * fs.SLAB - d)))
    for c in range(ntd):                     # output tile c, on rank c % S
        cols = slice(c * fs.SLAB, (c + 1) * fs.SLAB)
        acc = _grouped(resid, xp[:, cols], n)
        v[:, cols] = (acc - (wp[:, cols] * inv).astype(np.float32)
                      ).astype(np.float32)
    return v[:, :d]


def _rank_columns(d):
    """The columns of each warp of ``thin_split(d)``."""
    s, k_per = fs.thin_split(d)
    return [range(r * k_per, min(d, (r + 1) * k_per)) for r in range(s)]


def _lane_sum(vals):
    """A warp's sum over the last axis: lane l's chain over the entries l,
    l + 32, ... in order, then the butterfly."""
    n = vals.shape[-1]
    lanes = np.pad(vals, [(0, 0)] * (vals.ndim - 1)
                   + [(0, -(-n // 32) * 32 - n)])
    lanes = lanes.reshape(*vals.shape[:-1], -1, 32)
    acc = np.zeros(lanes.shape[:-2] + (32,), np.float32)
    for j in range(lanes.shape[-2]):
        acc = (acc + lanes[..., j, :]).astype(np.float32)
    return _butterfly(acc)


def _lanes(z, cols):
    """z's columns ``cols`` as (..., J, 32): lane l's columns l, l + 32,
    ... in order, zero-padded (a fmaf of zeros leaves a chain as it is)."""
    zs = z[..., cols.start:cols.stop]
    n = zs.shape[-1]
    zs = np.pad(zs, [(0, 0)] * (zs.ndim - 1) + [(0, -(-n // 32) * 32 - n)])
    return zs.reshape(*zs.shape[:-1], -1, 32)


def _mixture_emulated(x, means, logmask):
    """``mixture_score_kernel``'s orders in float32."""
    (m, d), k = x.shape, means.shape[0]
    logit_sum = np.zeros((m, k), np.float32)
    norm_sum = np.zeros(k, np.float32)
    for cols in _rank_columns(d):            # warp order
        xl, ml = _lanes(x, cols), _lanes(means, cols)   # (M | K, J, 32)
        part = np.zeros((m, k, 32), np.float32)
        norm = np.zeros((k, 32), np.float32)
        for j in range(xl.shape[1]):         # a lane's chain
            part = _fma32(xl[:, None, j], ml[None, :, j], part)
            norm = _fma32(ml[:, j], ml[:, j], norm)
        logit_sum = (logit_sum + _butterfly(part)).astype(np.float32)
        norm_sum = (norm_sum + _butterfly(norm)).astype(np.float32)
    half = (np.float32(0.5) * norm_sum).astype(np.float32)
    logit = ((logit_sum - half).astype(np.float32) + logmask
             ).astype(np.float32)
    mx = logit.max(axis=1, keepdims=True)
    e = np.exp((logit - mx).astype(np.float32)).astype(np.float32)
    r = (e / _lane_sum(e)[:, None]).astype(np.float32)
    acc = np.zeros((m, d), np.float32)
    for kk in range(k):                      # ascending k
        acc = _fma32(r[:, kk:kk + 1], means[kk:kk + 1, :], acc)
    return (acc - x).astype(np.float32)


def _funnel_emulated(x, sigma, dd):
    """``funnel_score_kernel``'s orders in float32."""
    f = np.float32
    x0 = x[:, 0]
    with np.errstate(over="ignore"):
        e = np.exp(-x0).astype(f)
    rest2 = np.zeros(x.shape[0], f)
    rest = x.copy()
    rest[:, 0] = 0.0                         # column 0 is skipped
    for cols in _rank_columns(x.shape[1]):   # warp order
        xs = _lanes(rest, cols)
        acc = np.zeros((x.shape[0], 32), f)
        for j in range(xs.shape[1]):         # a lane's chain
            acc = _fma32(xs[:, j], xs[:, j], acc)
        rest2 = (rest2 + _butterfly(acc)).astype(f)
    with np.errstate(over="ignore", invalid="ignore"):
        t1 = (-x0 / (f(sigma) * f(sigma))).astype(f)
        t2 = ((f(0.5) * e).astype(f) * rest2).astype(f)
        g0 = ((t1 + t2).astype(f) - f(0.5) * (f(dd) - f(1))).astype(f)
        v = (-x * e[:, None]).astype(f)
    v[:, 0] = g0
    return v


def _mixture_case(seed, m, d, case):
    """(x, means, logmask) of a mixture case: means separation N(0, I) (3,
    or 0.3), K of them (the padded case repeats the first mean with -1e30
    entries, as the JAX target does), x rows near a random component."""
    rng = np.random.default_rng(seed)
    k = {"K=1": 1, "K=1024": 1024, "K=8 padded": 3}.get(case, 3)
    sep = 0.3 if case == "separation 0.3" else 3.0
    means = (sep * rng.standard_normal((k, d))).astype(np.float32)
    x = (means[rng.integers(k, size=m)]
         + rng.standard_normal((m, d))).astype(np.float32)
    logmask = np.zeros((1, k), np.float32)
    if case == "K=8 padded":
        means = np.concatenate([means, np.repeat(means[:1], 5, axis=0)])
        logmask = np.concatenate(
            [logmask, np.full((1, 5), -1e30, np.float32)], axis=1)
    return x, means, logmask


def _student_t_case(seed, m, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    prec = np.linalg.inv(a @ a.T / d + np.eye(d))
    prec = (0.5 * (prec + prec.T)).astype(np.float32)
    loc = rng.standard_normal((1, d)).astype(np.float32)
    x = (loc + 2.0 * rng.standard_normal((m, d))).astype(np.float32)
    return x, loc, prec, np.array([[DF, d]], np.float32)


def _logreg_case(seed, m, d, n, saturate=None):
    rng = np.random.default_rng(seed)
    xd = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)[None]
    w = rng.standard_normal((m, d)).astype(np.float32)
    if saturate:                      # every other row's largest |z| = saturate
        w[::2] *= saturate / np.abs(w[::2] @ xd.T).max(axis=1, keepdims=True)
    return w, xd, y, np.array([[0.25]], np.float32)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _check(name, got, jax_v, plain32, exact=None):
    tol = ZOO_TOL[name] * max(1.0, float(np.abs(plain32).max()))
    assert bool(np.isfinite(got).all())
    assert _err(got, jax_v) <= tol
    assert _err(got, plain32) <= tol
    if exact is not None:
        tiny = 1e-7 * max(1.0, float(np.abs(exact).max()))
        assert _err(got, exact) <= FLOOR_FACTOR * max(_err(plain32, exact),
                                                      tiny)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", DIMS)
def test_student_t_partition_matches_jax_and_plain(d, m):
    x, loc, prec, dfd = _student_t_case(10 * d + m, m, d)
    got = _student_t_emulated(x, loc, prec, DF, d)
    jax_v = np.asarray(student_t_score_kernel(*map(jnp.asarray,
                                                   (x, loc, prec, dfd))))
    t = lambda *z: tuple(map(torch.from_numpy, z))
    plain32 = fs.student_t_score_reference(*t(x, loc, prec, dfd)).numpy()
    exact = fs.student_t_score_reference(
        *(z.double() for z in t(x, loc, prec, dfd))).numpy()
    _check("student_t", got, jax_v, plain32, exact)


@pytest.mark.parametrize("n", DATA)
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("saturate", [None, 400.0],
                         ids=["plain", "saturated"])
def test_logreg_partition_matches_jax_and_plain(d, m, n, saturate):
    w, xd, y, inv = _logreg_case(100 * d + 10 * m + n, m, d, n, saturate)
    if saturate:
        assert bool((np.abs(w[::2] @ xd.T) > 100).any())
    got = _logreg_emulated(w, xd, y[0], inv[0, 0])
    jax_v = np.asarray(logreg_score_kernel(*map(jnp.asarray,
                                                (w, xd, y, inv))))
    t = lambda *z: tuple(map(torch.from_numpy, z))
    plain32 = fs.logreg_score_reference(*t(w, xd, y, inv)).numpy()
    _check("logreg", got, jax_v, plain32)


@pytest.mark.parametrize("case", MIXTURE_CASES)
@pytest.mark.parametrize("m", SPLIT_ROWS)
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_mixture_partition_matches_jax_and_plain(d, m, case):
    x, means, logmask = _mixture_case(1000 * d + m + len(case), m, d, case)
    got = _mixture_emulated(x, means, logmask[0])
    jax_v = np.asarray(mixture_score_kernel(*map(jnp.asarray,
                                                 (x, means, logmask))))
    t = lambda *z: tuple(map(torch.from_numpy, z))
    plain32 = fs.mixture_score_reference(*t(x, means, logmask)).numpy()
    exact = fs.mixture_score_reference(
        *(z.double() for z in t(x, means, logmask))).numpy()
    floor = FLOOR_FACTOR * _err(plain32, exact)
    tol = max(ZOO_TOL["mixture"] * max(1.0, float(np.abs(plain32).max())),
              floor)
    assert bool(np.isfinite(got).all())
    assert _err(got, jax_v) <= tol
    assert _err(got, plain32) <= tol
    tiny = 1e-7 * max(1.0, float(np.abs(exact).max()))
    assert _err(got, exact) <= max(floor, FLOOR_FACTOR * tiny)


@pytest.mark.parametrize("overflow", [False, True], ids=["", "x0<-88"])
@pytest.mark.parametrize("m", SPLIT_ROWS)
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_funnel_partition_matches_jax_and_plain(d, m, overflow):
    """Rows with x0 in [-3, 3]; with ``overflow`` every third row's x0 is
    -90 (e^{-x0} = inf in float32): those rows are inf, -inf or NaN exactly
    where the references' are, the others within ``ZOO_TOL``."""
    rng = np.random.default_rng(10 * d + m)
    x = rng.standard_normal((m, d)).astype(np.float32)
    x[:, 0] = rng.uniform(-3.0, 3.0, m)
    if overflow:
        x[::3, 0] = -90.0
    sd = np.array([[3.0, d]], np.float32)
    got = _funnel_emulated(x, 3.0, d)
    with np.errstate(over="ignore", invalid="ignore"):
        jax_v = np.asarray(funnel_score_kernel(jnp.asarray(x),
                                               jnp.asarray(sd)))
    plain32 = fs.funnel_score_reference(torch.from_numpy(x),
                                        torch.from_numpy(sd)).numpy()
    wild = ~np.isfinite(plain32)
    assert wild.any() == overflow
    for ref in (jax_v, plain32):
        assert np.array_equal(~np.isfinite(ref), wild)
        assert np.array_equal(got[wild], ref[wild], equal_nan=True)
        ok = np.where(wild, 0.0, got), np.where(wild, 0.0, ref)
        tol = ZOO_TOL["funnel"] * max(1.0, float(np.abs(ok[1]).max()))
        assert _err(*ok) <= tol


# ---------------------------------------------------------------------------
# logreg_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 10, 33, 256, 8192])
@pytest.mark.parametrize("n", [1, 24, 31, 33, 200, 256, 257, 4096, 14848,
                               14849, 50000])
def test_logreg_plan_covers_every_tile_once(n, d):
    s, t, shared = fs.logreg_plan(n, d)
    ntn, ntd = -(-n // fs.SLAB), -(-d // fs.SLAB)
    assert 1 <= s <= fs.CLUSTER_MAX_BLOCKS and s == min(8, max(ntn, ntd))
    held = [r * t + tl for r in range(s) for tl in range(t)
            if r * t + tl < ntn]
    assert held == list(range(ntn))          # phase 1: each tile once
    assert all(nt // t < s for nt in range(ntn))   # phase 2 finds its rank
    outs = sorted(c for r in range(s) for c in range(r, ntd, s))
    assert outs == list(range(ntd))          # phase 2: each tile once
    assert shared == (fs.logreg_smem_bytes(t) <= fs.SMEM_LIMIT_BYTES)
    assert shared == (n <= 14848)


def test_logreg_plan_at_the_main_shapes():
    assert fs.logreg_plan(200, 256) == (8, 1, True)
    assert fs.logreg_plan(4096, 10) == (8, 16, True)
    assert fs.logreg_plan(16384, 10) == (8, 64, False)
    assert fs.logreg_plan(1, 1) == (1, 1, True)
    assert fs.logreg_smem_bytes(1) == 112640 + 2304
    assert fs.logreg_smem_bytes(58) <= fs.SMEM_LIMIT_BYTES
    assert fs.logreg_smem_bytes(59) > fs.SMEM_LIMIT_BYTES


# ---------------------------------------------------------------------------
# The wrappers' launches, on a stand-in library
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the CUDA kernel library: records each entry point's
    name and arguments."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def card(monkeypatch):
    """The scores' card path on CPU tensors, launching into a recorder."""
    rec = _Recorder()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_ZOO_SCRATCH", {})
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _student_operands(m, d):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    return z(m, d), z(1, d), z(d, d), z(1, 2)


def _logreg_operands(m, d, n):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    return z(m, d), z(n, d), z(1, n), z(1, 1)


@pytest.mark.parametrize("m,d", [(1, 1), (3, 10), (32, 256), (96, 257),
                                 (5, 8192)])
def test_student_t_is_one_launch_on_held_scratch(card, m, d):
    outs = [fs.student_t_score(*_student_operands(m, d)) for _ in range(3)]
    assert [name for name, _ in card.calls] == ["gsmvi_student_t_score"] * 3
    args = [a for _, a in card.calls]
    assert all(a[7:11] == (m, d, *fs.thin_split(d)) for a in args)
    partial, ticket = fs._ZOO_SCRATCH[("student_t", torch.device("cpu"), m,
                                       d)]
    assert partial.shape == (-(-d // fs.SLAB), m)
    assert ticket.dtype == torch.int32
    assert ticket.shape == (-(-m // fs.SLAB), fs.thin_split(d)[0])
    assert int(ticket.abs().sum()) == 0
    for a, v in zip(args, outs):
        assert (a[5].value, a[6].value) == (partial.data_ptr(),
                                            ticket.data_ptr())
        assert a[4].value == v.data_ptr() and v.shape == (m, d)
    assert fs.launch_counts()["student_t_score"] == 3
    fs.student_t_score(*_student_operands(m + 1, d))  # another M: its own
    assert len(fs._ZOO_SCRATCH) == 2


@pytest.mark.parametrize("m,d,n", [(1, 1, 1), (3, 10, 24), (32, 256, 200),
                                   (5, 10, 4096), (2, 10, 16384)])
def test_logreg_is_one_launch_on_its_route(card, m, d, n):
    v = fs.logreg_score(*_logreg_operands(m, d, n))
    ((name, args),) = card.calls
    split, t, shared = fs.logreg_plan(n, d)
    assert name == "gsmvi_logreg_score"
    assert args[6:11] == (m, d, n, split, t)
    assert args[5].value == v.data_ptr()
    if shared:
        assert args[4].value is None and not fs._ZOO_SCRATCH
    else:
        (resid,) = fs._ZOO_SCRATCH[("logreg", torch.device("cpu"), m, n)]
        assert resid.shape == (-(-m // fs.LOGREG_ROWS) * fs.LOGREG_ROWS,
                               -(-n // fs.SLAB) * fs.SLAB)
        assert args[4].value == resid.data_ptr()
    assert fs.launch_counts()["logreg_score"] == 1


def test_logreg_l2_route_when_shared_memory_is_short(card, monkeypatch):
    monkeypatch.setattr(fs, "LOGREG_SHARED_BYTES", 0)
    for _ in range(2):
        fs.logreg_score(*_logreg_operands(32, 256, 200))
    (resid,) = fs._ZOO_SCRATCH[("logreg", torch.device("cpu"), 32, 200)]
    assert [a[4].value for _, a in card.calls] == [resid.data_ptr()] * 2
    assert resid.shape == (32, 224)


def test_held_scratch_is_bounded_by_bytes(card, monkeypatch):
    """Scratch is held while it fits in ZOO_SCRATCH_MAX_BYTES together and
    is never evicted (a captured launch keeps its addresses); past the cap
    a call's scratch is its own, made anew each call."""
    one = 4 * (8 * 32) + 4 * 8          # Student-t at M=32, D=256
    monkeypatch.setattr(fs, "ZOO_SCRATCH_MAX_BYTES", 2 * one)
    for m in (32, 32, 31, 30, 30):
        fs.student_t_score(*_student_operands(m, 256))
    assert sorted(k[2] for k in fs._ZOO_SCRATCH) == [31, 32]
    ptrs = [a[5].value for _, a in card.calls]
    assert ptrs[0] == ptrs[1] and ptrs[2] not in ptrs[:2]
    # M=30 does not fit: each of its calls makes its own (zeroed) tickets.
    assert ("student_t", torch.device("cpu"), 30, 256) not in fs._ZOO_SCRATCH


@pytest.mark.parametrize("m,d,k", [(1, 1, 1), (3, 10, 3), (32, 256, 3),
                                   (256, 256, 8), (512, 1024, 1024),
                                   (5, 8192, 2)])
def test_mixture_and_funnel_are_one_launch_without_scratch(card, m, d, k):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    x = z(m, d)
    outs = [fs.mixture_score(x, z(k, d), z(1, k)),
            fs.funnel_score(x, z(1, 2)), fs.mixture_score(x, z(k, d),
                                                          z(1, k))]
    names = [name for name, _ in card.calls]
    assert names == ["gsmvi_mixture_score", "gsmvi_funnel_score",
                     "gsmvi_mixture_score"]
    (_, mix), (_, fun), _ = card.calls
    assert mix[4:9] == (m, d, k, *fs.thin_split(d))
    assert mix[3].value == outs[0].data_ptr()
    assert fun[3:7] == (m, d, *fs.thin_split(d))
    assert fun[2].value == outs[1].data_ptr()
    assert all(v.shape == (m, d) for v in outs)
    assert not fs._ZOO_SCRATCH
    counts = fs.launch_counts()
    assert (counts["mixture_score"], counts["funnel_score"]) == (2, 1)


def test_mixture_and_funnel_raise_outside_the_range(card):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    with pytest.raises(ValueError, match="K in"):
        fs.mixture_score(z(2, 10), z(1025, 10), z(1, 1025))
    with pytest.raises(ValueError, match="D in"):
        fs.mixture_score(z(2, 8193), z(3, 8193), z(1, 3))
    with pytest.raises(ValueError, match="D in"):
        fs.funnel_score(z(2, 8193), z(1, 2))
    with pytest.raises(ValueError, match="logmask"):
        fs.mixture_score(z(2, 10), z(3, 10), z(1, 4))
    with pytest.raises(ValueError, match="params"):
        fs.funnel_score(z(2, 10), z(1, 3))
    assert not card.calls
    assert fs.launch_counts()["mixture_score"] == 0


def test_wrappers_raise_outside_the_range(card):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    with pytest.raises(ValueError, match="D in"):
        fs.student_t_score(z(2, 8193), z(1, 8193), z(1, 1), z(1, 2))
    with pytest.raises(ValueError, match="loc"):
        x, _, prec, dfd = _student_operands(2, 10)
        fs.student_t_score(x, torch.zeros(1, 9), prec, dfd)
    with pytest.raises(ValueError, match="N >= 1"):
        fs.logreg_score(*_logreg_operands(2, 10, 0))
    assert not card.calls
