"""How K4a's one-launch exact small space (``eps_chol.cu(h)``) and the
banana score (``zoo_score.cu``) cut and order their work, checked on the
CPU.

- A numpy float32 emulation of ``eps_chol_kernel``'s sum orders (fused
  multiply-adds as ``_fma32``): the row scalars' partial dots (a lane's
  fmaf chain over the rank's columns, the warp's butterfly, the ranks of
  ``thin_split(D)`` added in rank order), Z^T's Gram as a chain over each
  rank's columns with the ranks added in rank order, the trace by warp 0's
  lane chains and butterfly, the two Cholesky sweeps blocked in panels of
  16 columns, the three small-space products and S2 Z^T as single
  ascending chains (K's terms times J_m first), the inverse's dots as the
  chain over the rows below each 16-row block and then the block's own
  rows from the bottom up, times the reciprocal of the diagonal entry,
  the mean's chain over the rows, the fat apply's chain over the 2B rows.
  The pivots' reciprocal roots and the diagonal's reciprocals are taken
  correctly rounded here; the kernel refines the hardware's approximations
  by a Newton step each, within an ulp of them.  At ``tools/chol_floor.py``'s shapes (8, 200), (32, 256) and
  (64, 256), one step from (0, I) on ``dense_gaussian(0, D)`` with a
  standard-normal draw, where Z^T Z's condition is 1e8-1e12 before its
  jitter (asserted above 1e6 here), the emulation is held to
  ``chip_smoke.py``'s ``_chol_close`` rule against the port's plain float32
  version and against the JAX package's ``gsm_eps_update_fused(
  method="chol", interpret=True)``: the mean within max(1e-4, 4 x the plain
  float32 version's distance from float64), S = F F^T within max(2e-4
  max(1, max|S|), 4 x that distance on S); and its own distance from the
  float64 plain version within the same bounds.
- The blocked sweep gives every entry the fused multiply-adds of the
  right-looking sweep column by column in the same order: equal bit for
  bit, on SPD, indefinite and NaN matrices (the NaN-propagating minimum
  pivot included), at 2B in {2, 16, 30, 64, 66, 128}.
- ``banana_plan``: every element of (M, D) is written by exactly one thread
  at D in {2, 3, 4, 5, 7, 8, 1023, 1024, 1025, 8192}, M = 1 and M·D past
  the 4096 blocks of 256 threads that the grid-strided kernel before capped
  its launch at; the emulated values equal the plain version bit for bit
  (each operation rounded on its own, in its order) and the JAX kernel
  within ``ZOO_TOL`` (1e-5 x max(1, max|v|)).
- The wrappers' launches on a stand-in library: K4a is the three thin
  products (ef, vf, t) or, as a K4 step, ef and the score first, then one
  ``gsmvi_eps_chol`` on ``thin_split(D)`` and the fat apply; no
  ``gsmvi_rows``; banana is one launch with ``banana_plan``'s shift.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import fused_step as fs

NB = 16                                   # CH_NB: panel and block height
CHOL_MEAN_TOL, CHOL_COV_TOL, CHOL_FLOOR = 1e-4, 2e-4, 4.0   # chip_smoke.py's
ZOO_TOL = 1e-5                                               # chip_smoke.py's
FLOOR_SHAPES = [(8, 200), (32, 256), (64, 256)]
f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (np.asarray(a, np.float64) * b + c).astype(f32)


def _butterfly(vals):
    """The warp's xor-butterfly sum over the last axis (32 lanes)."""
    for o in (16, 8, 4, 2, 1):
        vals = (vals[..., :o] + vals[..., o:2 * o]).astype(f32)
    return vals[..., 0]


def _rank_columns(d):
    s, k_per = fs.thin_split(d)
    return [range(r * k_per, min(d, (r + 1) * k_per)) for r in range(s)]


def _nan_min(a, b):
    return a if (a < b or a != a) else b


def _nan_max(a, b):
    return a if (a > b or a != a) else b


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _cholt_columns(w):
    """The right-looking sweep column by column with one fmaf an update
    (the sweep before the blocked one): (L^T, minimum pivot)."""
    w = w.astype(f32).copy()
    k = w.shape[0]
    cols = np.arange(k)
    lt = np.zeros_like(w)
    minpiv = f32(np.inf)
    for j in range(k):
        piv = w[j, j]
        minpiv = _nan_min(minpiv, piv)
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            inv = f32(1.0) / np.sqrt(f32(_nan_max(piv, f32(1e-30))))
            lt[j] = np.where(cols >= j, (w[j] * inv).astype(f32), f32(0))
        with np.errstate(invalid="ignore", over="ignore"):
            w = _fma32(-lt[j][:, None], lt[j][None, :], w)
    return lt, minpiv


def _cholt_blocked(w):
    """``chol_blocked``: a 16-row panel factored in registers (the panel's
    later rows updated as each of its columns is factored), then the
    panel's update of the trailing block, each entry's 16 terms in order."""
    w = w.astype(f32).copy()
    k = w.shape[0]
    cols = np.arange(k)
    lt = np.zeros_like(w)
    minpiv = f32(np.inf)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j0 in range(0, k, NB):
            s = w[j0:j0 + NB].copy()
            for jj in range(min(NB, k - j0)):
                j = j0 + jj
                piv = s[jj, j]
                minpiv = _nan_min(minpiv, piv)
                inv = f32(1.0) / np.sqrt(f32(_nan_max(piv, f32(1e-30))))
                lt[j] = np.where(cols >= j, (s[jj] * inv).astype(f32), f32(0))
                for rr in range(jj + 1, s.shape[0]):
                    s[rr] = _fma32(-lt[j, j0 + rr], lt[j], s[rr])
            base = j0 + NB
            if base < k:
                for jj in range(NB):
                    row = lt[j0 + jj, base:]
                    w[base:, base:] = _fma32(-row[:, None], row[None, :],
                                             w[base:, base:])
    return lt, minpiv


def _triu_inv_blocked(lt):
    """``triu_inv_blocked``: rows in blocks of 16 from the bottom, each
    row's dot the chain over the rows below its block, then the block's own
    later rows from the bottom up (each added as soon as it is solved),
    then (e_j - dot) times the reciprocal of Lt[j, j]."""
    k = lt.shape[0]
    m = np.zeros_like(lt)
    eye = np.eye(k, dtype=f32)
    for j0 in reversed(range(0, k, NB)):
        j1 = min(j0 + NB, k)
        dot = np.zeros((j1 - j0, k), f32)
        for mm in range(j1, k):
            dot = _fma32(lt[j0:j1, mm][:, None], m[mm][None, :], dot)
        for j in reversed(range(j0, j1)):
            rcp = (f32(1) / lt[j, j]).astype(f32)
            m[j] = ((eye[j] - dot[j - j0]).astype(f32) * rcp).astype(f32)
            dot[:j - j0] = _fma32(lt[j0:j, j][:, None], m[j][None, :],
                                  dot[:j - j0])
    return m


def _chain_nt(a, bt, sign=None):
    """C = A Bt^T as single ascending chains (``tmm_nt``); A's terms times
    ``sign[m]`` first."""
    out = np.zeros((a.shape[0], bt.shape[0]), f32)
    for mm in range(a.shape[1]):
        col = a[:, mm] if sign is None else (a[:, mm] * sign[mm]).astype(f32)
        out = _fma32(col[:, None], bt[:, mm][None, :], out)
    return out


def _k4a_emulated(e, v, mean, f):
    """``gsm_eps_update_fused(method="chol")`` on the card, in float32:
    (mean, F, good).  vf, t and ef are the thin product's; from F = I, as
    here, they are exact in any order."""
    assert np.array_equal(f, np.eye(f.shape[0], dtype=f32))
    b, d = e.shape
    k = 2 * b
    ef, vf, t = e.copy(), v.copy(), v.copy()
    a = -ef
    vsv, mv, ws = (np.zeros(b, f32) for _ in range(3))
    for cols in _rank_columns(d):                    # rank order
        lanes = [np.zeros((b, 32), f32) for _ in range(3)]
        for c in cols:                               # a lane's chain
            lane = (c - cols.start) % 32
            lanes[0][:, lane] = _fma32(v[:, c], t[:, c], lanes[0][:, lane])
            lanes[1][:, lane] = _fma32(a[:, c], v[:, c], lanes[1][:, lane])
            lanes[2][:, lane] = _fma32(v[:, c], (t[:, c] - a[:, c]).astype(f32),
                                       lanes[2][:, lane])
        vsv = (vsv + _butterfly(lanes[0])).astype(f32)
        mv = (mv + _butterfly(lanes[1])).astype(f32)
        ws = (ws + _butterfly(lanes[2])).astype(f32)
    one, half = f32(1), f32(0.5)
    rho = (half * (np.sqrt((one + f32(4) * _fma32(mv, mv, vsv)).astype(f32))
                   - one)).astype(f32)
    den = ((one + rho).astype(f32) + mv).astype(f32)
    inv1r = (one / (one + rho).astype(f32)).astype(f32)
    wden = (ws / den).astype(f32)
    gamma = (one - ((one + wden).astype(f32) * inv1r).astype(f32)).astype(f32)
    scale = (one / np.sqrt(f32(b))).astype(f32)
    c = _fma32(vf, inv1r[:, None], (-e * gamma[:, None]).astype(f32))
    dmu_b = (_fma32(ef, wden[:, None], (t + ef).astype(f32))
             * inv1r[:, None]).astype(f32)
    zt = np.concatenate([(-e * scale).astype(f32), (c * scale).astype(f32)])
    fzt = np.concatenate([(a * scale).astype(f32),
                          ((a + dmu_b).astype(f32) * scale).astype(f32)])
    g = np.zeros((k, k), f32)
    for cols in _rank_columns(d):                    # rank order
        part = np.zeros((k, k), f32)
        for cc in cols:                              # ascending columns
            part = _fma32(zt[:, cc][:, None], zt[:, cc][None, :], part)
        g = (g + part).astype(f32)
    diag = np.pad(np.diag(g), (0, 32 * (-(-k // 32)) - k)).reshape(-1, 32)
    tr = _butterfly(np.add.accumulate(diag, axis=0, dtype=f32)[-1][None])[0]
    jit = (f32(fs.CHOL_JITTER) * ((tr / f32(k)).astype(f32) + one)).astype(f32)
    w = g.copy()
    w[np.diag_indices(k)] = (np.diag(g) + jit).astype(f32)
    lgt, _ = _cholt_blocked(w)
    jsign = np.where(np.arange(k) < b, f32(1), f32(-1))
    kmat = (np.eye(k, dtype=f32) + _chain_nt(lgt, lgt, jsign)).astype(f32)
    m_mat = _triu_inv_blocked(lgt)
    ckt, minpiv = _cholt_blocked(kmat)
    good = bool(minpiv > 0)
    x = _chain_nt(m_mat, (ckt - np.eye(k, dtype=f32)).astype(f32))
    s2 = _chain_nt(x, m_mat)
    wz = np.zeros((k, d), f32)
    for mm in range(k):
        wz = _fma32(s2[:, mm][:, None], zt[mm][None, :], wz)
    s = np.zeros(d, f32)
    for r in range(b):
        s = _fma32(_fma32(ef[r], wden[r], (t[r] + ef[r]).astype(f32)),
                   inv1r[r], s)
    acc = np.zeros((d, d), f32)
    for r in range(k):
        acc = _fma32(fzt[r][:, None], wz[r][None, :], acc)
    if not good:
        return mean, f, good
    return ((mean + (s / f32(b)).astype(f32)).astype(f32),
            (f + acc).astype(f32), good)


def _floor_problem(b, d, seed):
    """One step from (0, I) on dense_gaussian(0, D): the draw e (numpy,
    float32), the score v at x = e and the float64 Gram's condition."""
    params = dense_gaussian(0, d, device="cpu").fused_score[1]
    e = np.random.default_rng(seed).standard_normal((b, d)).astype(f32)
    v = fs.gaussian_score_reference(torch.from_numpy(e), *params).numpy()
    return e, v


def _gram_condition(e, v):
    e64, v64 = e.astype(np.float64), v.astype(np.float64)
    b = e.shape[0]
    a = -e64
    vsv = (v64 * v64).sum(1, keepdims=True)
    mv = (a * v64).sum(1, keepdims=True)
    rho = 0.5 * (np.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
    w = (v64 * (v64 - a)).sum(1, keepdims=True)
    inv1r = 1.0 / (1.0 + rho)
    gamma = 1.0 - (1.0 + w / (1.0 + rho + mv)) * inv1r
    zt = np.concatenate([-e64, -e64 * gamma + v64 * inv1r]) / np.sqrt(b)
    ev = np.linalg.eigvalsh(zt @ zt.T)
    return float(ev.max() / ev.min())


def _cov(f):
    f = np.asarray(f, np.float64)
    return f @ f.T


def _dist(x, y):
    return (float(np.abs(np.asarray(x[0], np.float64)
                         - np.asarray(y[0], np.float64)).max()),
            float(np.abs(_cov(x[1]) - _cov(y[1])).max()))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("b,d", FLOOR_SHAPES)
def test_k4a_orders_hold_against_jax_and_float64(b, d, seed):
    e, v = _floor_problem(b, d, 100 * seed + b)
    assert _gram_condition(e, v) > 1e6
    mean, f = np.zeros(d, f32), np.eye(d, dtype=f32)
    got = _k4a_emulated(e, v, mean, f)
    plain = fs.gsm_eps_update_chol_reference(
        *map(torch.from_numpy, (e, v, mean, f)))
    plain64 = fs.gsm_eps_update_chol_reference(
        *(torch.from_numpy(x).double() for x in (e, v, mean, f)))
    jax_out = jfs.gsm_eps_update_fused(
        *(jnp.asarray(x, jnp.float32) for x in (e, v, mean, f)),
        interpret=True, method="chol")
    assert got[2] and bool(plain[2]) and bool(plain64[2]) and bool(jax_out[2])
    plain = [x.numpy() for x in plain[:2]]
    plain64 = [x.numpy() for x in plain64[:2]]
    floor_m, floor_s = _dist(plain, plain64)
    mean_tol = max(CHOL_MEAN_TOL, CHOL_FLOOR * floor_m)
    cov_tol = max(CHOL_COV_TOL * max(1.0, float(np.abs(_cov(plain[1])).max())),
                  CHOL_FLOOR * floor_s)
    for other in (plain, [np.asarray(x) for x in jax_out[:2]], plain64):
        em, es = _dist(got, other)
        assert em <= mean_tol and es <= cov_tol, (em, mean_tol, es, cov_tol)


def _spd(k, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    w = (q * np.logspace(0, np.log10(cond), k)) @ q.T
    return (0.5 * (w + w.T)).astype(f32)


@pytest.mark.parametrize("case", ["spd", "indefinite", "nan"])
@pytest.mark.parametrize("k", [2, 16, 30, 64, 66, 128])
def test_blocked_sweep_equals_the_column_sweep_bit_for_bit(k, case):
    w = _spd(k, k)
    if case == "indefinite":
        w[k // 2, k // 2] = f32(-50.0)
    elif case == "nan":
        w[k // 3, k // 3] = f32(np.nan)
    lt_b, piv_b = _cholt_blocked(w)
    lt_c, piv_c = _cholt_columns(w)
    np.testing.assert_array_equal(lt_b, lt_c)
    assert np.array_equal(piv_b, piv_c, equal_nan=True)
    if case == "spd":
        assert piv_b > 0
        np.testing.assert_allclose(lt_b.T.astype(np.float64) @ lt_b, w,
                                   rtol=0, atol=1e-4 * float(np.abs(w).max()))
    elif case == "indefinite":
        assert not piv_b > 0
    else:
        assert np.isnan(piv_b)


@pytest.mark.parametrize("k", [2, 16, 30, 64, 66, 128])
def test_blocked_inverse_inverts_the_factor(k):
    """The blocked substitution against float64 within the float32 rounding
    of a well-conditioned triangle, and upper triangular."""
    lt, _ = _cholt_blocked(_spd(k, 7 * k, cond=10.0))
    m = _triu_inv_blocked(lt)
    np.testing.assert_array_equal(m, np.triu(m))
    exact = np.linalg.inv(lt.astype(np.float64))
    np.testing.assert_allclose(m, exact, rtol=0,
                               atol=1e-5 * float(np.abs(exact).max()))


# ---------------------------------------------------------------------------
# banana
# ---------------------------------------------------------------------------

def _banana_cover(m, d):
    """(rows, chunks) each thread of ``banana_plan``'s launch writes: every
    element's writer count."""
    shift, blocks = fs.banana_plan(m, d)
    threads = fs.BANANA_THREADS
    tpr, rpb = 1 << shift, threads >> shift
    nc = -(-d // 4)
    tid = np.arange(threads)
    count = np.zeros((m, 4 * nc), np.int64)
    rows = (np.arange(blocks)[:, None] * rpb + (tid >> shift)[None, :]).ravel()
    first = np.tile(tid & (tpr - 1), blocks)
    live = rows < m
    rows, first = rows[live], first[live]
    for q0 in range(0, nc, tpr):
        q = first + q0
        ok = q < nc
        for u in range(4):
            np.add.at(count, (rows[ok], 4 * q[ok] + u), 1)
    return count[:, :d], count[:, d:]


@pytest.mark.parametrize("m,d", [(1, 2), (1, 3), (3, 5), (7, 4), (32, 7),
                                 (5, 8), (32, 256), (3, 1023), (2, 1024),
                                 (1, 1025), (2, 8192), (1025, 1028),
                                 (4097, 257)])
def test_banana_plan_writes_every_element_once(m, d):
    shift, blocks = fs.banana_plan(m, d)
    assert 0 <= shift <= 8 and (1 << shift) >= min(-(-d // 4), 256)
    assert blocks * (fs.BANANA_THREADS >> shift) >= m
    inside, pad = _banana_cover(m, d)
    assert (inside == 1).all()
    assert pad.size == 0 or pad.max() <= 1    # the masked edge of the last chunk


def _banana_emulated(x, curv, s):
    """The kernel's arithmetic: -x everywhere, then g0 and g1 from the
    chunk-0 thread's own x0, x1, each operation rounded on its own."""
    x0, x1 = x[:, 0], x[:, 1]
    s2 = f32(s) * f32(s)
    h = (x1 - (f32(curv) * ((x0 * x0).astype(f32) - s2).astype(f32))
         .astype(f32)).astype(f32)
    g0 = ((-x0 / s2).astype(f32)
          + (((f32(2) * f32(curv)) * x0).astype(f32) * h).astype(f32)
          ).astype(f32)
    v = (-x).astype(f32)
    v[:, 0], v[:, 1] = g0, -h
    return v


@pytest.mark.parametrize("m,d", [(1, 2), (1, 3), (3, 5), (32, 7),
                                 (32, 256), (3, 1025), (512, 1024)])
def test_banana_arithmetic_matches_plain_and_jax(m, d):
    rng = np.random.default_rng(m + d)
    x = rng.standard_normal((m, d)).astype(f32)
    cs = np.array([[0.7, 1.3]], f32)
    got = _banana_emulated(x, *cs[0])
    plain = fs.banana_score_reference(torch.from_numpy(x),
                                      torch.from_numpy(cs)).numpy()
    np.testing.assert_array_equal(got, plain)
    jax_v = np.asarray(jfs.banana_score_kernel(jnp.asarray(x),
                                               jnp.asarray(cs)))
    tol = ZOO_TOL * max(1.0, float(np.abs(plain).max()))
    assert float(np.abs(got.astype(np.float64) - jax_v).max()) <= tol


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

    def named(self, name):
        return [args for n, args in self.calls if n == name]


@pytest.fixture
def card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float32)


@pytest.mark.parametrize("b,d", [(1, 1), (8, 200), (32, 256), (33, 256),
                                 (64, 1024), (64, 8192)])
def test_k4a_is_the_thin_products_one_cluster_launch_and_the_apply(card, b, d):
    fs.gsm_eps_update_fused(_z(b, d), _z(b, d), _z(d), _z(d, d),
                            method="chol")
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows"] * 3 + ["gsmvi_eps_chol",
                                               "gsmvi_factor_apply"], names
    (chol,) = card.named("gsmvi_eps_chol")
    assert chol[12:16] == (b, d, *fs.thin_split(d))
    assert abs(chol[16] - fs.CHOL_JITTER) < 1e-12
    (apply,) = card.named("gsmvi_factor_apply")
    assert apply[5:8] == (2 * b, d, 1)
    assert [a[6:10] for a in card.named("gsmvi_thin_rows")] == [
        (b, d, 1, 1), (b, d, 0, 1), (b, d, 1, 1)]
    counts = fs.launch_counts()
    assert counts["gsm_eps_update_fused"] == 1 and counts["thin_product"] == 3


def test_k4_chol_step_runs_the_score_then_k4a(card):
    b, d = 32, 256
    step = fs.make_fused_eps_step(fs.gaussian_score, 2, b, d,
                                  external_eps=True, method="chol")
    step(_z(b, d), _z(d), _z(d, d), _z(1, d), _z(d, d))
    assert [n for n, _ in card.calls] == [
        "gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_thin_rows",
        "gsmvi_thin_rows", "gsmvi_eps_chol", "gsmvi_factor_apply"]
    assert fs.launch_counts()["thin_product"] == 3


def test_k4a_buffers_and_batch_ceiling(card):
    buf = fs._UpdateBuffers(32, 256, "cpu", method="chol")
    assert buf.zt.shape == buf.su.shape == buf.sw.shape == (64, 256)
    with pytest.raises(ValueError, match=r"CUDA kernels \(chol\) take"):
        fs.gsm_eps_update_fused(_z(65, 8), _z(65, 8), _z(8), _z(8, 8),
                                method="chol")
    assert not card.calls


@pytest.mark.parametrize("m,d", [(1, 2), (3, 5), (32, 256), (256, 256),
                                 (512, 1024), (2, 8192)])
def test_banana_is_one_launch_on_its_plan(card, m, d):
    v = fs.banana_score(_z(m, d), _z(1, 2))
    ((name, args),) = card.calls
    assert name == "gsmvi_banana_score"
    assert args[3:7] == (m, d, fs.banana_plan(m, d)[0], int(d % 4 == 0))
    assert args[2].value == v.data_ptr() and v.shape == (m, d)
    assert fs.launch_counts()["banana_score"] == 1
