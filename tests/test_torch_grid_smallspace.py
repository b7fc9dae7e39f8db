"""The grid small space of the large batches (``eps_smallspace_grid.cu`` at
B 129-512, its schedule in ``ops/grid_schedule.py``), checked on the CPU.

- The plain version (``eps_smallspace_ns_reference``) against the JAX
  package's ``_eps_smallspace_ns`` at B = 129 and 160 with the long NS
  profile: flags equal, the mean within 1e-5 and F' within 1e-5 * max|F|
  (the tolerances of ``tests/test_torch_fused_step.py``).
- The wrapper's launches, recorded from a stand-in library on CPU tensors:
  one ``gsmvi_eps_smallspace_large`` call per update, whose schedule, tile
  and grid do not depend on D or on the replica count K; K6's sub-steps at
  B=256 on it; the occupancy read once per batch, never inside a stream
  capture, and a 0 (or failed) reading raising, naming the shape.
- The schedule table: run op by op with torch on the CPU (every op's
  operands, epilogue, norm bound and residual as the kernel forms them,
  buffers overwritten as the kernel overwrites them), it gives the plain
  version's result at B 129-200 (tolerances as above) and rejects where
  the plain version rejects; no phase reads a buffer, norm or residual it
  writes, or one no earlier phase wrote; its products are the plain
  version's, each once (the last Z iterate of a Newton-Schulz chain, which
  nothing reads, left out); 71 phases at the long profile.
- Numpy float32 emulations of the kernel's sum orders: a product's T x T
  tiles over 16- or 32-deep slabs (one fused multiply-add chain an output, k
  ascending) equal the 32 x 32 GEMM template's ``_gemm_template`` bit for
  bit at B 129, 200 and 256; the norm bound's row sums (each thread's
  columns, a butterfly over 8 threads, column tiles ascending) are within
  1e-6 relative of float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs
from gsmvi_tpu_torch.ops import grid_schedule as gs
from gsmvi_tpu_torch.ops.cuda import _build

MEAN_TOL = 1e-5
F_TOL = 1e-5
LONG = fs.NS_ITERS_LARGE_B


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, b, d, decades=0.0):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    ladder = np.logspace(0.0, decades, b)[:, None]
    eps = (ladder * rng.standard_normal((b, d))).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


# ---------------------------------------------------------------------------
# The plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d", [(129, 24), (160, 40)])
def test_plain_version_matches_jax_above_the_panel_range(b, d):
    eps, v, mu, f = _problem(b + d, b, d)
    vf = v @ f
    m_j, f_j, g_j = jfs._eps_smallspace_ns(
        *(jnp.asarray(x, jnp.float32) for x in (eps, v, vf, mu[None], f)),
        batch=b, iters=jfs.NS_ITERS_LARGE_B)
    m_t, f_t, g_t = fs.eps_smallspace_ns_reference(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (eps, v, vf, mu[None], f)), batch=b, iters=LONG)
    assert tuple(jfs.NS_ITERS_LARGE_B) == LONG
    assert bool(g_t) == bool(g_j) is True
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=MEAN_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=F_TOL * float(np.abs(f).max()))


# ---------------------------------------------------------------------------
# The wrapper's launches, on a stand-in library
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the CUDA kernel library: records each entry point's
    name and arguments; ``blocks`` is what the occupancy query reads."""

    def __init__(self):
        self.calls = []
        self.sizes = []
        self.blocks = 264

    def call(self, name, *args):
        self.calls.append((name, args))

    def size(self, name, *args):
        self.sizes.append((name, args))
        if name == "gsmvi_eps_grid_blocks":
            return self.blocks
        return 168 if name == "gsmvi_eps_large_sync" else 16

    def named(self, name):
        return [args for n, args in self.calls if n == name]


@pytest.fixture
def card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_PLACEMENT", {})
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _rows(*shape):
    return torch.zeros(shape, dtype=torch.float32)


_ARGS = _build.SIGNATURES["gsmvi_eps_smallspace_large"]


def _grid_call(args):
    """(table pointer, nphases, b, d, reps, e_stride, tile, blocks) of a
    ``gsmvi_eps_smallspace_large`` call, whose arguments match the C
    entry's: 13 row pointers, ws, sync, table, nphases, b, d, tol, reps,
    e_stride, tile, blocks, stream."""
    assert len(args) == len(_ARGS) == 25
    return (args[15].value, args[16], args[17], args[18], args[20],
            args[21], args[22], args[23])


@pytest.mark.parametrize("b", [129, 256, 512])
def test_one_grid_launch_per_update_independent_of_d_and_k(card, b):
    seen = []
    for d in (1, 33, 256, 1024):
        for k in (None, 3):
            lead = () if k is None else (k,)
            card.calls.clear()
            fs.gsm_eps_update_fused(_rows(*lead, b, d), _rows(*lead, b, d),
                                    _rows(*lead, d), _rows(*lead, d, d))
            (grid,) = card.named("gsmvi_eps_smallspace_large")
            table, nph, b_, d_, reps, e_stride, tile, blocks = _grid_call(grid)
            assert (b_, d_, reps, e_stride) == (b, d, k or 1, b * d)
            assert grid[19] == pytest.approx(fs.NS_TOL)
            seen.append((table, nph, tile, blocks))
            assert [n for n, _ in card.calls] == (
                ["gsmvi_thin_rows"] * 3
                + ["gsmvi_eps_smallspace_large", "gsmvi_factor_apply"])
    # One schedule, tile and grid for every D and K.
    assert len(set(seen)) == 1
    assert seen[0][1:] == (71, fs.grid_tile(b), card.blocks)
    counts = fs.launch_counts()
    assert counts["eps_smallspace_large"] == 8 == counts["gsm_eps_update_fused"]
    assert counts["eps_smallspace"] == counts["eps_smallspace_panel"] == 0
    # The occupancy is read once per batch, for the batch's tile.
    reads = [a for n, a in card.sizes if n == "gsmvi_eps_grid_blocks"]
    assert reads == [(fs.grid_tile(b),)]


def test_k6_at_b256_runs_its_sub_steps_on_the_grid_small_space(card):
    b, d, spc, k = 256, 64, 8, 4
    params = (_rows(1, d), _rows(d, d))
    batch = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d, k,
                                               spc)
    batch(3, _rows(k, spc * b, d), _rows(k, d), _rows(k, d, d), *params)
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_thin_rows",
                     "gsmvi_thin_rows", "gsmvi_eps_smallspace_large",
                     "gsmvi_factor_apply"] * 3
    # Each replica's draw is a view into the (K, spc*B, D) block.
    assert {_grid_call(a)[2:6] for a in card.named(
        "gsmvi_eps_smallspace_large")} == {(b, d, k, spc * b * d)}
    assert fs.launch_counts()["eps_smallspace_large"] == 3


@pytest.mark.parametrize("b", [129, 512])
@pytest.mark.parametrize("reads", [0, -2])
def test_grid_launch_raises_when_the_card_cannot_hold_it(card, b, reads):
    card.blocks = reads
    with pytest.raises(RuntimeError,
                       match=rf"B={b} \(tile {fs.grid_tile(b)}\) cannot be "
                             r"placed"):
        fs.gsm_eps_update_fused(_rows(b, 8), _rows(b, 8), _rows(8),
                                _rows(8, 8))
    assert not card.named("gsmvi_eps_smallspace_large")
    assert fs.launch_counts()["eps_smallspace_large"] == 0


def test_grid_occupancy_is_never_read_inside_a_capture(card, monkeypatch):
    """The occupancy query sets the kernel's shared-memory attribute, which
    a stream capture does not allow: a batch's first launch inside one
    raises and launches nothing; a batch read before captures as usual."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    b, d = 200, 16
    launch = lambda: fs.gsm_eps_update_fused(_rows(b, d), _rows(b, d),
                                             _rows(d), _rows(d, d))
    with pytest.raises(RuntimeError, match=f"B={b}: its first launch"):
        launch()
    assert not [n for n, _ in card.sizes if n == "gsmvi_eps_grid_blocks"]
    assert not card.named("gsmvi_eps_smallspace_large")
    fs._PLACEMENT[("grid", b)] = 264
    launch()
    assert len(card.named("gsmvi_eps_smallspace_large")) == 1


def test_refused_launch_raises_naming_the_shape(card, monkeypatch):
    def refuse(name, *args):
        if name == "gsmvi_eps_smallspace_large":
            raise RuntimeError(f"{name}: CUDA error 720 (too many blocks in "
                               "cooperative launch)")
    monkeypatch.setattr(card, "call", refuse)
    with pytest.raises(RuntimeError, match=r"B=300, D=8, K=1 \(264 blocks "
                                           r"of tile 32\).*cooperative"):
        fs.gsm_eps_update_fused(_rows(300, 8), _rows(300, 8), _rows(8),
                                _rows(8, 8))


def test_tile_is_a_function_of_the_batch():
    assert [fs.grid_tile(b) for b in (129, 256, 257, 512)] == [16, 16, 32, 32]
    assert fs.grid_tile(fs.GRID_TILE16_MAX_B) == 16


# ---------------------------------------------------------------------------
# The schedule table, run with torch ops
# ---------------------------------------------------------------------------

def _operand(src, mode, n, nrm):
    eye = torch.eye(n, dtype=torch.float32)
    if mode == gs.O_PLAIN:
        return src
    if mode == gs.O_TRANS:
        return src.T
    if mode == gs.O_EYE:
        return eye
    if mode == gs.O_EYE_INV:
        return eye * (1.0 / nrm)
    if mode == gs.O_NS_PLUS:
        return (eye + src) / nrm
    assert mode == gs.O_NS_MINUS, mode
    return (eye - src) / nrm


def _norm(w):
    return torch.max(torch.sum(torch.abs(w), dim=-1)) + 1e-30


def run_schedule(table, nphases, e, v, vf, t, ef, mu, *, b, tol=fs.NS_TOL):
    """The encoded schedule run op by op with torch: (mean, stack_u,
    stack_w, good).  Raises AssertionError where a phase reads what it
    writes or what no earlier phase wrote."""
    d = e.shape[1]
    zc = 1.0 / b ** 0.5
    nan = lambda *s: torch.full(s, float("nan"))
    rows = {gs.S_E: e, gs.S_V: v, gs.S_VF: vf, gs.S_T: t, gs.S_EF: ef,
            gs.S_C: nan(b, d), gs.S_XIM: nan(b, d)}
    su, sw = nan(2 * b, d), nan(2 * b, d)
    views = {gs.S_SU_LO: su[:b], gs.S_SU_HI: su[b:], gs.S_SW_LO: sw[:b],
             gs.S_SW_HI: sw[b:]}
    rows.update(views)
    state = {}                       # matrices, scalars, norms, residuals
    ready = {gs.S_E, gs.S_V, gs.S_VF, gs.S_T, gs.S_EF, "mean"}
    eye = torch.eye(b, dtype=torch.float32)
    out = {}
    for phase in gs.decode(table, nphases):
        reads, writes, pending = set(), set(), []

        def get(i):
            reads.add(i)
            return rows[i] if i in rows else state[i]

        def put(i, val):
            writes.add(i)
            pending.append((i, val))

        def dim(x):
            return d if x == gs.DIM_D else x

        for op in phase:
            kind = op["kind"]
            nrm = None
            if op["nrm"] >= 0:
                nrm = get(("norm", op["nrm"]))
            if kind in (gs.K_GEMM, gs.K_PAIR):
                m, n, k = dim(op["m"]), dim(op["n"]), dim(op["k"])
                a = _operand(get(op["a"]) if op["a"] >= 0 else None,
                             op["amode"], b, nrm)
                bb = _operand(get(op["b"]) if op["b"] >= 0 else None,
                              op["bmode"], b, nrm)
                assert a.shape == (m, k) and bb.shape == (k, n), op
                acc = a @ bb
                epi = op["epi"]
                aux = get(op["aux"]) if op["aux"] >= 0 else None
                if epi in (gs.E_RES_PLUS, gs.E_RES_MINUS):
                    ref = eye + aux if epi == gs.E_RES_PLUS else eye - aux
                    put(("res", op["res"]), torch.sum((acc - ref) ** 2)
                        / (torch.sum(ref ** 2) + 1e-30))
                    continue
                if kind == gs.K_PAIR:
                    ps = acc * torch.sqrt(nrm)
                    val = 0.5 * (ps + ps.T)
                    put(op["out2"], eye + val)
                    put(("norm", op["pset"]), _norm(eye + val))
                    if op["pset2"] >= 0:
                        put(op["out3"], (eye + val) + aux)
                        put(("norm", op["pset2"]), _norm((eye + val) + aux))
                else:
                    val = {gs.E_STORE: lambda: acc,
                           gs.E_SCALE_B: lambda: acc * (1.0 / b),
                           gs.E_SCALE_ZC: lambda: acc * zc,
                           gs.E_NS_T: lambda: 0.5 * (3.0 * eye - acc),
                           gs.E_INV_T: lambda: 2.0 * eye - acc,
                           gs.E_XIM: lambda: (get(gs.S_C) - acc) * zc,
                           gs.E_SU2: lambda: (-get("gamma") * ef
                                              + get("inv1r") * t + acc) * zc,
                           gs.E_SUB_AUXT: lambda: acc - aux.T,
                           gs.E_NEG: lambda: -acc,
                           }[epi]()
                    if op["pset"] >= 0:
                        w = eye + val if op["pexpr"] == gs.P_PLUS else eye - val
                        put(("norm", op["pset"]), _norm(w))
                put(op["out"], val)
            elif kind == gs.K_ROWSCAL:
                a = -ef
                vsv = torch.sum(v * t, dim=1, keepdim=True)
                mv = torch.sum(a * v, dim=1, keepdim=True)
                rho = 0.5 * (torch.sqrt(1.0 + 4.0 * (vsv + mv * mv)) - 1.0)
                wsum = torch.sum(v * (t - a), dim=1, keepdim=True)
                inv1r = 1.0 / (1.0 + rho)
                wden = wsum / (1.0 + rho + mv)
                put("gamma", 1.0 - (1.0 + wden) * inv1r)
                put("inv1r", inv1r)
                put("wden", wden)
            elif kind == gs.K_CROWS:
                put(gs.S_C, -e * get("gamma") + vf * get("inv1r"))
                put(gs.S_SU_LO, ef * zc)
            elif kind == gs.K_MEANSUM:
                dmu = ((t + ef) + ef * get("wden")) * get("inv1r")
                c = rows[gs.S_C].clone()       # row 0 overwritten
                c[0] = torch.sum(dmu, dim=0)
                put(gs.S_C, c)
            else:
                assert kind == gs.K_SELECT, kind
                good = bool(get(("res", 0)) < tol) and bool(get(("res", 1)) < tol)
                s = get(gs.S_C)[0]
                out["mean"] = mu + s / b if good else mu
                out["good"] = good
        assert not reads & writes, (reads & writes, phase)
        missing = {r for r in reads if r not in ready}
        assert not missing, (missing, phase)
        for i, val in pending:
            if i in rows:
                rows[i].copy_(val)
            else:
                state[i] = val
            ready.add(i)
    return out["mean"], su, sw, out["good"]


def _table(b, iters=LONG):
    phases = gs.grid_schedule(b, iters)
    return gs.encode(phases), len(phases)


@pytest.mark.parametrize("b,d,decades", [(129, 24, 0.0), (160, 40, 0.0),
                                         (200, 16, 0.0), (144, 24, 3.0)])
def test_schedule_run_in_torch_equals_the_plain_version(b, d, decades):
    eps, v, mu, f = (torch.from_numpy(x)
                     for x in _problem(3 * b + d, b, d, decades))
    vf = v @ f
    t, ef = vf @ f.T, eps @ f.T
    table, nph = _table(b)
    m_s, su_s, sw_s, g_s = run_schedule(table, nph, eps, v, vf, t, ef, mu,
                                        b=b)
    m_p, su_p, sw_p, g_p = fs.eps_smallspace_stacks_reference(
        eps, v, vf, t, ef, mu[None], batch=b, iters=LONG)
    assert g_s == bool(g_p) == (decades == 0.0)
    if g_s:
        np.testing.assert_allclose(m_s.numpy(), m_p[0].numpy(), rtol=0,
                                   atol=MEAN_TOL)
        fscale = float(f.abs().max())
        np.testing.assert_allclose((f + su_s.T @ sw_s).numpy(),
                                   (f + su_p.T @ sw_p).numpy(), rtol=0,
                                   atol=F_TOL * fscale)
    else:
        assert torch.equal(m_s, mu)


@pytest.mark.parametrize("iters", [(5, 4, 3, 7, 4), (1, 1, 1, 1, 1),
                                   (2, 7, 3, 2, 5)])
def test_schedule_runs_any_profile(iters):
    b, d = 136, 12
    eps, v, mu, f = (torch.from_numpy(x) for x in _problem(b, b, d))
    vf = v @ f
    t, ef = vf @ f.T, eps @ f.T
    table, nph = _table(b, iters)
    m_s, su_s, sw_s, g_s = run_schedule(table, nph, eps, v, vf, t, ef, mu,
                                        b=b, tol=float("inf"))
    m_p, su_p, sw_p, _ = fs.eps_smallspace_stacks_reference(
        eps, v, vf, t, ef, mu[None], batch=b, iters=iters, tol=float("inf"))
    np.testing.assert_allclose(m_s.numpy(), m_p[0].numpy(), rtol=0,
                               atol=MEAN_TOL)
    np.testing.assert_allclose((su_s.T @ sw_s).numpy(),
                               (su_p.T @ sw_p).numpy(), rtol=0,
                               atol=F_TOL * max(1.0, float(
                                   (su_p.T @ sw_p).abs().max())))


def _expected_products(iters):
    """The plain version's products, by the schedule's labels: each
    Newton-Schulz sweep's Z Y, Y T and T Z (the last T Z, which nothing
    reads, left out), each Newton-Hotelling sweep's A X and X T, the two
    residuals' S S, and the Grams and row products around them."""
    it0, it1, it2, it3, it4 = iters
    out = ["gu", "ec", "res1", "cuiec", "xim", "gv", "qa", "w1row", "su2",
           "res2", "w2row"]
    for tag, n in (("s1", it0), ("s2", it3)):
        for j in range(1, n + 1):
            out += [f"{tag}.{j}.zy", f"{tag}.{j}.yt"]
            out += [f"{tag}.{j}.tz"] if j < n else []
    for tag, n in (("cu", it1), ("cui", it2), ("cv", it4)):
        for j in range(1, n + 1):
            out += [f"{tag}.{j}.ax", f"{tag}.{j}.xt"]
    return sorted(out)


@pytest.mark.parametrize("iters", [LONG, fs.NS_ITERS_DEFAULT, (5, 4, 3, 7, 4)])
def test_schedule_covers_the_plain_products_once(iters):
    phases = gs.grid_schedule(200, iters)
    ops = [(label, op) for phase in phases for label, op in phase]
    products = sorted(label for label, op in ops
                      if op["kind"] in (gs.K_GEMM, gs.K_PAIR))
    assert products == _expected_products(iters)
    rows = sorted(label for label, op in ops
                  if op["kind"] not in (gs.K_GEMM, gs.K_PAIR))
    assert rows == ["crows", "meansum", "rowscal", "select"]
    assert [label for label, _ in phases[-1]] == ["w2row", "select"]
    if iters == LONG:
        # 97 chain products and 8 with the rows, in 71 phases.
        assert len(products) == 105 and len(phases) == 71


@pytest.mark.parametrize("b", [129, 256, 512])
def test_schedule_depends_on_the_batch_alone(b):
    phases = gs.grid_schedule(b, LONG)
    table = gs.encode(phases)
    assert gs.decode(table, len(phases)) == [[op for _, op in ph]
                                             for ph in phases]
    for ph in phases:
        for _, op in ph:
            assert {op["m"], op["n"], op["k"]} <= {0, b, gs.DIM_D}
            # The operand modes: a source, its transpose or one formed
            # from the identity.
            assert {op["amode"], op["bmode"]} <= set(range(6))
            assert op["kind"] != gs.K_GEMM or op["out"] >= 0 or op["res"] >= 0
    with pytest.raises(ValueError, match="five NS sweep counts >= 1"):
        gs.grid_schedule(b, (8, 6, 0, 10, 6))


# ---------------------------------------------------------------------------
# The kernel's sum orders in numpy float32
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _chain(a, b):
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        out = _fma32(a[:, k:k + 1], b[k:k + 1, :], out)
    return out


def _gemm_template(a, b, tile=32):
    """The 32 x 32 GEMM template (``gemm.cuh``): one chain per output."""
    n = a.shape[0]
    out = np.zeros((n, b.shape[1]), np.float32)
    for i0 in range(0, n, tile):
        for j0 in range(0, b.shape[1], tile):
            out[i0:i0 + tile, j0:j0 + tile] = _chain(a[i0:i0 + tile],
                                                     b[:, j0:j0 + tile])
    return out


def _grid_product(a, b, tile):
    """C = A B as a worker forms it: T x T output tiles, k in slabs of 16
    (T = 32) or 32 (T = 16) depths, zero-padded past K, in order, one fmaf
    chain per output."""
    m, kdim = a.shape
    bk = 16 if tile == 32 else 32
    kp = -(-kdim // bk) * bk
    ap = np.zeros((m, kp), np.float32)
    bp = np.zeros((kp, b.shape[1]), np.float32)
    ap[:, :kdim], bp[:kdim] = a, b
    out = np.zeros((m, b.shape[1]), np.float32)
    for i0 in range(0, m, tile):
        for j0 in range(0, b.shape[1], tile):
            acc = np.zeros((min(tile, m - i0), min(tile, b.shape[1] - j0)),
                           np.float32)
            for s0 in range(0, kp, bk):
                for k in range(s0, s0 + bk):
                    acc = _fma32(ap[i0:i0 + tile, k:k + 1],
                                 bp[k:k + 1, j0:j0 + tile], acc)
            out[i0:i0 + tile, j0:j0 + tile] = acc
    return out


@pytest.mark.parametrize("n", [129, 200, 256])
def test_tile_order_equals_the_template_order(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2 * n)).astype(np.float32)
    a = (np.eye(n) + 4.0 * (x @ x.T) / (2 * n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    want = _gemm_template(a, b)
    got = _grid_product(a, b, fs.grid_tile(n))
    assert np.array_equal(got, want)
    # A Gram over D (k = 40, zero-padded to a whole slab) is exactly symmetric.
    e = rng.standard_normal((n, 40)).astype(np.float32)
    g = _grid_product(e, e.T.copy(), fs.grid_tile(n))
    assert np.array_equal(g, g.T)


def _kernel_row_sums(w, tile):
    """|w|'s row sums as the epilogue and the ticket form them: each of a
    row's 8 threads sums its tile/8 columns in order, a butterfly over the
    8 (1, 2, 4 apart), then the column tiles in ascending order."""
    n, m = w.shape
    r = tile // 8
    aw = np.abs(w).astype(np.float32)
    rs = np.zeros(n, np.float32)
    for j0 in range(0, m, tile):
        lanes = []
        for tx in range(8):
            s = np.zeros(n, np.float32)
            for c in range(j0 + tx * r, min(m, j0 + (tx + 1) * r)):
                s = (s + aw[:, c]).astype(np.float32)
            lanes.append(s)
        for o in (1, 2, 4):
            lanes = [(lanes[i] + lanes[i ^ o]).astype(np.float32)
                     for i in range(8)]
        rs = (rs + lanes[0]).astype(np.float32)
    return rs


@pytest.mark.parametrize("n", [129, 256, 512])
def test_norm_row_sums_within_float64(n):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n, n)).astype(np.float32)
    w = (np.eye(n) + x / n).astype(np.float32)
    got = _kernel_row_sums(w, fs.grid_tile(n))
    exact = np.abs(w.astype(np.float64)).sum(axis=1)
    assert np.abs(got - exact).max() <= 1e-6 * exact.max()
    # The bound is the max over row blocks of their rows' max.
    tile = fs.grid_tile(n)
    blocks = [got[i:i + tile].max() for i in range(0, n, tile)]
    assert max(blocks) == got.max()
