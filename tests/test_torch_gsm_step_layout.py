"""How K5, the dense GSM update, cuts its work, checked on the CPU.

- K5's launch plan (``gsm_step.k5_launch_plan``): launch A, T = V S0 on the
  split-k thin product, splits D by ``thin_split``; launch B, the Gram,
  covers the 32x32 tiles of S with I <= J (each off-diagonal tile also
  writes its mirror) and splits the B sample rows by ``gram_split``.  Both
  are functions of (B, D) alone, never of the replica count K; every split
  covers its range with no empty rank, at B {1, 2, 32, 129, 512, 65536} x
  D {1, 7, 33, 256, 8192}.
- The wrapper's launches, recorded from a stand-in library on CPU tensors:
  one entry call per update with the plan's splits, the scratch (T and the
  dot products) reused from call to call and never an output.
- numpy float32 emulations of the new sum orders against float64: each
  row's tile partials summed in ascending tile order, the Gram's partials
  in rank order, the mean in its fixed order.  Each stays within 8x the
  plain float32 version's own distance from float64 (the rule the port
  holds new sum orders to), and the emulated S is symmetric bit for bit.
"""

import numpy as np
import pytest
import torch

from gsmvi_tpu_torch.ops import fused_step as fs
from gsmvi_tpu_torch.ops import gsm_step as gs
from gsmvi_tpu_torch.ops.gsm import gsm_update

PLAN_B = [1, 2, 32, 129, 512, 65536]
PLAN_D = [1, 7, 33, 256, 8192]
FLOOR_FACTOR = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def _kernel_tile(tile: int, nt: int) -> tuple:
    """``gram_kernel``'s decode of its cluster index into (I, J)."""
    ti = 0
    while tile >= nt - ti:
        tile -= nt - ti
        ti += 1
    return ti, ti + tile


def _gram_tiles(d: int) -> list:
    """The Gram launch's 32x32 tiles (I, J) of S, in cluster order along
    blockIdx.x: the upper triangle I <= J, row by row; an off-diagonal
    tile also writes its mirror (J, I)."""
    nt = -(-d // fs.SLAB)
    return [(i, j) for i in range(nt) for j in range(i, nt)]


def _covers(n: int, split: tuple) -> bool:
    s, k_per = split
    ks = [k for r in range(s) for k in range(r * k_per,
                                             min(n, (r + 1) * k_per))]
    return (1 <= s <= fs.CLUSTER_MAX_BLOCKS and k_per % fs.SLAB == 0
            and ks == list(range(n))
            and all(r * k_per < n for r in range(s)))


@pytest.mark.parametrize("d", PLAN_D)
@pytest.mark.parametrize("b", PLAN_B)
def test_launch_plan_covers_the_upper_tiles_and_splits(b, d):
    plan = gs.k5_launch_plan(b, d)
    nt = -(-d // fs.SLAB)
    thin, gram = plan["thin"], plan["gram"]
    assert thin["split"] == fs.thin_split(d) and _covers(d, thin["split"])
    assert gram["split"] == gs.gram_split(b) and _covers(b, gram["split"])
    assert thin["cluster"] == thin["split"][0]
    assert gram["cluster"] == gram["split"][0]
    assert thin["grid"] == (nt * thin["cluster"], -(-b // fs.SLAB))
    assert thin["grid"][1] <= 65535
    # Launch B: one cluster per tile with I <= J, nothing else; with the
    # mirrors every tile of S is written exactly once.
    tiles = _gram_tiles(d)
    assert gram["grid"] == (len(tiles) * gram["cluster"], 1)
    assert gram["grid"][0] < 2 ** 31
    assert len(set(tiles)) == len(tiles) == nt * (nt + 1) // 2
    assert all(i <= j for i, j in tiles)
    written = tiles + [(j, i) for i, j in tiles if i != j]
    assert sorted(written) == [(i, j) for i in range(nt) for j in range(nt)]
    step = max(1, len(tiles) // 997)          # every tile up to D=1024
    for c in range(0, len(tiles), step):
        assert _kernel_tile(c, nt) == tiles[c]
    assert _kernel_tile(len(tiles) - 1, nt) == (nt - 1, nt - 1)


def test_splits_at_the_main_shapes():
    assert gs.gram_split(32) == (1, 32)         # 36 clusters of 1 at D=256
    assert gs.gram_split(512) == (8, 64)        # 36 clusters of 8
    assert gs.gram_split(129) == (5, 32)
    assert gs.gram_split(1) == (1, 32)
    assert gs.gram_split(65536) == (8, 8192)
    assert gs.k5_launch_plan(32, 256)["thin"]["grid"] == (64, 1)
    assert gs.k5_launch_plan(512, 256)["gram"]["grid"] == (288, 1)


# ---------------------------------------------------------------------------
# The wrapper's launches, on a stand-in library
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
    """K5's card path on CPU tensors, launching into a recorder."""
    rec = _Recorder()
    monkeypatch.setattr(gs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(gs, "_library", lambda: rec)
    monkeypatch.setattr(gs, "_stream", lambda device: None)
    monkeypatch.setattr(gs, "_SCRATCH", gs.OrderedDict())
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _operands(b, d, k=None):
    lead = () if k is None else (k,)
    z = lambda *s: torch.zeros((*lead, *s), dtype=torch.float32)
    return z(b, d), z(b, d), z(d), z(d, d)


def _ptrs(args):
    """The pointer arguments of a ``gsmvi_gsm_update`` call, by name."""
    names = ("x", "v", "mu0", "s0", "t", "dots", "mu", "s")
    return {n: a.value for n, a in zip(names, args[:8])}


@pytest.mark.parametrize("b,d", [(1, 1), (2, 7), (32, 256), (129, 33),
                                 (512, 64)])
def test_launch_shapes_do_not_depend_on_replicas(card, b, d):
    plan = gs.k5_launch_plan(b, d)
    for k in (None, 1, 3, 8):
        card.calls.clear()
        mu, s = gs.gsm_update_fused(*_operands(b, d, k))
        ((name, args),) = card.calls
        assert name == "gsmvi_gsm_update"
        assert args[8:11] == (b, d, k or 1)
        assert args[11:13] == plan["thin"]["split"]
        assert args[13:15] == plan["gram"]["split"]
        lead = () if k is None else (k,)
        assert mu.shape == (*lead, d) and s.shape == (*lead, d, d)
    assert fs.launch_counts()["gsm_update_fused"] == 4


def test_scratch_is_reused_and_never_an_output(card):
    ops = _operands(32, 40)
    outs = [gs.gsm_update_fused(*ops) for _ in range(3)]
    ptrs = [_ptrs(args) for _, args in card.calls]
    assert len({(p["t"], p["dots"]) for p in ptrs}) == 1
    for p, (mu, s) in zip(ptrs, outs):
        assert p["mu"] == mu.data_ptr() and p["s"] == s.data_ptr()
        assert {p["t"], p["dots"]}.isdisjoint(
            {p[n] for n in ("x", "v", "mu0", "s0", "mu", "s")})
    # Each call's outputs are fresh tensors: none shares storage.
    out_ptrs = [t.data_ptr() for pair in outs for t in pair]
    assert len(set(out_ptrs)) == len(out_ptrs)
    (buf,) = gs._SCRATCH.values()
    assert buf.t.shape == (32, 40) and buf.dots.shape == (2, 3, 32)
    # Another K, B or D takes its own scratch.
    gs.gsm_update_fused(*_operands(32, 40, 3))
    assert _ptrs(card.calls[-1][1])["t"] != ptrs[0]["t"]
    assert len(gs._SCRATCH) == 2


def test_held_scratch_is_bounded_by_bytes(card, monkeypatch):
    """The most recent keys are held while they fit in
    SCRATCH_MAX_BYTES together; a scratch larger than that alone is the
    call's own and never held."""
    nbytes = lambda b, d: 4 * b * (d + 3 * -(-d // fs.SLAB))
    monkeypatch.setattr(gs, "SCRATCH_MAX_BYTES", nbytes(8, 8) + nbytes(3, 8))
    for b in (8, 8, 1, 2, 8, 3):
        gs.gsm_update_fused(*_operands(b, 8))
        held = list(gs._SCRATCH.values())
        assert sum(x.nbytes for x in held) <= gs.SCRATCH_MAX_BYTES
        assert [x.nbytes for x in held] == [
            nbytes(x.t.shape[-2], 8) for x in held]
    # B 1, 2 and 8 fill the cap exactly; B=3 evicts the oldest, 1 then 2.
    assert [x.t.shape[-2] for x in gs._SCRATCH.values()] == [8, 3]
    kept = dict(gs._SCRATCH)
    for _ in range(2):
        gs.gsm_update_fused(*_operands(64, 8))
    big = [_ptrs(args)["t"] for _, args in card.calls[-2:]]
    assert dict(gs._SCRATCH) == kept
    assert all(p not in {x.t.data_ptr() for x in kept.values()} for p in big)


def test_wrapper_raises_outside_the_range(card):
    with pytest.raises(ValueError, match="B in"):
        gs.gsm_update_fused(*_operands(65537, 1))
    with pytest.raises(ValueError, match="K <="):
        gs.gsm_update_fused(*(t[None] for t in _operands(2, 3, 2)))
    assert card.calls == []


# ---------------------------------------------------------------------------
# The kernels' sum orders in numpy float32, against float64
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _thin(a, f):
    """a (M, D) @ f (D, N) in the thin kernel's order: rank r of
    ``thin_split(D)`` accumulates its k range ascending with fused
    multiply-adds; the partials are summed in rank order."""
    d = a.shape[1]
    s, k_per = fs.thin_split(d)
    out = np.zeros((a.shape[0], f.shape[1]), np.float32)
    for r in range(s):
        part = np.zeros_like(out)
        for k in range(r * k_per, min(d, (r + 1) * k_per)):
            part = _fma32(a[:, k:k + 1], f[k:k + 1, :], part)
        out = (out + part).astype(np.float32)
    return out


def _butterfly(vals):
    """The warp's xor-butterfly sum over the last axis (32 lanes): lane 0's
    result."""
    for o in (16, 8, 4, 2, 1):
        vals = (vals + vals[..., np.arange(32) ^ o]).astype(np.float32)
    return vals[..., 0]


def _row_scalars(x, v, mu0, t):
    """Launch A's tile partials (a butterfly over each 32-column tile), then
    launch B's ascending-tile sums: (vsv, mv, w), wden and 1 / (1 + rho)."""
    b, d = x.shape
    nt = -(-d // fs.SLAB)
    pad = lambda z: np.pad(z, ((0, 0), (0, nt * fs.SLAB - d)))
    a = (mu0 - x).astype(np.float32)
    tiles = lambda z: pad(z).reshape(b, nt, fs.SLAB)
    prods = [tiles(v * t), tiles(a * v), tiles(v * (t - a).astype(np.float32))]
    parts = [_butterfly(p.astype(np.float32)) for p in prods]   # (b, nt)
    vsv, mv, w = (np.zeros(b, np.float32) for _ in range(3))
    for q in range(nt):
        vsv = (vsv + parts[0][:, q]).astype(np.float32)
        mv = (mv + parts[1][:, q]).astype(np.float32)
        w = (w + parts[2][:, q]).astype(np.float32)
    one = np.float32(1.0)
    rho = (np.float32(0.5) * (np.sqrt(one + np.float32(4.0) * (vsv + mv * mv))
                              - one)).astype(np.float32)
    return ((vsv, mv, w), (w / (one + rho + mv)).astype(np.float32),
            (one / (one + rho)).astype(np.float32))


def _k5_emulated(x, v, mu0, s0):
    """(row scalars, mu, S) in K5's orders, float32."""
    b = x.shape[0]
    t = _thin(v, s0)
    sums, wden, ropr = _row_scalars(x, v, mu0, t)
    a = (mu0 - x).astype(np.float32)
    dmu = (((t - a) - a * wden[:, None]) * ropr[:, None]).astype(np.float32)
    bm = (a + dmu).astype(np.float32)
    s_split, k_per = gs.gram_split(b)
    ds = np.zeros(s0.shape, np.float32)
    msum = np.zeros(mu0.shape, np.float32)
    for r in range(s_split):
        part = np.zeros_like(ds)
        mpart = np.zeros_like(msum)
        for k in range(r * k_per, min(b, (r + 1) * k_per)):
            part = _fma32(a[k][:, None], a[k][None, :], part)
            part = _fma32(-bm[k][:, None], bm[k][None, :], part)
            mpart = (mpart + dmu[k]).astype(np.float32)
        ds = (ds + part).astype(np.float32)
        msum = (msum + mpart).astype(np.float32)
    inv_b = np.float32(1.0) / np.float32(b)
    return (sums, (mu0 + msum * inv_b).astype(np.float32),
            (s0 + ds * inv_b).astype(np.float32))


def _row_sums_f64(x, v, mu0, s0):
    x, v, mu0, s0 = (z.astype(np.float64) for z in (x, v, mu0, s0))
    t, a = v @ s0, mu0 - x
    return (np.sum(v * t, 1), np.sum(a * v, 1), np.sum(v * (t - a), 1))


def _row_sums_plain32(x, v, mu0, s0):
    xt, vt, mt, st = (torch.from_numpy(z) for z in (x, v, mu0, s0))
    t, a = vt @ st, mt - xt
    return tuple(z.numpy() for z in (torch.sum(vt * t, -1),
                                      torch.sum(a * vt, -1),
                                      torch.sum(vt * (t - a), -1)))


def _inputs(seed, b, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    s0 = (a @ a.T / d + np.eye(d)).astype(np.float32)
    s0 = (0.5 * (s0 + s0.T)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    x = (mu + rng.standard_normal((b, d))).astype(np.float32)
    v = (-(x - rng.standard_normal(d))).astype(np.float32)
    return x, v, mu, s0


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max())


@pytest.mark.parametrize("b,d", [(1, 40), (32, 256), (129, 33), (512, 64)])
def test_sum_orders_within_eight_times_the_plain_floor(b, d):
    x, v, mu0, s0 = _inputs(b * 7 + d, b, d)
    sums, mu_e, s_e = _k5_emulated(x, v, mu0, s0)
    mu64, s64 = (z.numpy() for z in gsm_update(
        *(torch.from_numpy(z.astype(np.float64)) for z in (x, v, mu0, s0))))
    mu32, s32 = (z.numpy() for z in gsm_update(
        *(torch.from_numpy(z) for z in (x, v, mu0, s0))))
    tiny = 1e-7 * max(1.0, float(np.abs(s64).max()))   # an exact plain result
    for got, plain, exact in zip(sums, _row_sums_plain32(x, v, mu0, s0),
                                 _row_sums_f64(x, v, mu0, s0)):
        floor = max(_err(plain, exact), 1e-7 * max(1.0, np.abs(exact).max()))
        assert _err(got, exact) <= FLOOR_FACTOR * floor
    assert _err(mu_e, mu64) <= FLOOR_FACTOR * max(_err(mu32, mu64), tiny)
    assert _err(s_e, s64) <= FLOOR_FACTOR * max(_err(s32, s64), tiny)
    assert np.array_equal(s_e, s_e.T)
    # chip_smoke.py's DENSE_TOL between the kernel and its plain version.
    tol = 1e-5 * max(1.0, float(np.abs(s32).max()))
    assert _err(s_e, s32.astype(np.float64)) <= tol
    assert _err(mu_e, mu32.astype(np.float64)) <= 1e-5 * max(
        1.0, float(np.abs(mu32).max()))
