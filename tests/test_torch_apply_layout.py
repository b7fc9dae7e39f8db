"""How the fat apply's two kernels cut their work, checked on the CPU.

The float32 apply (``apply_f32.cu``) and its bf16/bf16x3 twin
(``apply_mma.cu``) share one tile plan (``apply.cuh``), chosen by D alone
(``fs.apply_tile``).  Their plans are read here from the CUDA sources, so
these tests hold the sources themselves:

- ``fs.apply_tile`` names the sources' two tiles, switching at
  ``APPLY_LARGE_D``.
- Over D = 1..8192, the grid of tiles and each kernel's threads own every
  output element of F exactly once (the float32 kernel's register tiles;
  the tensor-core kernel's mma fragments and its float4 epilogue), a
  ragged edge included, and 16-byte accesses never cross D.
- Over 2B = 2..1024, the k staging covers every row once: ``2B <= 128`` in
  one pass on the small tile, and the tensor-core kernel's fragments read
  whole 16-byte rows at pitches that keep ldmatrix free of bank conflicts.
- A numpy float32 emulation: the kernel's chain (fmaf over the 2B rows
  from 0, then acc + 0 where 2B % 32 != 0) equals the template's chain
  padded with zero FMAs to whole 32-deep slabs bit for bit, signed zeros
  included.
- The wrappers' launches on a stand-in library: the apply's shape does not
  depend on the replica count K, and K1, K2, K4, K4a and K6 count one
  ``factor_apply`` launch an update.
- BaM's fat apply (``gsmvi_bam_apply``, the float32 kernel with its sums
  of squares) on the same plan: its grid owns every output once over D =
  1..8192 with k = 2(B+1) for B = 1..128 staged once; its chain equals the
  template's padded chain bit for bit at every such k; ``nparts`` in
  ``ops/bam_fused.py`` is its tile count; each tile's pair, as a numpy
  float32 emulation of the kernel's order (each thread's fmaf chain, a
  warp butterfly, the warps in order) forms it, lies within (n - 1) 2^-24
  of the exact sums; the wrapper's launch on a stand-in library; the plain
  version against the JAX package's ``f + t_mm(stack_u, stack_w)`` and
  ``jnp.sum(f_new * f_new)`` (``gsmvi_tpu/ops/pallas/bam_fused.py``
  :319-323).
- ``factor_apply(..., precision="highest")`` on CPU tensors equals
  ``factor_apply_reference`` bit for bit, and the JAX package's
  ``f + t_mm(stack_u, stack_w)`` (``gsmvi_tpu/ops/pallas/fused_step.py``
  :346, ``dot_general`` at ``Precision.HIGHEST``) within float32 sum order:
  4 (2B) 2^-24 |su|^T |sw| + 2^-23 |F'| (the products' sums in either
  order, plus the final add's rounding on each side).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu_torch.ops import bam_fused as bf
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs

CSRC = Path(fs.__file__).resolve().parent / "cuda" / "csrc"
D_BLOCKS = [(lo, lo + 1023) for lo in range(1, 8193, 1024)]


def _source(name):
    return (CSRC / name).read_text()


def _tiles():
    """{"S": (BM, BN), "L": (BM, BN)} from apply.cuh."""
    src = _source("apply.cuh")
    return {key: tuple(int(x) for x in re.search(
        rf"using Apply{key} = ApplyTile<(\d+), (\d+)>;", src).groups())
        for key in ("S", "L")}


def _f32_plans():
    """{tile: (RM, RN, KS)} of apply_f32.cu's launches, and its stages."""
    src = _source("apply_f32.cu")
    tiles = _tiles()
    plans = {tiles[key]: tuple(int(x) for x in re.search(
        rf"launch_f32<Apply{key}, (\d+), (\d+), (\d+)>", src).groups())
        for key in ("S", "L")}
    stages = int(re.search(r"APPLY_STAGES = (\d+);", src).group(1))
    return plans, stages


def _mma_plans():
    """{tile: (WARPS, KS)} of apply_mma.cu's launches."""
    src = _source("apply_mma.cu")
    tiles = _tiles()
    return {tiles[key]: tuple(int(x) for x in re.search(
        rf"launch_mma<Apply{key}, (\d+), (\d+), MODE>", src).groups())
        for key in ("S", "L")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_apply_tile_names_the_sources_tiles():
    tiles = _tiles()
    assert fs.APPLY_TILE_SMALL == tiles["S"]
    assert fs.APPLY_TILE_LARGE == tiles["L"]
    assert fs.apply_tile(1) == fs.apply_tile(256) == tiles["S"]
    assert fs.apply_tile(fs.APPLY_LARGE_D - 1) == tiles["S"]
    assert fs.apply_tile(fs.APPLY_LARGE_D) == fs.apply_tile(8192) == tiles["L"]
    # 128 blocks at the main shape, where the 32x32 template had 64.
    bm, bn = fs.apply_tile(256)
    assert -(-256 // bm) * -(-256 // bn) == 128
    assert set(_f32_plans()[0]) == set(_mma_plans()) == set(tiles.values())


# ---------------------------------------------------------------------------
# Ownership of the outputs
# ---------------------------------------------------------------------------

def _f32_local(tile, rm, rn):
    """Tile-local (rows, columns) each thread of apply_f32_kernel owns:
    thread (tm, tn) takes rows tm RM + r and columns j BN/2 + 4 tn + c."""
    bm, bn = tile
    tm_n, tn_n = bm // rm, bn // rn
    rows = [[tm * rm + r for r in range(rm)] for tm in range(tm_n)]
    cols = [[j * (bn // 2) + 4 * tn + c for j in range(rn // 4)
             for c in range(4)] for tn in range(tn_n)]
    return rows, cols, tm_n * tn_n


def _covered_once(starts, local, d):
    """Global indices start + local (masked below d) each counted once."""
    idx = (np.asarray(starts)[:, None] + np.asarray(local)[None, :]).ravel()
    idx = idx[idx < d]
    return bool((np.bincount(idx, minlength=d) == 1).all())


@pytest.mark.parametrize("lo,hi", D_BLOCKS)
def test_f32_threads_own_every_output_once(lo, hi):
    plans, _ = _f32_plans()
    local = {}
    for tile, (rm, rn, _ks) in plans.items():
        rows, cols, threads = _f32_local(tile, rm, rn)
        assert threads in (64, 128, 256)
        local[tile] = (np.concatenate(rows), np.concatenate(cols))
        # Every thread's 16-byte column group starts on a multiple of 4.
        assert all(c[0] % 4 == 0 for c in cols)
    for d in range(lo, hi + 1):
        bm, bn = fs.apply_tile(d)
        rows, cols = local[(bm, bn)]
        assert _covered_once(range(0, d, bm), rows, d), d
        assert _covered_once(range(0, d, bn), cols, d), d
        assert -(-d // bm) * bm >= d and -(-d // bn) * bn >= d


def _mma_local(tile, warps):
    """Tile-local elements the accumulator fragments of apply_mma_kernel
    cover (lane 4g + t of warp w: rows wm + g and wm + g + 8, columns
    wn + 8j + 2t and + 1), and those its float4 epilogue reads."""
    bm, bn = tile
    wm_n = bm // 16
    wn_n = warps // wm_n
    nt = bn // (8 * wn_n)
    frag = np.zeros((bm, bn), int)
    for w in range(warps):
        wm, wn = (w % wm_n) * 16, (w // wm_n) * 8 * nt
        for j in range(nt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in (wm + g, wm + g + 8):
                    for c in (wn + 8 * j + 2 * t, wn + 8 * j + 2 * t + 1):
                        frag[r, c] += 1
    threads = 32 * warps
    epi = np.zeros((bm, bn), int)
    for e in range(bm * bn // 4 // threads):
        for tid in range(threads):
            c = tid + e * threads
            row, col = c // (bn // 4), (c % (bn // 4)) * 4
            epi[row, col:col + 4] += 1
    return frag, epi


def test_mma_fragments_and_epilogue_own_every_output_once():
    for tile, (warps, _ks) in _mma_plans().items():
        frag, epi = _mma_local(tile, warps)
        assert (frag == 1).all(), tile
        assert (epi == 1).all(), tile


def test_mma_fragment_rows_are_aligned_and_conflict_free():
    """ldmatrix reads eight 16-byte rows a matrix: each row address is
    16-byte aligned, and the eight rows (k, k+1, ..., k+7 at the staged
    pitch, bf16) fall in eight distinct groups of four banks."""
    for (bm, bn), _ in _mma_plans().items():
        for width in (bm, bn):
            pitch = (width + 8) * 2              # bytes, MmaPlan's LA / LB
            assert pitch % 16 == 0
            groups = {(r * pitch // 16) % 8 for r in range(8)}
            assert len(groups) == 8, (width, pitch)
            # Fragment columns start on multiples of 8 bf16 (16 bytes).
            assert width % 8 == 0


@pytest.mark.parametrize("lo,hi", [(2, 128), (130, 256), (258, 512),
                                   (514, 1024)])
def test_k_staging_covers_every_row_once(lo, hi):
    for k2 in range(lo, hi + 1, 2):
        _staging_covers(k2)


def _staging_covers(k2):
    plans, stages = _f32_plans()
    for (bm, bn), (_rm, _rn, ks) in plans.items():
        nslab = -(-k2 // ks)
        rows = [s * ks + kk for s in range(nslab) for kk in range(ks)
                if s * ks + kk < k2]
        assert rows == list(range(k2))
        threads = (bm // _rm) * (bn // _rn)
        for width in (bm, bn):
            chunks = ks * width // 4
            assert chunks % threads == 0
        if (bm, bn) == fs.APPLY_TILE_SMALL and k2 <= 128:
            assert nslab <= stages - 1      # staged in one pass
    for (bm, bn), (warps, ks) in _mma_plans().items():
        assert ks % 16 == 0
        for width in (bm, bn):
            assert (ks * width // 4) % (32 * warps) == 0
        rows = [s * ks + kk for s in range(-(-k2 // ks)) for kk in range(ks)
                if s * ks + kk < k2]
        assert rows == list(range(k2))


# ---------------------------------------------------------------------------
# The chain: the kernel's acc + 0 against the template's zero FMAs
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32 for these inputs: the product is exact in
    float64 and the sums below need no second rounding."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _template_chain(a, b):
    acc = np.float32(0.0)
    k = len(a)
    for kk in range(-(-k // 32) * 32):
        acc = _fma32(a[kk], b[kk], acc) if kk < k else _fma32(0.0, 0.0, acc)
    return acc


def _kernel_chain(a, b):
    acc = np.float32(0.0)
    for kk in range(len(a)):
        acc = _fma32(a[kk], b[kk], acc)
    return np.float32(acc + np.float32(0.0)) if len(a) % 32 else acc


@pytest.mark.parametrize("k2", [2, 4, 30, 32, 34, 64, 66, 128])
def test_kernel_chain_equals_the_templates_padded_chain(k2):
    rng = np.random.default_rng(k2)
    # Dyadic inputs (8 significant bits each): every product and partial
    # sum is exact, so _fma32 is fmaf; the last row's product underflows to
    # -0 in float32 where it is tiny and negative.
    cases = [(np.round(rng.standard_normal(k2) * 16) / 16,
              np.round(rng.standard_normal(k2) * 16) / 16)]
    tiny_a = np.zeros(k2)
    tiny_b = np.zeros(k2)
    tiny_a[-1], tiny_b[-1] = -2.0 ** -80, 2.0 ** -80
    cases.append((tiny_a, tiny_b))
    for a, b in cases:
        want = _template_chain(a, b)
        got = _kernel_chain(a, b)
        assert want.view(np.uint32) == got.view(np.uint32), (k2, want, got)
    # The underflow case ends its k chain at -0: the template's padding
    # (and the kernel's + 0) make it +0 only where 2B % 32 != 0.
    raw = np.float32(0.0)
    for x, y in zip(tiny_a, tiny_b):
        raw = _fma32(x, y, raw)
    assert np.signbit(raw)
    assert np.signbit(_kernel_chain(tiny_a, tiny_b)) == (k2 % 32 == 0)


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

    def size(self, name, *args):
        return 16

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


@pytest.mark.parametrize("b,d", [(1, 1), (32, 256), (64, 767), (3, 768),
                                 (8, 8192)])
def test_apply_launch_shape_does_not_depend_on_replicas(card, b, d):
    shapes = set()
    for k in (None, 3, 8):
        lead = () if k is None else (k,)
        card.calls.clear()
        fs.gsm_eps_update_fused(_z(*lead, b, d), _z(*lead, b, d),
                                _z(*lead, d), _z(*lead, d, d))
        (args,) = card.named("gsmvi_factor_apply")
        assert args[5:8] == (2 * b, d, k or 1)
        shapes.add(args[8:10])
    assert shapes == {fs.apply_tile(d)}
    assert fs.launch_counts()["factor_apply"] == 3


@pytest.mark.parametrize("precision,entry,mode", [
    ("highest", "gsmvi_factor_apply", None),
    ("high", "gsmvi_factor_apply_mma", 2),
    ("bf16", "gsmvi_factor_apply_mma", 1)])
@pytest.mark.parametrize("k", [None, 3])
def test_factor_apply_wrapper_launches_one_kernel(card, precision, entry,
                                                  mode, k):
    lead = () if k is None else (k,)
    d, n = 200, 16
    out = fs.factor_apply(_z(*lead, n, d), _z(*lead, n, d), _z(*lead, d, d),
                          precision=precision)
    assert tuple(out.shape) == (*lead, d, d)
    assert [name for name, _ in card.calls] == [entry]
    (args,) = card.named(entry)
    tail = (n, d, k or 1) + (() if mode is None else (mode,))
    assert args[5:5 + len(tail)] == tail
    assert args[5 + len(tail):7 + len(tail)] == fs.apply_tile(d)
    counts = fs.launch_counts()
    name = ("factor_apply" if mode is None
            else f"factor_apply_{fs.MMA_TAG[precision]}")
    assert counts[name] == 1
    assert sum(counts.values()) == 1


def test_every_eps_route_counts_one_apply_an_update(card):
    b, d, spc, k = 8, 64, 8, 3
    params = (_z(1, d), _z(d, d))
    fs.gsm_eps_update_fused(_z(b, d), _z(b, d), _z(d), _z(d, d),
                            method="chol")
    step = fs.make_fused_eps_step(fs.gaussian_score, 2, b, d,
                                  external_eps=True)
    step(_z(b, d), _z(d), _z(d, d), *params)
    multi = fs.make_fused_eps_multistep(fs.gaussian_score, 2, b, d, spc)
    multi(3, _z(spc * b, d), _z(d), _z(d, d), *params)
    batch = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d, k,
                                               spc)
    batch(2, _z(k, spc * b, d), _z(k, d), _z(k, d, d), *params)
    # K4a 1, K4 1, K2 3 sub-steps, K6 2 sub-steps for all K replicas.
    assert fs.launch_counts()["factor_apply"] == 1 + 1 + 3 + 2
    assert len(card.named("gsmvi_factor_apply")) == 7
    assert not card.named("gsmvi_factor_apply_oracle")


# ---------------------------------------------------------------------------
# The plain version against the JAX package's contraction
# ---------------------------------------------------------------------------

def _jax_apply(su, sw, f):
    """``f + t_mm(stack_u, stack_w)`` as gsmvi_tpu/ops/pallas/fused_step.py
    :279-282/:346 forms it."""
    t_mm = jax.lax.dot_general(jnp.asarray(su), jnp.asarray(sw),
                               (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jnp.asarray(f) + t_mm)


@pytest.mark.parametrize("k2,d", [(64, 256), (16, 200), (2, 33), (4, 1)])
def test_highest_plain_apply_matches_reference_and_jax(k2, d):
    rng = np.random.default_rng(k2 * 1000 + d)
    k = 3
    su = rng.standard_normal((k, k2, d)).astype(np.float32)
    sw = (0.1 * rng.standard_normal((k, k2, d))).astype(np.float32)
    f = rng.standard_normal((k, d, d)).astype(np.float32)
    good = torch.tensor([True, False, True])
    t = [torch.from_numpy(x) for x in (su, sw, f)]
    got = fs.factor_apply(*t, good)
    assert torch.equal(got, fs.factor_apply_reference(*t, good, "highest"))
    assert torch.equal(fs.factor_apply(t[0][0], t[1][0], t[2][0]),
                       fs.factor_apply_reference(t[0][0], t[1][0], t[2][0]))
    u = 2.0 ** -24
    for z in range(k):
        if not good[z]:
            assert torch.equal(got[z], t[2][z])
            continue
        want = _jax_apply(su[z], sw[z], f[z])
        exact = f[z].astype(np.float64) + su[z].T.astype(np.float64) @ sw[z]
        absprod = np.abs(su[z].T).astype(np.float64) @ np.abs(sw[z])
        tol = 4 * k2 * u * absprod + 2 * u * np.abs(exact) + 1e-30
        diff = np.abs(got[z].numpy().astype(np.float64) - want)
        assert (diff <= tol).all(), float((diff - tol).max())


# ---------------------------------------------------------------------------
# BaM's fat apply on the same plan, with its tile sums of squares
# ---------------------------------------------------------------------------

def test_bam_apply_runs_the_f32_plans_with_its_epilogue():
    """``gsmvi_bam_apply`` dispatches the float32 kernel's two plans with
    the sums-of-squares epilogue; the template's BaM epilogue stays only
    behind the oracle entry."""
    src = _source("apply_f32.cu")
    body = src[src.index("int gsmvi_bam_apply("):]
    assert "launch_plan(p, reps, APPLY_SUMSQ, tile_m, tile_n" in body
    gemm = _source("gemm.cu")
    assert "int gsmvi_bam_apply_oracle(" in gemm
    assert "int gsmvi_bam_apply(" not in gemm


@pytest.mark.parametrize("lo,hi", D_BLOCKS)
def test_bam_apply_grid_owns_every_output_once(lo, hi):
    plans, _ = _f32_plans()
    local = {tile: tuple(np.concatenate(x) for x in _f32_local(tile, rm, rn)[:2])
             for tile, (rm, rn, _ks) in plans.items()}
    for d in range(lo, hi + 1):
        bm, bn = fs.apply_tile(d)
        rows, cols = local[(bm, bn)]
        assert _covered_once(range(0, d, bm), rows, d), d
        assert _covered_once(range(0, d, bn), cols, d), d
        assert bf.bam_apply_tiles(d) == -(-d // bm) * -(-d // bn)


@pytest.mark.parametrize("b", range(1, 129))
def test_bam_k_staging_covers_every_row_once(b):
    _staging_covers(2 * (b + 1))


@pytest.mark.parametrize("b", [1, 2, 14, 15, 16, 31, 32, 63, 64, 127, 128])
def test_bam_chain_equals_the_templates_padded_chain(b):
    """At k = 2(B+1) the kernel's chain (fmaf from 0, then acc + 0 where
    k % 32 != 0) equals the template's zero-padded chain bit for bit,
    signed zeros included."""
    test_kernel_chain_equals_the_templates_padded_chain(2 * (b + 1))


@pytest.mark.parametrize("d", [1, 33, 200, 256, 767, 768, 1031])
def test_nparts_is_the_kernels_tile_count(d):
    """The finalize reads ``nparts`` pairs a replica: the grid's tiles."""
    plans, _ = _f32_plans()
    bm, bn = fs.apply_tile(d)
    assert (bm, bn) in plans
    for k in (None, 3):
        buf = bf._BamBuffers(4, d, "cpu", k=k)
        assert buf.nparts == -(-d // bm) * -(-d // bn)
        assert buf.partial.shape == ((() if k is None else (k,))
                                     + (2 * buf.nparts,))


def _kernel_tile_sums(x, tile, rm, rn):
    """A numpy float32 emulation of the kernel's sum of x^2 over one tile:
    thread (tm, tn) chains fmaf over its rows r, column groups j and
    columns c; a warp's 32 sums by the xor butterfly 16, 8, 4, 2, 1; the
    warps' sums added in warp order by thread 0."""
    bm, bn = tile
    tn_n = bn // rn
    threads = (bm // rm) * tn_n
    sums = []
    for tid in range(threads):
        tm, tn = tid // tn_n, tid % tn_n
        s = np.float32(0.0)
        for r in range(rm):
            for j in range(rn // 4):
                for c in range(4):
                    v = x[tm * rm + r, j * (bn // 2) + 4 * tn + c]
                    s = _fma32(v, v, s)
        sums.append(s)
    sums = np.array(sums, np.float32).reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        sums = (sums + sums[:, np.arange(32) ^ o]).astype(np.float32)
    total = sums[0, 0]
    for w in range(1, sums.shape[0]):
        total = np.float32(total + sums[w, 0])
    return total


@pytest.mark.parametrize("d", [256, 768])
def test_bam_tile_sums_are_within_their_bound(d):
    """The kernel's order over a whole tile of values on a dyadic grid
    (exact products) against the float64 sum: within (n - 1) 2^-24 of it,
    the bound chip_smoke.py phase 27 holds the card to; the plain
    version's tile pairs lie row-major, as the kernel's blocks."""
    plans, _ = _f32_plans()
    tile = fs.apply_tile(d)
    rm, rn, _ks = plans[tile]
    rng = np.random.default_rng(d)
    x = (np.round(rng.standard_normal(tile) * 64) / 64).astype(np.float32)
    got = _kernel_tile_sums(x, tile, rm, rn)
    exact = float((x.astype(np.float64) ** 2).sum())
    n = tile[0] * tile[1]
    assert abs(float(got) - exact) <= (n - 1) * 2.0 ** -24 * exact
    # The plain version's pairs: tile t = y ceil(D / tile_n) + x.
    f = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32))
    zero = torch.zeros((2, d))
    f_new, part = bf.bam_apply_reference(zero, zero, f)
    assert torch.equal(f_new, f)
    bm, bn = tile
    nx = -(-d // bn)
    for t in (0, 1, nx, bf.bam_apply_tiles(d) - 1):
        y, x0 = divmod(t, nx)
        block = f[y * bm:(y + 1) * bm, x0 * bn:(x0 + 1) * bn].double()
        want = float((block * block).sum())
        assert part[t, 0].item() == pytest.approx(want, rel=n * 2.0 ** -24)
        assert part[t, 1].item() == pytest.approx(want, rel=n * 2.0 ** -24)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("b,d", [(1, 1), (32, 256), (128, 1031)])
def test_bam_apply_wrapper_launches_one_kernel(monkeypatch, card, b, d, k):
    monkeypatch.setattr(bf, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(bf, "_library", lambda: card)
    monkeypatch.setattr(bf, "_stream", lambda device: None)
    lead = () if k is None else (k,)
    k2 = 2 * (b + 1)
    f_new, part = bf.bam_apply(_z(*lead, k2, d), _z(*lead, k2, d),
                               _z(*lead, d, d))
    assert tuple(f_new.shape) == (*lead, d, d)
    assert tuple(part.shape) == (*lead, bf.bam_apply_tiles(d), 2)
    (args,) = card.named("gsmvi_bam_apply")
    assert [n for n, _ in card.calls] == ["gsmvi_bam_apply"]
    assert args[5].value is None                   # no halt word
    assert args[6:11] == (k2, d, k or 1, *fs.apply_tile(d))
    counts = fs.launch_counts()
    assert counts["bam_apply"] == 1 and sum(counts.values()) == 1


@pytest.mark.parametrize("b,d", [(32, 256), (5, 33), (12, 200)])
def test_bam_plain_apply_matches_jax(b, d):
    """``bam_apply_reference`` on CPU tensors (``bam_apply`` takes it there)
    against the JAX package's ``f + t_mm(stack_u, stack_w)`` at
    Precision.HIGHEST within float32 sum order (4 k 2^-24 |su|^T |sw| +
    2^-23 |F'|), and its tile pairs' totals against ``jnp.sum(f_new *
    f_new)`` and ``jnp.sum(f * f)`` within the two sums' float32 orders
    (D^2 2^-23 of the sum, a safe bound on any float32 order)."""
    rng = np.random.default_rng(b * 1000 + d)
    k2 = 2 * (b + 1)
    su = rng.standard_normal((k2, d)).astype(np.float32)
    sw = (0.1 * rng.standard_normal((k2, d))).astype(np.float32)
    f = rng.standard_normal((d, d)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (su, sw, f)]
    got, part = bf.bam_apply(*t)
    want_f = _jax_apply(su, sw, f)
    u = 2.0 ** -24
    exact = f.astype(np.float64) + su.T.astype(np.float64) @ sw
    absprod = np.abs(su.T).astype(np.float64) @ np.abs(sw)
    tol = 4 * k2 * u * absprod + 2 * u * np.abs(exact) + 1e-30
    assert (np.abs(got.numpy().astype(np.float64) - want_f) <= tol).all()
    jf = jnp.asarray(want_f)
    tr_new = float(jnp.sum(jf * jf))
    fnorm = float(jnp.sum(jnp.asarray(f) * jnp.asarray(f)))
    sums = part.double().sum(0)
    assert abs(float(sums[1]) - fnorm) <= d * d * 2 * u * fnorm
    assert abs(float(sums[0]) - tr_new) <= d * d * 2 * u * tr_new + float(
        2 * (np.abs(want_f) * tol).sum())
