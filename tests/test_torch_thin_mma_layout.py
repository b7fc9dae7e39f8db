"""How the tensor-core thin product (``thin_mma.cu``) cuts its work, checked
on the CPU.

The kernel's plans are read here from the CUDA source, so these tests hold
the source itself:

- ``fs.thin_mma_tile`` names the source's two plans, switching at
  ``THIN_MMA_LARGE_D``, by D alone.
- Over M = 1..512 and D = 1..1024 (and the D range's top), the grid of
  output tiles covers every output element once; each block's W warps
  take the KC-deep k chunks w, w + W, ... and their 16-deep steps cover
  every k of [0, D) once; every warp's mma fragments cover its tile once,
  and the float4 epilogue reads and writes it once.
- The k partition and the order of the warps' partial sums are a function
  of D alone: the launches on a stand-in library pass the same plan for
  every M and every replica count K.
- Each lane's staged float4s cover a chunk of A and B once, 16-byte loads
  never cross D, and the ldmatrix rows are 16-byte aligned at pitches that
  put the eight rows of a matrix in eight distinct bank groups; the staging
  fits in the 48 KiB of static shared memory at both precisions.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs

CSRC = Path(fs.__file__).resolve().parent / "cuda" / "csrc"


def _source():
    return (CSRC / "thin_mma.cu").read_text()


def _plans():
    """{"S": (BM, BN, KC, W), "L": (BM, BN, KC, W)} of thin_mma.cu."""
    src = _source()
    return {key: tuple(int(x) for x in re.search(
        rf"using Thin{key} = ThinMmaPlan<(\d+), (\d+), (\d+), (\d+)>;",
        src).groups()) for key in ("S", "L")}


def _plan(d):
    """The source's plan that ``fs.thin_mma_tile(d)`` names."""
    tile = fs.thin_mma_tile(d)
    (plan,) = [p for p in _plans().values() if p[:2] == tile]
    return plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_thin_mma_tile_names_the_sources_plans():
    plans = _plans()
    assert fs.THIN_MMA_TILE_SMALL == plans["S"][:2]
    assert fs.THIN_MMA_TILE_LARGE == plans["L"][:2]
    assert fs.thin_mma_tile(1) == fs.thin_mma_tile(256) == plans["S"][:2]
    assert fs.thin_mma_tile(fs.THIN_MMA_LARGE_D - 1) == plans["S"][:2]
    assert (fs.thin_mma_tile(fs.THIN_MMA_LARGE_D)
            == fs.thin_mma_tile(fs.KERNEL_DIM_RANGE[1]) == plans["L"][:2])
    # 32 blocks at the main shape, where the split-k kernel ran 64 blocks
    # of a cluster of 8 with one 32-deep slab each.
    bm, bn = fs.thin_mma_tile(256)
    assert -(-32 // bm) * -(-256 // bn) == 32
    # At D = 256 each of ThinS's warps sums one chunk.
    _bm, _bn, kc, w = plans["S"]
    assert -(-256 // kc) == w


# ---------------------------------------------------------------------------
# Coverage of the outputs and of k
# ---------------------------------------------------------------------------

def _k_owned(d, kc, warps):
    """The k each warp sums, in its order: chunks w, w + warps, ... of kc,
    16-deep steps up to the chunk's last k below d (the kernel's loop and
    compute's break), each step's 16 k."""
    nchunk = -(-d // kc)
    out = []
    for w in range(warps):
        ks = []
        for c in range(w, nchunk, warps):
            kn = min(kc, d - c * kc)
            for kb in range(0, kc, 16):
                if kb >= kn:
                    break
                ks.extend(c * kc + kb + i for i in range(16))
        out.append(ks)
    return out


@pytest.mark.parametrize("lo,hi", [(1, 256), (257, 512), (513, 768),
                                   (769, 1024)])
def test_every_k_is_summed_once_by_one_warp(lo, hi):
    for d in range(lo, hi + 1):
        _bm, _bn, kc, warps = _plan(d)
        owned = _k_owned(d, kc, warps)
        flat = [k for ks in owned for k in ks]
        inside = sorted(k for k in flat if k < d)
        assert inside == list(range(d)), d
        # Past D a step reads only the zeros staged there, and no step
        # starts past D.
        assert all(k < -(-d // 16) * 16 for k in flat), d
        for ks in owned:
            assert ks == sorted(ks)


def test_the_top_of_the_d_range_is_covered():
    for d in (fs.KERNEL_DIM_RANGE[1] - 1, fs.KERNEL_DIM_RANGE[1]):
        _bm, _bn, kc, warps = _plan(d)
        flat = sorted(k for ks in _k_owned(d, kc, warps) for k in ks
                      if k < d)
        assert flat == list(range(d))


def _covered_once(starts, extent, n):
    idx = (np.asarray(starts)[:, None] + np.arange(extent)[None, :]).ravel()
    idx = idx[idx < n]
    return bool((np.bincount(idx, minlength=n) == 1).all())


@pytest.mark.parametrize("lo,hi", [(1, 256), (257, 768), (769, 1024)])
def test_the_grid_owns_every_output_once(lo, hi):
    for d in range(lo, hi + 1):
        bm, bn = fs.thin_mma_tile(d)
        assert _covered_once(range(0, d, bn), bn, d), d
    for m in range(1, 513):
        for d in (lo, hi):
            bm, _bn = fs.thin_mma_tile(d)
            assert _covered_once(range(0, m, bm), bm, m), (m, d)


@pytest.mark.parametrize("key", ["S", "L"])
def test_fragments_and_epilogue_own_the_tile_once(key):
    """A warp's accumulators (MT x NT mma tiles; lane 4g + t: rows g, g + 8
    and columns 2t, 2t + 1 of each) cover its whole tile, as every warp's
    do (each over its own k); the epilogue's float4s (thread e: row
    e / (BN/4), columns 4 (e % (BN/4)) + 0..3) cover it once."""
    bm, bn, _kc, _w = _plans()[key]
    frag = np.zeros((bm, bn), int)
    for mt in range(bm // 16):
        for j in range(bn // 8):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in (16 * mt + g, 16 * mt + g + 8):
                    for c in (8 * j + 2 * t, 8 * j + 2 * t + 1):
                        frag[r, c] += 1
    assert (frag == 1).all()
    epi = np.zeros((bm, bn), int)
    for e in range(bm * bn // 4):
        row, col = e // (bn // 4), (e % (bn // 4)) * 4
        epi[row, col:col + 4] += 1
    assert (epi == 1).all()
    assert bn % 16 == 0      # two 8-column tiles an ldmatrix x4


# ---------------------------------------------------------------------------
# Staging and the shared-memory layout
# ---------------------------------------------------------------------------

def _layout(plan):
    bm, bn, kc = plan[:3]
    lk, ln = kc + 8, bn + 8
    a_el = bm * lk
    b_el = max(bn * lk, kc * ln)
    return lk, ln, a_el, b_el


@pytest.mark.parametrize("key", ["S", "L"])
def test_each_lane_stages_a_chunk_once(key):
    bm, bn, kc, _w = _plans()[key]
    lk, ln, a_el, b_el = _layout((bm, bn, kc))
    ca, cb = bm * kc // 4 // 32, bn * kc // 4 // 32
    assert ca * 128 == bm * kc and cb * 128 == bn * kc
    for trans in (False, True):
        seen_a, seen_b, dst = set(), set(), set()
        for lane in range(32):
            for i in range(ca):
                q = lane + 32 * i
                r, k = q // (kc // 4), (q % (kc // 4)) * 4
                seen_a.add((r, k))
                dst.add(r * lk + k)
            for i in range(cb):
                q = lane + 32 * i
                if trans:     # F's rows n, k contiguous
                    r, k = q // (kc // 4), (q % (kc // 4)) * 4
                    seen_b.add((r, k))
                    dst.add(a_el + r * lk + k)
                else:         # F's rows k, n contiguous
                    r, n = q // (bn // 4), (q % (bn // 4)) * 4
                    seen_b.add((r, n))
                    dst.add(a_el + r * ln + n)
        assert seen_a == {(r, k) for r in range(bm) for k in range(0, kc, 4)}
        want_b = ({(r, k) for r in range(bn) for k in range(0, kc, 4)}
                  if trans else
                  {(r, n) for r in range(kc) for n in range(0, bn, 4)})
        assert seen_b == want_b
        assert len(dst) == ca * 32 + cb * 32       # no two lanes collide
        assert max(dst) + 4 <= a_el + b_el
        assert all(o % 4 == 0 for o in dst)        # 8-byte bf16 stores
    # 16-byte loads start on a multiple of 4 along the row: with D % 4 == 0
    # a float4 lies wholly inside or outside D.
    assert kc % 4 == 0 and bn % 4 == 0 and bm % 4 == 0


def _groups(byte_rows):
    return {(b // 16) % 8 for b in byte_rows}


@pytest.mark.parametrize("key", ["S", "L"])
def test_ldmatrix_rows_are_aligned_and_conflict_free(key):
    """The eight row addresses each 8x8 matrix of an ldmatrix reads, as the
    kernel forms them from the lane, are 16-byte aligned and fall in eight
    distinct groups of four banks, for A, B of rows @ F^T (plain) and B of
    rows @ F (.trans)."""
    bm, bn, kc, _w = _plans()[key]
    lk, ln, a_el, _b_el = _layout((bm, bn, kc))
    for kb in range(0, kc, 16):
        for mt in range(bm // 16):
            addr = [2 * ((16 * mt + (lane & 15)) * lk + kb
                         + ((lane >> 4) << 3)) for lane in range(32)]
            for q in range(4):
                rows = addr[8 * q:8 * q + 8]
                assert all(a % 16 == 0 for a in rows)
                assert len(_groups(rows)) == 8
        for j in range(0, bn // 8, 2):
            tb = [2 * (a_el + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * lk
                       + kb + (((lane >> 3) & 1) << 3)) for lane in range(32)]
            nb = [2 * (a_el + (kb + (lane & 15)) * ln + 8 * j
                       + ((lane >> 4) << 3)) for lane in range(32)]
            for addr in (tb, nb):
                for q in range(4):
                    rows = addr[8 * q:8 * q + 8]
                    assert all(a % 16 == 0 for a in rows)
                    assert len(_groups(rows)) == 8
    # Each warp's region starts on a 16-byte boundary at both precisions.
    for parts in (1, 2):
        assert (parts * (a_el + _layout((bm, bn, kc))[3]) * 2) % 16 == 0
    assert (a_el * 2) % 16 == 0


@pytest.mark.parametrize("key", ["S", "L"])
def test_shared_memory_fits_a_static_block(key):
    bm, bn, kc, warps = _plans()[key]
    _lk, _ln, a_el, b_el = _layout((bm, bn, kc))
    partial = warps * bm * (bn + 8) * 4
    for parts in (1, 2):
        oper = warps * parts * (a_el + b_el) * 2
        assert max(oper, partial) <= 48 * 1024


# ---------------------------------------------------------------------------
# The launches, on a stand-in library
# ---------------------------------------------------------------------------

class _Recorder:
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


@pytest.mark.parametrize("precision,mode", [("bf16", 1), ("high", 2)])
@pytest.mark.parametrize("d", [1, 33, 256, 767, 768, 1031, 8192])
def test_the_plan_is_a_function_of_d_alone(card, precision, mode, d):
    plans = set()
    for m in (1, 17, 32, 512):
        for k in (None, 3):
            lead = () if k is None else (k,)
            card.calls.clear()
            fs.thin_product(_z(*lead, m, d), _z(*lead, d, d), trans=True,
                            precision=precision)
            (args,) = card.named("gsmvi_thin_rows_mma")
            assert args[5:9] == (m, d, 1, k or 1)
            plans.add(args[10:13])
    assert plans == {(*fs.thin_mma_tile(d), mode)}


def test_k6_replica_rows_take_the_single_plan(card):
    """K6's sub-step at "high": its three row products run the plan of a
    single launch, on K replicas in one launch each."""
    b, d, spc, k = 8, 200, 8, 3
    params = (_z(1, d), _z(d, d))
    batch = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d, k,
                                               spc, precision="high")
    batch(1, _z(k, spc * b, d), _z(k, d), _z(k, d, d), *params)
    launches = card.named("gsmvi_thin_rows_mma")
    assert len(launches) == 3
    assert {a[8] for a in launches} == {k}
    assert {a[10:12] for a in launches} == {fs.thin_mma_tile(d)}


def test_the_tensor_core_product_takes_no_halt_word(card):
    halt = torch.zeros(1)
    with pytest.raises(ValueError, match="halt"):
        fs._thin(card, None, _z(4, 16), _z(16, 16), _z(4, 16), trans=True,
                 halt=halt, precision="bf16")
    assert not card.calls
    assert fs.launch_counts()["thin_product_bf16"] == 0
