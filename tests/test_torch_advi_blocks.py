"""K9/K10 as blocks on persistent buffers, checked on the CPU.

- (a) The triangular tiles of ``advi.cu`` (``_tri_layout``, ``_tri_tile``,
  ``_tri_rank_slabs`` mirror its launch plan): over D 1-8192 every lower
  32x32 tile of a (D, D)
  output is covered once, none lies above the diagonal, each walks the k
  range [first column, last row]; the kernel's float32 decode of a tile
  index is exact up to D=8192; a tile's slabs split over its cluster by
  slab alone.
- (b) A numpy float32 emulation of the triangular products' sum order: on
  random lower-triangular L and A the k-restricted tiles give the bits of
  the full product summed in the same order (zeros' sign aside), and the
  first-residual gate still reads nonfinite with an inf or NaN in the lower
  part of either operand.
- (c) Every state ``fit_fused`` makes (analytic, STL, a stiff replay, each
  lift) has exact zeros above the diagonal in L and the tracked inverse.
- (d) ``AdviBlocks`` on a stand-in kernel library and a stand-in capture:
  a full block captures once and replays after, remainders run eagerly,
  the launch counts equal the eager path's; the device scalar table holds
  ``lr_bias_arrays``' values for a float and a callable learning rate;
  the runner's in-place draws equal ``torch.randn``'s; a returned state is
  a copy that later blocks never write.
- (e) The CPU ``fit_fused`` on the chained runner matches the JAX package's
  ``fit_fused`` on the same draws across chunk boundaries, to
  ``tests/test_torch_advi_fit.py``'s tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.advi as j_advi
import gsmvi_tpu_torch.advi as t_advi
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu_torch import ADVI
from gsmvi_tpu_torch.driver import step_seed
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays
from gsmvi_tpu_torch.ops import advi_fused as af
from gsmvi_tpu_torch.ops import fused_step as fs

DEV = "cpu"
FUSED_TOL = 1e-4          # tests/test_torch_advi_fit.py's fit_fused bound


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make fit_fused take its kernel route on the CPU."""
    monkeypatch.setattr(t_advi, "on_gpu", lambda device: True)


# ---------------------------------------------------------------------------
# (a) the layout of the triangular tiles
# ---------------------------------------------------------------------------

def _tri_tiles(d: int) -> int:
    """T = ceil(D / 32): the tiles along each side of a (D, D) output."""
    return -(-d // 32)


def _tri_count(d: int) -> int:
    """The lower tiles of a (D, D) output, T (T + 1) / 2."""
    t = _tri_tiles(d)
    return t * (t + 1) // 2


def _tri_tile(t: int) -> tuple:
    """(I, J), J <= I, of lower tile t in the launch order t = I (I + 1) / 2
    + J, as advi.cu's ``tri_tile`` decodes it: a float32 square root, then
    exact integer corrections."""
    i = int((np.sqrt(np.float32(8 * t + 1), dtype=np.float32)
             - np.float32(1.0)) * np.float32(0.5))
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


def _tri_split(d: int) -> int:
    """S = min(8, T): the blocks of one tile's cluster in the triangular
    products (advi.cu's ``tri_split``), a function of D alone."""
    return min(8, _tri_tiles(d))


def _tri_layout(d: int) -> list:
    """[(I, J, k0, k1)] of every lower tile in launch order, with the k
    range [k0, k1) it walks: from the tile's first column to its last row,
    ``[32 J, min(D, 32 (I + 1)))``, the only k where a lower-triangular
    left operand's row and right operand's column are both nonzero."""
    out = []
    for t in range(_tri_count(d)):
        i, j = _tri_tile(t)
        out.append((i, j, 32 * j, min(d, 32 * (i + 1))))
    return out


def _tri_rank_slabs(d: int, i: int, j: int, rank: int) -> list:
    """The 32-wide k slabs that rank ``rank`` of tile (I, J)'s cluster adds,
    ascending: slabs s in [J, I] with s % S == rank."""
    return [s for s in range(j, i + 1) if s % _tri_split(d) == rank]


LAYOUT_DIMS = sorted(set(range(1, 300)) | {511, 512, 513, 1000, 1024, 2047,
                                           2048, 4095, 4096, 8191, 8192})


@pytest.mark.parametrize("chunk", range(4))
def test_lower_tiles_cover_the_triangle_once(chunk):
    for d in LAYOUT_DIMS[chunk::4]:
        t = _tri_tiles(d)
        tiles = _tri_layout(d)
        assert len(tiles) == _tri_count(d) == t * (t + 1) // 2
        assert len({(i, j) for i, j, _, _ in tiles}) == len(tiles)
        for i, j, k0, k1 in tiles:
            assert 0 <= j <= i < t                     # never above the diagonal
            assert k0 == 32 * j                        # the tile's first column
            assert k1 == min(d, 32 * (i + 1))          # past its last row
        # Every lower element (r, c), c <= r, lies in exactly one tile.
        if d <= 300:
            cover = np.zeros((d, d), np.int64)
            for i, j, _, _ in tiles:
                cover[32 * i:32 * (i + 1), 32 * j:32 * (j + 1)] += 1
            assert np.array_equal(np.tril(cover), np.tril(np.ones((d, d))))


def test_tile_index_decode_is_exact_to_8192():
    """advi.cu's float32 square-root decode of tile t, with its integer
    corrections, inverts t = I (I + 1) / 2 + J for every tile up to
    D=8192."""
    t = _tri_tiles(8192)
    want = [(i, j) for i in range(t) for j in range(i + 1)]
    assert [_tri_tile(k) for k in range(len(want))] == want
    # The raw float32 estimate is never more than one row off.
    for k in range(len(want)):
        est = int((np.sqrt(np.float32(8 * k + 1), dtype=np.float32)
                   - np.float32(1.0)) * np.float32(0.5))
        assert abs(est - want[k][0]) <= 1


@pytest.mark.parametrize("d", [1, 31, 33, 200, 256, 257, 1024, 8192])
def test_rank_slabs_split_each_tile_by_slab_alone(d):
    split = _tri_split(d)
    assert split == min(8, _tri_tiles(d))
    for i, j, k0, k1 in _tri_layout(d)[::max(1, _tri_count(d) // 500)]:
        got = [_tri_rank_slabs(d, i, j, r) for r in range(split)]
        flat = sorted(s for ss in got for s in ss)
        assert flat == list(range(j, i + 1))
        assert all(s % split == r for r, ss in enumerate(got) for s in ss)
        assert all(ss == sorted(ss) for ss in got)
        assert flat[0] * 32 == k0 and min(d, (flat[-1] + 1) * 32) == k1


# ---------------------------------------------------------------------------
# (b) the sum order of the triangular products, emulated in float32
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """float32(a b + c) with the exact product (float64 holds it)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _tri_product(a, b, restricted: bool):
    """advi.cu's tile sums of a @ b: rank r of a tile's cluster adds the
    slabs s with s % S == r, ascending, k ascending inside each slab, one
    fused multiply-add each; then the S partials are added in rank order.
    ``restricted``: only the tile's slabs [J, I], as the kernel walks them;
    else every slab, as a whole product split the same way would."""
    d = a.shape[0]
    split = _tri_split(d)
    tile = np.arange(d) // 32
    parts = [np.zeros((d, d), np.float32) for _ in range(split)]
    for k in range(d):
        s = k // 32
        term = _fma32(a[:, k, None], b[None, k, :], parts[s % split])
        if restricted:
            keep = (s >= tile[None, :]) & (s <= tile[:, None])
            term = np.where(keep, term, parts[s % split])
        parts[s % split] = term
    out = np.zeros((d, d), np.float32)
    for p in parts:
        out = out + p
    return out


def _lower(rng, d, scale):
    m = np.tril(scale * rng.standard_normal((d, d)))
    return (m + np.eye(d)).astype(np.float32)


def _warp_sum(v):
    """The epilogue's butterfly sum over a tile row's 32 lanes (lane 0's)."""
    v = np.asarray(v, np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def _gate(r):
    """r_norm as the residual launch forms it: per row and 32-column tile
    the butterfly sum of |R| (zero past D), the row's tiles added in tile
    order, then the max over rows; nan when a row sum is not finite."""
    d = r.shape[0]
    t = _tri_tiles(d)
    pad = np.zeros((d, 32 * t), np.float32)
    pad[:, :d] = np.abs(r)
    worst = np.float32(0.0)
    for i in range(d):
        rs = np.float32(0.0)
        for q in range(i // 32 + 1):
            rs = np.float32(rs + _warp_sum(pad[i, 32 * q:32 * (q + 1)]))
        if not np.isfinite(rs):
            return np.float32(np.nan)
        worst = max(worst, rs)
    return worst


@pytest.mark.parametrize("d", [40, 96, 130])
def test_restricted_tiles_equal_the_full_product(d):
    """R = I - L A and A + A R: the lower triangle of the k-restricted sums
    equals the full product's in the same order, bit for bit (a zero's
    sign aside), and both are lower triangular."""
    rng = np.random.default_rng(d)
    l = _lower(rng, d, 0.05)
    a = np.tril(np.linalg.inv(l.astype(np.float64))).astype(np.float32)
    eye = np.eye(d, dtype=np.float32)
    lower = np.tril(np.ones((d, d), bool))
    full = _tri_product(l, a, restricted=False)
    part = _tri_product(l, a, restricted=True)
    assert np.array_equal(full[lower], part[lower])
    assert np.all(full[~lower] == 0)            # the skipped sums are zeros
    r = np.where(lower, eye - part, np.float32(0.0))
    sweep_full = _tri_product(a, r, restricted=False)
    sweep_part = _tri_product(a, r, restricted=True)
    assert np.array_equal(sweep_full[lower], sweep_part[lower])
    # The gate on the lower triangle reads what it reads on the whole.
    assert _gate(np.where(lower, eye - part, 0)) == _gate(eye - full)
    # The restricted tiles also agree with float64.
    np.testing.assert_allclose(part[lower], (l.astype(np.float64) @ a)[lower],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("where,value", [
    ("l_below", np.inf), ("l_diag", -np.inf), ("l_below", np.nan),
    ("a_below", np.inf), ("a_diag", np.nan), ("a_last_row", -np.inf)])
def test_gate_reads_nonfinite_operands(where, value):
    """An inf or NaN anywhere in the lower part of L or A makes some row sum
    of |I - L A| nonfinite on the restricted tiles, so the gate trips."""
    d = 70
    rng = np.random.default_rng(1)
    l = _lower(rng, d, 0.05)
    a = np.tril(np.linalg.inv(l.astype(np.float64))).astype(np.float32)
    spot = {"l_below": ("l", 50, 3), "l_diag": ("l", 33, 33),
            "a_below": ("a", 40, 2), "a_diag": ("a", 5, 5),
            "a_last_row": ("a", d - 1, 0)}[where]
    (l if spot[0] == "l" else a)[spot[1], spot[2]] = value
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.eye(d, dtype=np.float32) - _tri_product(l, a, restricted=True)
        r = np.where(np.tril(np.ones((d, d), bool)), r, np.float32(0.0))
        assert np.isnan(_gate(r))


# ---------------------------------------------------------------------------
# (c) every state the fitter hands the kernels is lower triangular
# ---------------------------------------------------------------------------

def _strictly_upper_zero(*mats):
    return all(bool((torch.triu(m, 1) == 0).all()) for m in mats)


def test_fit_states_are_lower_triangular(kernel_paths):
    d, b, spc = 16, 8, 4
    t = dense_gaussian(2, d, scale=0.5, device=DEV)
    g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=spc,
             device=DEV)
    start = g._lift(t_advi._fused_state(
        *g._start(None, None, torch.float32), 0, 0), stl=True)
    assert _strictly_upper_zero(start.l, start.ainv)
    bulk, _ = g.fit_fused(0, learning_rate=2e-2, niter=20, batch_size=b,
                          verbose=False, return_state=True)
    assert _strictly_upper_zero(bulk.l, bulk.ml, bulk.vl)
    lifted = g._lift(bulk, stl=True)
    assert _strictly_upper_zero(lifted.l, lifted.ainv)
    # A small start and a large rate trip the gate: stiff replays.
    stl, _ = g.fit_fused(1, learning_rate=0.05, niter=30, batch_size=b,
                         verbose=False, return_state=True, estimator="stl",
                         cov=0.3 * np.eye(d, dtype=np.float32))
    assert g.fit_counts["replays"] >= 1
    assert _strictly_upper_zero(stl.l, stl.ainv, stl.ml, stl.vl)
    back = g._lift(stl, stl=False)
    assert _strictly_upper_zero(back.l)
    assert _strictly_upper_zero(g._exact_ainv(stl.l))
    xs, _ = g.fit(1, t_advi.Adam(2e-2), niter=5, batch_size=b,
                  verbose=False, return_state=True)
    for stl_lift in (False, True):
        st = g._lift(xs, stl=stl_lift)
        assert _strictly_upper_zero(st.l, *(
            [st.ainv] if stl_lift else []))


# ---------------------------------------------------------------------------
# (d) the block machinery on a stand-in library and a stand-in capture
# ---------------------------------------------------------------------------

class _Card:
    """Stands in for the kernel library (records each launch) and for the
    CUDA graph capture (runs the body once, recording its launches as
    captured; a replay records nothing)."""

    def __init__(self):
        self.calls, self.captured, self.replays = [], [], 0

    def call(self, name, *args):
        self.calls.append(name)

    def capture(self, body):
        start = len(self.calls)
        body()
        self.captured.append(self.calls[start:])
        del self.calls[start:]
        card = self

        class Graph:
            def replay(self):
                card.replays += 1

        return Graph()


@pytest.fixture
def card(monkeypatch):
    rec = _Card()
    for mod in (fs, af):
        monkeypatch.setattr(mod, "_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "_library", lambda: rec)
        monkeypatch.setattr(mod, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_capture_graph", rec.capture)
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


K9_SUB = ["gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_advi_update"]
K10_SUB = ["gsmvi_advi_residual", "gsmvi_advi_sweep", "gsmvi_advi_residual",
           "gsmvi_advi_sweep", "gsmvi_advi_rows", "gsmvi_thin_score",
           "gsmvi_advi_rows", "gsmvi_advi_stl_grad", "gsmvi_advi_stl_apply"]


def _blocks(stl, b=4, d=16, spc=8):
    make = (af.make_fused_advi_stl_multistep if stl
            else af.make_fused_advi_multistep)
    step = make(fs.gaussian_score, 2, b, d, spc)
    params = (torch.zeros((1, d)), torch.eye(d))
    state = [torch.zeros(d), torch.eye(d)] + ([torch.eye(d)] if stl else [])
    state += [torch.zeros(d), torch.zeros(d), torch.zeros((d, d)),
              torch.zeros((d, d))]
    return step, params, state, torch.zeros((spc * b, d))


@pytest.mark.parametrize("stl", [False, True])
def test_full_blocks_capture_once_then_replay(card, stl):
    spc = 8
    step, params, state, block = _blocks(stl, spc=spc)
    lrs, ones = [1e-3] * spc, [1.0] * spc
    for _ in range(3):
        step(lrs, ones, ones, spc, block, *state, *params)
    sub = K10_SUB if stl else K9_SUB
    # The first block ran eagerly and captured; the next two only replayed.
    assert card.calls == sub * spc
    assert card.captured == [sub * spc] and card.replays == 2
    graph_counts = fs.launch_counts()
    fs.reset_launch_counts()
    card.calls.clear()
    for _ in range(3):
        step(lrs, ones, ones, spc, block, *state, *params, graph=False)
    assert card.calls == sub * spc * 3 and card.replays == 2
    assert fs.launch_counts() == graph_counts
    name = ("make_fused_advi_stl_multistep" if stl
            else "make_fused_advi_multistep")
    assert graph_counts[name] == 3
    assert graph_counts["gaussian_score"] == 3 * spc
    assert graph_counts["thin_product"] == (0 if stl else 3 * spc)
    # At most 3 (K9) and 9 (K10 at two sweeps) launches a sub-step.
    assert len(sub) == (9 if stl else 3)


@pytest.mark.parametrize("stl", [False, True])
def test_remainder_blocks_run_eagerly(card, stl):
    step, params, state, block = _blocks(stl)
    ones = [1.0] * 8
    for nmax in (0, 1, 5, 7):
        step([1e-3] * 8, ones, ones, nmax, block, *state, *params)
    sub = K10_SUB if stl else K9_SUB
    assert card.captured == [] and card.replays == 0
    assert card.calls == sub * (1 + 5 + 7)
    name = ("make_fused_advi_stl_multistep" if stl
            else "make_fused_advi_multistep")
    assert fs.launch_counts()[name] == 3


def _lr_schedule(s):
    return 2e-2 * torch.exp(-s.to(torch.float32) / 50.0)


@pytest.mark.parametrize("lr", [1e-2, _lr_schedule],
                         ids=["float", "callable"])
@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_runner_fills_the_scalar_table_and_draws_in_place(
        card, kernel_paths, monkeypatch, lr, estimator):
    """On the runner's card path every block's device table holds the
    ``lr_bias_arrays`` values of its absolute steps, and its eps block
    the ``torch.randn`` draws of those steps; the fit's blocks chain with
    one copy in and out per chunk."""
    d, b, spc, niter = 16, 4, 8, 20
    t = dense_gaussian(2, d, scale=0.5, device=DEV)
    g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=spc,
             device=DEV)
    tables = []
    fill = af._ScalarTable.fill

    def record(self, rows):
        fill(self, rows)
        tables.append(self.table.clone())

    monkeypatch.setattr(af._ScalarTable, "fill", record)
    if estimator == "stl":
        # The stand-in never writes the report: every block is consumed
        # whole, as the stand-in report says (n_done = nmax).
        def packed_report(self):
            rep = torch.zeros(af.REP_SIZE)
            rep[af.REP_NDONE] = float(self._nmax)
            return rep
        monkeypatch.setattr(af.AdviBlocks, "report", packed_report)
        run = af.AdviBlocks.run

        def run_and_note(self, *args, **kw):
            self._nmax = int(args[3])
            return run(self, *args, **kw)
        monkeypatch.setattr(af.AdviBlocks, "run", run_and_note)
    st, _ = g.fit_fused(5, learning_rate=lr, niter=niter, batch_size=b,
                        verbose=False, return_state=True,
                        estimator=estimator)
    assert st.step == niter + 1
    blocks = -(-(niter + 1) // spc)
    assert len(tables) == blocks == g.fit_counts["kernel_calls"]
    lr_fn = lr if callable(lr) else (lambda s: lr)
    for i, table in enumerate(tables):
        want = af.lr_bias_arrays(lr_fn, 0.9, 0.999,
                                 torch.arange(i * spc, (i + 1) * spc,
                                              dtype=torch.int32))
        assert torch.equal(table, torch.stack(want))
    runner = g._fused_runner(b, lr, 0.9, 0.999, 1e-8, estimator)
    eps = runner.blocks.eps_block(DEV)
    last = blocks - 1
    for j in range((niter + 1) - last * spc):
        gen = torch.Generator().manual_seed(step_seed(5, last * spc + j))
        assert torch.equal(eps[j * b:(j + 1) * b],
                           torch.randn((b, d), generator=gen))


@pytest.mark.parametrize("stl", [False, True])
def test_returned_states_are_copies(card, stl):
    step, params, state, block = _blocks(stl, spc=2)
    ones = [1.0] * 2
    outs = [step([1e-3] * 2, ones, ones, 2, block, *state, *params)
            for _ in range(2)]
    bufs = step._bufs[torch.device(DEV)]
    for out in outs:
        for got, work in zip(out, bufs.state):
            assert got.data_ptr() != work.data_ptr()
    assert outs[0][1].data_ptr() != outs[1][1].data_ptr()
    assert step.eps_block(DEV) is bufs.eps


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_a_held_state_is_never_written(kernel_paths, estimator):
    """A state returned by one fit_fused call keeps its values after the
    same fitter (and its blocks' working state) runs on."""
    d = 16
    t = dense_gaussian(4, d, scale=0.5, device=DEV)
    g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=4,
             device=DEV)
    s1, _ = g.fit_fused(0, learning_rate=1e-2, niter=9, batch_size=8,
                        verbose=False, return_state=True, estimator=estimator)
    held = [x.clone() for x in s1[:-2]]
    s2, _ = g.fit_fused(0, learning_rate=1e-2, niter=9, batch_size=8,
                        verbose=False, return_state=True, state=s1,
                        estimator=estimator)
    g.fit_fused(3, learning_rate=1e-2, niter=12, batch_size=8, verbose=False,
                estimator=estimator)
    for x, h in zip(s1[:-2], held):
        assert torch.equal(x, h)
    assert not torch.equal(s2.loc, s1.loc)


# ---------------------------------------------------------------------------
# (e) the chained runner against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_chained_fit_fused_matches_jax(monkeypatch, kernel_paths, estimator):
    """Chunks of 7 steps (a monitor's cadence) over blocks of spc=4, so
    chunks start and end inside blocks and each copies its state in and
    out: the port's fit_fused on JAX's fold_in draws against JAX's
    fit_fused (interpret mode), stiff replays included for STL."""
    d, b, spc, niter = 16, 8, 4, 27
    rng = np.random.default_rng(9)
    a = rng.standard_normal((d, d))
    cov = (0.6 * np.eye(d) + 0.3 * a @ a.T / d).astype(np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov, device=DEV)
    stl = estimator == "stl"
    lr = 0.05 if stl else 2e-2
    cov0 = 0.3 * np.eye(d, dtype=np.float32)
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(j_advi, "on_tpu", lambda: True)
    gj = j_advi.ADVI(D=d, lp=tj.lp, pallas_score=tj.pallas_score,
                     steps_per_call=spc)
    gj._interpret = True
    sj, _ = gj.fit_fused(key, learning_rate=lr, niter=niter, batch_size=b,
                         verbose=False, cov=jnp.asarray(cov0),
                         return_state=True, estimator=estimator)
    draw = lambda s: jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                       jnp.float32)
    draws = np.asarray(jax.vmap(draw)(jnp.arange(niter + 1 + spc)))

    class Monitor:
        checkpoint = 7

        def __call__(self, *args, **kw):
            pass

    gt = ADVI(d, tt.lp, fused_score=tt.fused_score, steps_per_call=spc,
              device=DEV)
    gt._eps = lambda seed, step, batch, dd, dtype: torch.tensor(
        draws[step], dtype=dtype)
    st, _ = gt.fit_fused(0, learning_rate=lr, niter=niter, batch_size=b,
                         verbose=False, cov=cov0, return_state=True,
                         estimator=estimator, monitor=Monitor())
    if stl:
        assert gt.fit_counts["replays"] >= 1
    assert st.step == int(sj.step) == niter + 1
    for name in st._fields[:-2]:
        want = np.asarray(getattr(sj, name), np.float64)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0,
                                   atol=FUSED_TOL * scale, err_msg=name)
