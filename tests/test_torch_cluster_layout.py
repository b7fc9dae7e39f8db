"""How the port's two cluster kernels cut their work, checked on the CPU.

- ``cluster_columns(D)``, the cluster small space's split of the columns
  over its blocks, and ``thin_split(D)``, the split-k thin product's split of
  the k range, over D = 1..8192: every index owned once, at most 8 blocks,
  none empty.
- The wrappers' launches, recorded from a stand-in library on CPU tensors:
  the cluster shape and the split depend on D alone, never on the replica
  count K or the row count M (what keeps replica z of a K-replica launch, and
  a replica's rows inside K6's stacked score, bit-identical to a launch on
  it alone), and K1, K2 and K6 run the ns route on the two kernels.
- A numpy float32 emulation of the kernels' sum orders (fused multiply-adds
  ascending in k within a block, the blocks' partials summed in rank order)
  against float64: the thin product at (32, 256), (256, 256) and (32, 8192),
  the small space's Grams at (32, 256), (64, 256) and (32, 8192).  The
  thin product's emulation stays within an eighth of ``chip_smoke.py``'s
  1e-5 * max(1, |v|) of float64, and the Grams' within the one-block
  kernel's sequential order's own distance, so the card's tolerances cover
  the new orders.
- The small space's plain version (``eps_smallspace`` on CPU tensors)
  against the JAX package's ``_eps_smallspace_ns``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs

D_BLOCKS = [(lo, lo + 1023) for lo in range(1, 8193, 1024)]
SCORE_TOL = 1e-5                     # chip_smoke.py's SCORE_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lo,hi", D_BLOCKS)
def test_cluster_columns_own_every_column_once(lo, hi):
    for d in range(lo, hi + 1):
        c, cols = fs.cluster_columns(d)
        assert 1 <= c <= fs.CLUSTER_MAX_BLOCKS
        owner = np.full(d, -1)
        for r in range(c):
            span = range(r * cols, min(d, (r + 1) * cols))
            assert len(span) > 0, (d, r)
            assert (owner[span.start:span.stop] == -1).all()
            owner[span.start:span.stop] = r
        assert (owner >= 0).all(), d


@pytest.mark.parametrize("lo,hi", D_BLOCKS)
def test_thin_split_owns_every_k_once(lo, hi):
    for d in range(lo, hi + 1):
        s, k_per = fs.thin_split(d)
        assert 1 <= s <= fs.CLUSTER_MAX_BLOCKS and k_per % fs.SLAB == 0
        ks = [k for r in range(s) for k in range(r * k_per,
                                                 min(d, (r + 1) * k_per))]
        assert ks == list(range(d)), d
        assert all(r * k_per < d for r in range(s)), d


def test_splits_at_the_main_shapes():
    assert fs.cluster_columns(256) == (8, 32)
    assert fs.thin_split(256) == (8, 32)       # 64 blocks at M=32
    assert fs.cluster_columns(1) == (1, 1) and fs.thin_split(1) == (1, 32)
    assert fs.cluster_columns(257) == (8, 33)
    assert fs.thin_split(257) == (5, 64)
    assert fs.cluster_columns(8192) == (8, 1024)
    assert fs.thin_split(8192) == (8, 1024)


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
    """The wrappers' card path on CPU tensors, launching into a recorder
    (K6 runs on ``fs.FusedBlocks``, so patching ``fs`` covers it)."""
    rec = _Recorder()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _rows(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _thin_shape(args):
    """(rows m, replicas k, split, k_per) of a ``gsmvi_thin_rows`` call."""
    return args[6], args[9], args[11], args[12]


def _cluster_shape(args):
    """(b, d, replicas, ranks, cols) of a ``gsmvi_eps_smallspace_cluster``
    call."""
    return args[13], args[14], args[21], args[23], args[24]


@pytest.mark.parametrize("b,d", [(1, 1), (32, 256), (64, 257), (3, 8192)])
def test_k1_launch_shapes_do_not_depend_on_replicas(card, b, d):
    shapes = {}
    for k in (None, 3, 8):
        lead = () if k is None else (k,)
        card.calls.clear()
        fs.gsm_eps_update_fused(_rows(*lead, b, d), _rows(*lead, b, d),
                                _rows(*lead, d), _rows(*lead, d, d))
        names = [n for n, _ in card.calls]
        assert names == ["gsmvi_thin_rows"] * 3 + [
            "gsmvi_eps_smallspace_cluster", "gsmvi_factor_apply"], names
        thin = [_thin_shape(a) for a in card.named("gsmvi_thin_rows")]
        (cl,) = [_cluster_shape(a) for a in
                 card.named("gsmvi_eps_smallspace_cluster")]
        assert all(t[1] == (k or 1) for t in thin) and cl[2] == (k or 1)
        shapes[k] = ({t[2:] for t in thin}, cl[3:])
    assert shapes[None] == shapes[3] == shapes[8] == (
        {fs.thin_split(d)}, fs.cluster_columns(d))
    counts = fs.launch_counts()
    assert counts["gsm_eps_update_fused"] == 3
    assert counts["thin_product"] == 9 and counts["eps_smallspace"] == 3


@pytest.mark.parametrize("b", [64, 65, 128, 129, 512])
def test_k1_above_the_shared_batch_takes_the_global_small_space(card, b):
    """The small space by batch alone: the cluster kernel up to
    SHARED_SMALLSPACE_MAX_B, the row-panel kernel up to
    PANEL_SMALLSPACE_MAX_B, the grid kernel (one cooperative launch) above; one launch of
    exactly one of them per update."""
    fs.gsm_eps_update_fused(_rows(b, 64), _rows(b, 64), _rows(64),
                            _rows(64, 64))
    entry, counter = (
        ("gsmvi_eps_smallspace_cluster", "eps_smallspace")
        if b <= fs.SHARED_SMALLSPACE_MAX_B else
        ("gsmvi_eps_smallspace_panel", "eps_smallspace_panel")
        if b <= fs.PANEL_SMALLSPACE_MAX_B else
        ("gsmvi_eps_smallspace_large", "eps_smallspace_large"))
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows"] * 3 + [entry, "gsmvi_factor_apply"]
    counts = fs.launch_counts()
    small = ("eps_smallspace", "eps_smallspace_panel", "eps_smallspace_large")
    assert {k: counts[k] for k in small} == {k: int(k == counter)
                                             for k in small}


@pytest.mark.parametrize("d", [1, 200, 256, 8192])
def test_k3_split_does_not_depend_on_the_row_count(card, d):
    for m in (1, 2, 32, 33, 256, 512):
        fs.gaussian_score(_rows(m, d), _rows(1, d), _rows(d, d))
    calls = card.named("gsmvi_thin_score")
    assert [a[4] for a in calls] == [1, 2, 32, 33, 256, 512]
    assert {(a[6], a[7]) for a in calls} == {fs.thin_split(d)}
    assert fs.launch_counts()["gaussian_score"] == 6


def test_k2_and_k6_sub_steps_run_the_two_kernels(card):
    b, d, spc, k = 32, 256, 8, 3
    score = (fs.gaussian_score, 2)
    params = (_rows(1, d), _rows(d, d))
    step = fs.make_fused_eps_multistep(score[0], score[1], b, d, spc)
    step(2, _rows(spc * b, d), _rows(d), _rows(d, d), *params)
    k2 = list(card.calls)
    card.calls.clear()
    batch = bfm.make_fused_eps_batch_multistep(score[0], score[1], b, d, k,
                                               spc)
    batch(2, _rows(k, spc * b, d), _rows(k, d), _rows(k, d, d), *params)
    k6 = list(card.calls)
    sub_step = ["gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_thin_rows",
                "gsmvi_thin_rows", "gsmvi_eps_smallspace_cluster",
                "gsmvi_factor_apply"]
    for calls in (k2, k6):
        assert [n for n, _ in calls] == sub_step * 2
    # K6's score runs on the K*B stacked rows with the single fit's split.
    assert [a[4] for n, a in k6 if n == "gsmvi_thin_score"] == [k * b] * 2
    for name, shape in (("gsmvi_thin_rows", lambda a: a[11:13]),
                        ("gsmvi_thin_score", lambda a: a[6:8]),
                        ("gsmvi_eps_smallspace_cluster", lambda a: a[23:25])):
        got = {tuple(shape(a)) for calls in (k2, k6)
               for n, a in calls if n == name}
        assert len(got) == 1, (name, got)
    # The draw is a view into the (K, spc*B, D) block: its replica stride.
    assert [a[10] for n, a in k6 if n == "gsmvi_thin_rows"][0] == spc * b * d


# ---------------------------------------------------------------------------
# The kernels' sum orders in numpy float32, against float64
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _thin_emulated(a, b):
    """a (M, D) @ b (D, N) in the thin kernel's order: block r of the
    cluster accumulates k in [r k_per, (r+1) k_per) ascending with fused
    multiply-adds; the partials are summed in rank order."""
    m, d = a.shape
    s, k_per = fs.thin_split(d)
    out = np.zeros((m, b.shape[1]), np.float32)
    for r in range(s):
        part = np.zeros_like(out)
        for k in range(r * k_per, min(d, (r + 1) * k_per)):
            part = _fma32(a[:, k:k + 1], b[k:k + 1, :], part)
        out = (out + part).astype(np.float32)
    return out


def _gram(x, y, scale, splits):
    """scale * x y^T with the columns cut into ``splits`` blocks, each
    accumulated ascending with fused multiply-adds, summed in block order."""
    out = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for lo, hi in splits:
        part = np.zeros_like(out)
        for col in range(lo, hi):
            part = _fma32(x[:, col:col + 1], y[None, :, col], part)
        out = (out + part).astype(np.float32)
    return (out * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize("m,d", [(32, 256), (256, 256), (32, 8192)])
def test_thin_product_order_within_the_tolerance(m, d):
    rng = np.random.default_rng(m + d)
    a = rng.standard_normal((m, d)).astype(np.float32)
    f = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    cols = slice(0, 64)                # an output column needs its own only
    got = _thin_emulated(a, f[:, cols])
    plain = (a @ f)[:, cols]
    exact = (a.astype(np.float64) @ f)[:, cols]
    tol = SCORE_TOL * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(got - exact).max()) <= tol / 8
    assert float(np.abs(got - plain).max()) <= tol
    assert float(np.abs(plain - exact).max()) <= tol / 8


@pytest.mark.parametrize("b,d", [(32, 256), (64, 256), (32, 8192)])
def test_smallspace_gram_order_within_the_one_block_order(b, d):
    rng = np.random.default_rng(b * d)
    e = rng.standard_normal((b, d)).astype(np.float32)
    c = (0.5 * rng.standard_normal((b, d))).astype(np.float32)
    ranks, cols = fs.cluster_columns(d)
    cluster = [(r * cols, min(d, (r + 1) * cols)) for r in range(ranks)]
    for y in (e, c):
        exact = e.astype(np.float64) @ y.T.astype(np.float64) / b
        got = _gram(e, y, 1.0 / b, cluster)
        one_block = _gram(e, y, 1.0 / b, [(0, d)])
        err = float(np.abs(got - exact).max())
        assert err <= float(np.abs(one_block - exact).max())
        assert err <= 1e-6 * max(1.0, float(np.abs(exact).max()))


# ---------------------------------------------------------------------------
# The small space's and the thin product's plain versions
# ---------------------------------------------------------------------------

def _problem(seed, b, d, decades=0.0):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = (np.logspace(0.0, decades, b)[:, None]
           * rng.standard_normal((b, d))).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


@pytest.mark.parametrize("b,d", [(8, 48), (32, 64)])
def test_smallspace_plain_version_matches_jax(b, d):
    eps, v, mu, f = _problem(b + d, b, d)
    vf = v @ f
    m_j, f_j, g_j = jfs._eps_smallspace_ns(
        *(jnp.asarray(x, jnp.float32) for x in (eps, v, vf, mu[None], f)),
        batch=b)
    e_t, v_t, mu_t, f_t = (torch.from_numpy(x) for x in (eps, v, mu, f))
    vf_t = v_t @ f_t
    m_t, su, sw, g_t = fs.eps_smallspace(e_t, v_t, vf_t, vf_t @ f_t.T,
                                         e_t @ f_t.T, mu_t)
    assert bool(g_t) and bool(g_j)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j)[0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose((f_t + su.T @ sw).numpy(), np.asarray(f_j),
                               rtol=0, atol=1e-5 * float(np.abs(f).max()))


def test_smallspace_plain_replicas_and_rejection():
    ins = [[torch.from_numpy(x) for x in _problem(i, 16, 40,
                                                  3.0 if i == 1 else 0.0)]
           for i in range(3)]

    def rows(e, v, mu, f):
        vf = v @ f
        return e, v, vf, vf @ f.T, e @ f.T, mu

    singles = [fs.eps_smallspace(*rows(*x)) for x in ins]
    stacked = fs.eps_smallspace(*(torch.stack(z) for z in
                                  zip(*(rows(*x) for x in ins))))
    assert stacked[3].tolist() == [True, False, True]
    assert torch.equal(singles[1][0], ins[1][2])   # rejected: the old mean
    for i, one in enumerate(singles):          # a rejected replica's rows
        for got, want in zip(stacked, one):    # may hold NaN
            assert torch.allclose(got[i], want, rtol=0, atol=0,
                                  equal_nan=True)


def test_thin_product_plain_version():
    rng = np.random.default_rng(5)
    rows, f, mu = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((5, 12), (12, 12), (12,)))
    assert torch.equal(fs.thin_product(rows, f, trans=False), rows @ f)
    out, x = fs.thin_product(rows, f, trans=True, mu=mu)
    assert torch.equal(out, rows @ f.T) and torch.equal(x, mu + out)
    with pytest.raises(ValueError, match="trans=True"):
        fs.thin_product(rows, f, trans=False, mu=mu)
    assert fs.launch_counts()["thin_product"] == 0
