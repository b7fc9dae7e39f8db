"""The row-panel small spaces (``eps_smallspace_panel.cu`` at B 65-128,
``bam_smallspace_panel*.cu`` at B 57-128, on ``smallspace_panel.cuh``),
checked on the CPU.

- The layout: every row of an (n, n) matrix owned by exactly one block of
  the ``PANEL_RANKS`` for n = 65..136, at most 8 rows a block up to n = 128
  and 9 above (BaM's (2, 2) tile); each kernel's shared memory under a
  Hopper block's 227 KiB over its range.
- The wrappers' launches, recorded from a stand-in library on CPU tensors:
  the small space by batch alone (the ranks never depend on D or on the
  replica count K, which keeps replica z of a K-replica launch equal to a
  launch on replica z), K6's sub-steps at B=128, and the placement check,
  which raises, naming the shape, when ``cudaOccupancyMaxActiveClusters``
  reads 0 (or the query fails), is read once per shape and never inside a
  stream capture.
- A numpy float32 emulation of the panel product's sum order (each block
  stages the whole right operand, its panels in rank order, into one
  matrix, then one fused multiply-add chain per output, k ascending) and of the row-panel Grams
  (one chain per entry over D ascending) against float64 at B = 72 and 128
  and at kpad = 136: bit for bit the order of the 32 x 32 GEMM template
  and of the grid small space (k ascending in one chain per output), and within
  1e-6 relative of float64, so the card's tolerances cover the new order.
- The plain versions (``eps_smallspace``, ``bam_smallspace`` on CPU
  tensors) against the JAX package's ``_eps_smallspace_ns`` and
  ``_bam_smallspace_ns`` at B = 72 and 128: flags equal, F' and the mean
  within 1e-5 * max(1, scale), BaM's gate statistics within 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import bam_fused as jbf
from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.ops import bam_fused as bf
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs
from gsmvi_tpu_torch.ops.cuda import _build

P = fs.PANEL_RANKS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(65, 88), (89, 112), (113, 136)])
def test_panel_rows_own_every_row_once(lo, hi):
    for n in range(lo, hi + 1):
        rows = fs.panel_rows(n)
        owner = np.full(n, -1)
        for r in range(P):
            span = range(r * rows, min(n, (r + 1) * rows))
            assert (owner[span.start:span.stop] == -1).all()
            owner[span.start:span.stop] = r
        assert (owner >= 0).all(), n
        # The last blocks may hold no row (at n = 65, 13 of 16 hold 5).
        assert sum(r * rows < n for r in range(P)) == -(-n // rows)
        assert rows <= (8 if n <= 128 else 9), n


def test_panel_tiles_cover_their_panels():
    for b in range(fs.SHARED_SMALLSPACE_MAX_B + 1,
                   fs.PANEL_SMALLSPACE_MAX_B + 1):
        assert 8 >= fs.panel_rows(b) and 128 >= b
    for b in range(bf.BAM_SHARED_MAX_B + 1, bf.BAM_KERNEL_BATCH_RANGE[1] + 1):
        tr, nc = bf.bam_panel_tile(b)
        assert 8 * tr >= fs.panel_rows(b + 8) and 128 * nc >= b + 8, b
    assert [bf.bam_panel_tile(b) for b in (57, 120, 121, 128)] == [
        (1, 1), (1, 1), (2, 2), (2, 2)]


def test_panel_shared_memory_fits_a_block():
    eps = [fs.eps_panel_smem_bytes(b) for b in range(65, 129)]
    bam = [bf.bam_panel_smem_bytes(b) for b in range(57, 129)]
    assert max(eps) <= fs.SMEM_LIMIT_BYTES and max(bam) <= fs.SMEM_LIMIT_BYTES
    # The numbers in the kernels' headers, at the top and foot of each range.
    assert fs.eps_panel_smem_bytes(128) == 121664
    assert bf.bam_panel_smem_bytes(128) == 158992
    # D and K do not enter: the bytes are a function of (B, P) alone.
    assert eps == sorted(eps)


# ---------------------------------------------------------------------------
# The wrappers' launches, on a stand-in library
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the CUDA kernel library: records each entry point's
    name and arguments; ``clusters`` is what the placement query reads."""

    def __init__(self):
        self.calls = []
        self.sizes = []
        self.clusters = 16

    def call(self, name, *args):
        self.calls.append((name, args))

    def size(self, name, *args):
        self.sizes.append((name, args))
        return self.clusters if name.endswith("_panel_clusters") else 16

    def named(self, name):
        return [args for n, args in self.calls if n == name]


@pytest.fixture
def card(monkeypatch):
    rec = _Recorder()
    for mod in (fs, bf):
        monkeypatch.setattr(mod, "_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "_library", lambda: rec)
        monkeypatch.setattr(mod, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_PLACEMENT", {})
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _rows(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _panel_shape(args):
    """(b, d, reps, e_stride) of a ``gsmvi_eps_smallspace_panel`` call,
    whose arguments match the C entry's."""
    assert len(args) == len(_build.SIGNATURES["gsmvi_eps_smallspace_panel"])
    return args[14], args[15], args[22], args[23]


@pytest.mark.parametrize("b", [65, 96, 128])
def test_eps_panel_launch_does_not_depend_on_d_or_replicas(card, b):
    for d in (1, 33, 256, 1024):
        for k in (None, 3, 8):
            lead = () if k is None else (k,)
            card.calls.clear()
            fs.gsm_eps_update_fused(_rows(*lead, b, d), _rows(*lead, b, d),
                                    _rows(*lead, d), _rows(*lead, d, d))
            (panel,) = card.named("gsmvi_eps_smallspace_panel")
            assert _panel_shape(panel) == (b, d, k or 1, b * d)
    counts = fs.launch_counts()
    assert counts["eps_smallspace_panel"] == 12 == counts["gsm_eps_update_fused"]
    assert counts["eps_smallspace"] == counts["eps_smallspace_large"] == 0
    # The placement is read once per (kind, B).
    assert card.sizes.count(("gsmvi_eps_panel_clusters", (b,))) == 1


def test_k6_at_b128_runs_its_sub_steps_on_the_panel_small_space(card):
    b, d, spc, k = 128, 64, 8, 4
    params = (_rows(1, d), _rows(d, d))
    batch = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d, k,
                                               spc)
    batch(3, _rows(k, spc * b, d), _rows(k, d), _rows(k, d, d), *params)
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_thin_rows",
                     "gsmvi_thin_rows", "gsmvi_eps_smallspace_panel",
                     "gsmvi_factor_apply"] * 3
    # Each replica's draw is a view into the (K, spc*B, D) block.
    assert {_panel_shape(a) for a in card.named("gsmvi_eps_smallspace_panel")} \
        == {(b, d, k, spc * b * d)}
    assert fs.launch_counts()["eps_smallspace_panel"] == 3


@pytest.mark.parametrize("kind,b", [("eps", 65), ("eps", 128), ("bam", 57),
                                    ("bam", 128)])
@pytest.mark.parametrize("reads", [0, -2])
def test_panel_launch_raises_when_the_cluster_cannot_be_placed(card, kind, b,
                                                               reads):
    card.clusters = reads
    d = 32
    with pytest.raises(RuntimeError, match=f"B={b} on a cluster of {P}"):
        if kind == "eps":
            fs.gsm_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d),
                                    _rows(d, d))
        else:
            bf.bam_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d),
                                    _rows(d, d), 0.5)
    assert not card.named(f"gsmvi_{kind}_smallspace_panel")
    counts = fs.launch_counts()
    assert counts[f"{kind}_smallspace_panel"] == 0


@pytest.mark.parametrize("kind,b", [("eps", 96), ("bam", 100)])
def test_panel_placement_is_never_read_inside_a_capture(card, kind, b,
                                                        monkeypatch):
    """The placement query sets the kernel's launch attributes, which a
    stream capture does not allow: a shape's first launch inside one
    raises and launches nothing; a shape read before captures as usual."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    d = 32
    launch = ((lambda: fs.gsm_eps_update_fused(
        _rows(b, d), _rows(b, d), _rows(d), _rows(d, d))) if kind == "eps"
        else (lambda: bf.bam_eps_update_fused(
            _rows(b, d), _rows(b, d), _rows(d), _rows(d, d), 0.5)))
    with pytest.raises(RuntimeError, match=f"B={b}: its first launch"):
        launch()
    assert not [n for n, _ in card.sizes if n.endswith("_panel_clusters")]
    assert not card.named(f"gsmvi_{kind}_smallspace_panel")
    fs._PLACEMENT[(kind, b)] = 7
    launch()
    assert len(card.named(f"gsmvi_{kind}_smallspace_panel")) == 1


@pytest.mark.parametrize("b", [57, 100, 128])
def test_bam_panel_launch_shapes(card, b):
    for d in (1, 64, 257):
        card.calls.clear()
        bf.bam_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d),
                                _rows(d, d), 0.5)
        (panel,) = card.named("gsmvi_bam_smallspace_panel")
        assert panel[11].value is None                 # no halt word
        assert len(panel) == len(
            _build.SIGNATURES["gsmvi_bam_smallspace_panel"])
        assert panel[13:15] == (b, d)
    counts = fs.launch_counts()
    assert counts["bam_smallspace_panel"] == 3 and counts["bam_smallspace"] == 0


# ---------------------------------------------------------------------------
# The sum orders in numpy float32, against float64
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _chain(a, b):
    """a @ b with one fused multiply-add chain per output, k ascending."""
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        out = _fma32(a[:, k:k + 1], b[k:k + 1, :], out)
    return out


def _panel_product(a, b):
    """C = A B as the panel kernel forms it: block r stages B's panels of
    ranks 0..P-1 in order into one matrix and forms its rows of C from its
    rows of A, one chain per output, k ascending."""
    n = a.shape[0]
    rows = fs.panel_rows(n)
    gathered = np.concatenate([b[q * rows:(q + 1) * rows] for q in range(P)])
    return np.concatenate([_chain(a[r * rows:(r + 1) * rows], gathered)
                           for r in range(P)])


def _gemm_template(a, b, tile=32):
    """The GEMM template's order (and the grid small space's): 32 x 32 output tiles, k in
    32-deep slabs, one chain per output across the slabs, k ascending."""
    n = a.shape[0]
    out = np.zeros((n, b.shape[1]), np.float32)
    for i0 in range(0, n, tile):
        for j0 in range(0, b.shape[1], tile):
            out[i0:i0 + tile, j0:j0 + tile] = _chain(
                a[i0:i0 + tile], b[:, j0:j0 + tile])
    return out


def _spd(rng, n, scale):
    x = rng.standard_normal((n, 2 * n)).astype(np.float32)
    return (np.eye(n) + scale * (x @ x.T) / (2 * n)).astype(np.float32)


@pytest.mark.parametrize("n", [72, 128, 136])
def test_panel_product_order_within_the_global_order(n):
    rng = np.random.default_rng(n)
    a, b = _spd(rng, n, 4.0), _spd(rng, n, 0.5)
    got = _panel_product(a, b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    glob = _gemm_template(a, b)
    err = float(np.abs(got - exact).max())
    assert np.array_equal(got, glob)
    assert err <= float(np.abs(glob - exact).max())
    assert err <= 1e-6 * max(1.0, float(np.abs(exact).max()))


def _row_panel_gram(x, y, scale):
    """scale * x y^T as the panel kernel forms it: block r's rows of x
    against every row of y, one chain per entry over D ascending."""
    rows = fs.panel_rows(x.shape[0])
    return np.concatenate([(_chain(x[r * rows:(r + 1) * rows], y.T)
                            * np.float32(scale)).astype(np.float32)
                           for r in range(P)])


@pytest.mark.parametrize("n,d,pad", [(72, 256, 0), (128, 256, 0),
                                     (136, 256, 7)])
def test_panel_gram_order_within_the_global_order(n, d, pad):
    """Gu = e e^T / B and e c^T / B (eps), or kpad-padded row factors (BaM,
    pad = kpad - B - 1 zero rows)."""
    rng = np.random.default_rng(n + d)
    live = n - pad
    e = np.zeros((n, d), np.float32)
    c = np.zeros((n, d), np.float32)
    e[:live] = rng.standard_normal((live, d))
    c[:live] = 0.5 * rng.standard_normal((live, d))
    scale = 1.0 / live
    for y in (e, c):
        exact = e.astype(np.float64) @ y.T.astype(np.float64) * scale
        got = _row_panel_gram(e, y, scale)
        glob = (_gemm_template(e, y.T) * np.float32(scale)).astype(np.float32)
        assert np.array_equal(got, glob)
        assert not got[live:].any() and not got[:, live:].any()
        err = float(np.abs(got - exact).max())
        assert err <= 1e-6 * max(1.0, float(np.abs(exact).max()))


# ---------------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------------

def _eps_problem(seed, b, d):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


@pytest.mark.parametrize("b,d", [(72, 24), (128, 40)])
def test_eps_panel_plain_version_matches_jax(b, d):
    eps, v, mu, f = _eps_problem(b + d, b, d)
    vf = v @ f
    m_j, f_j, g_j = jfs._eps_smallspace_ns(
        *(jnp.asarray(x, jnp.float32) for x in (eps, v, vf, mu[None], f)),
        batch=b)
    e_t, v_t, mu_t, f_t = (torch.from_numpy(x) for x in (eps, v, mu, f))
    vf_t = v_t @ f_t
    fs.reset_launch_counts()
    m_t, su, sw, g_t = fs.eps_smallspace(e_t, v_t, vf_t, vf_t @ f_t.T,
                                         e_t @ f_t.T, mu_t)
    assert sum(fs.launch_counts().values()) == 0
    assert bool(g_t) == bool(g_j)
    if bool(g_j):
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j)[0], rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(mu).max())))
        np.testing.assert_allclose((f_t + su.T @ sw).numpy(), np.asarray(f_j),
                                   rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(f).max())))


def _bam_inputs(seed, b, d, score_scale=1.0, v_scale=None):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    v = (score_scale * -(mu + e @ f.T - rng.standard_normal(d))
         ).astype(np.float32)
    if v_scale is not None:
        v = (v_scale * rng.standard_normal((b, d))).astype(np.float32)
    return e, v, mu, f


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("case", ["benign", "stiff_lmax"])
@pytest.mark.parametrize("b,d", [(72, 24), (128, 40)])
def test_bam_panel_plain_version_matches_jax(b, d, case):
    sc, vsc, reg = (1.0, 0.05, 0.5) if case == "benign" else (300.0, None,
                                                             20.0)
    e, v, mu, f = _bam_inputs(b * 1000 + d, b, d, sc, vsc)
    ef = (e @ f.T).astype(np.float32)
    e_t, v_t, mu_t, f_t, ef_t = (torch.from_numpy(x)
                                 for x in (e, v, mu, f, ef))
    vf_t = v_t @ f_t
    su, sw, vec, ss = bf.bam_smallspace(e_t, v_t, vf_t, vf_t @ f_t.T, ef_t,
                                        mu_t, reg)
    assert su.shape == sw.shape == (2 * (b + 1), d)
    f_new = f_t + su.T @ sw
    tr_v = (torch.sum(f_t * f_t) + 2.0 * ss[4]) + ss[5]
    tr_new = torch.sum(f_new * f_new)
    good = bool(torch.isfinite(tr_new) & (tr_new <= 1.05 * tr_v + 1e-6)
                & (ss[2] != 0))
    r1 = reg / (1.0 + reg)
    mu_new = mu_t / (1.0 + reg) + r1 * ((vec[0] @ f_new) @ f_new.T + vec[1])
    want = jbf._bam_smallspace_ns(*(jnp.asarray(x, jnp.float32)
                                    for x in (e, v, mu[None], f)), reg,
                                  batch=b, ef_t=jnp.asarray(ef))
    assert [good, bool(ss[3])] == [bool(want[2]), bool(want[3])]
    assert bool(ss[3]) == (case == "stiff_lmax")
    np.testing.assert_allclose(ss[:2].numpy(), [float(want[4]),
                                                float(want[5])], rtol=1e-4,
                               atol=1e-6)
    if good:
        _close(f_new.numpy(), want[1], 1e-5, "factor")
        _close(mu_new.numpy(), np.asarray(want[0])[0], 1e-5, "mean")
