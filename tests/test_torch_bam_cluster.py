"""BaM's cluster small space and thin row products, checked on the CPU.

- The small space's plain version (``bam_smallspace`` on CPU tensors, i.e.
  ``bam_smallspace_stacks_reference``: the kernel's formulation from the
  rows vf, t and ef) against the JAX package's ``_bam_smallspace_ns``:
  F + stack_u^T stack_w equals its f_new and the mean assembled from
  ``vec`` its mu_new, within 1e-5 * max(1, scale), and good (the finalize's
  trace and residual screens on ``ss``), stiff, gu_ub and lmax_ub agree
  (the statistics within 1e-4 relative), as ``tests/test_torch_bam_fused.py``
  holds K7's plain version.
- A numpy float32 emulation of the kernel's Gram sum order (fused
  multiply-adds ascending over a block's columns, the blocks' (kpad, kpad)
  partials summed in rank order) against float64 and against the one-block
  kernel's sequential order.
- The wrappers' launches, recorded from a stand-in library on CPU tensors:
  the small space on ``cluster_columns(D)`` blocks at the tile
  ``bam_cluster_tile(B)`` (the row-panel kernel above B = 56), every
  row product (vf, t, ef, the mean matvecs) on ``gsmvi_thin_rows`` with
  ``thin_split(D)``, and in K8 the report's halt word forwarded to every
  launch after the score.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import bam_fused as jbf
from gsmvi_tpu_torch.ops import bam_fused as tbf
from gsmvi_tpu_torch.ops import fused_step as tfs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, d, score_scale=1.0, v_scale=None):
    """tests/test_torch_bam_fused.py's inputs: draws, a near-identity factor,
    a mean and Gaussian scores (``v_scale``: small-noise scores instead)."""
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


# case: (score scale, small-noise scores, reg, gate overrides)
CASES = {
    "benign": (1.0, 0.05, 0.5, {}),
    "stiff_lmax": (300.0, None, 20.0, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("b,d", [(1, 1), (2, 10), (12, 200), (32, 256),
                                 (56, 64)])
def test_stacks_reference_matches_jax(b, d, case):
    sc, vsc, reg, gates = CASES[case]
    e, v, mu, f = _inputs(b * 1000 + d, b, d, sc, vsc)
    ef = (e @ f.T).astype(np.float32)
    e_t, v_t, mu_t, f_t, ef_t = (torch.from_numpy(x)
                                 for x in (e, v, mu, f, ef))
    vf_t = v_t @ f_t
    tfs.reset_launch_counts()
    su, sw, vec, ss = tbf.bam_smallspace(e_t, v_t, vf_t, vf_t @ f_t.T, ef_t,
                                         mu_t, reg, **gates)
    assert sum(tfs.launch_counts().values()) == 0
    assert su.shape == sw.shape == (2 * (b + 1), d) and vec.shape == (2, d)
    assert ss.shape == (tbf.SS_SIZE,) and ss.dtype == torch.float32
    # What the fat apply and the finalize make of the small space's outputs.
    f_new = f_t + su.T @ sw
    tr_v = (torch.sum(f_t * f_t) + 2.0 * ss[4]) + ss[5]
    tr_new = torch.sum(f_new * f_new)
    good = bool(torch.isfinite(tr_new) & (tr_new <= 1.05 * tr_v + 1e-6)
                & (ss[2] != 0))
    r1 = reg / (1.0 + reg)
    mu_new = mu_t / (1.0 + reg) + r1 * ((vec[0] @ f_new) @ f_new.T + vec[1])

    want = jbf._bam_smallspace_ns(*(jnp.asarray(x, jnp.float32)
                                    for x in (e, v, mu[None], f)), reg,
                                  batch=b, ef_t=jnp.asarray(ef), **gates)
    assert [good, bool(ss[3])] == [bool(want[2]), bool(want[3])]
    assert bool(ss[3]) == (case == "stiff_lmax")
    np.testing.assert_allclose(ss[:2].numpy(), [float(want[4]),
                                                float(want[5])], rtol=1e-4,
                               atol=1e-6)
    if good:
        _close(f_new.numpy(), want[1], 1e-5, "factor")
        _close(mu_new.numpy(), np.asarray(want[0])[0], 1e-5, "mean")


def test_stacks_reference_rows_are_k7s():
    """The stacked rows reproduce K7's plain version (q_t, qf and fom_t
    from F's products or from the rows vf, t and ef agree to rounding)."""
    b, d, reg = 8, 40, 1.5
    e, v, mu, f = (torch.from_numpy(x) for x in _inputs(3, b, d))
    vf = v @ f
    su, sw, vec, ss = tbf.bam_smallspace_stacks_reference(
        e, v, vf, vf @ f.T, e @ f.T, mu, reg, batch=b)
    m_k, f_k, keep, stiff, stats = tbf.bam_eps_update_ns_reference(
        e, v, mu, f, reg)
    assert bool(keep) and not bool(stiff) and bool(ss[2]) and not bool(ss[3])
    _close((f + su.T @ sw).numpy(), f_k.numpy(), 1e-5)
    np.testing.assert_allclose(ss[:2].numpy(), stats.numpy(), rtol=1e-5)
    np.testing.assert_allclose(vec[0].numpy(), v.mean(0).numpy(), rtol=0,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The kernel's Gram sum order in numpy float32, against float64
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _gram(x, y, splits):
    """x y^T with the columns cut into ``splits`` blocks, each accumulated
    ascending with fused multiply-adds, the partials summed in block
    order."""
    out = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for lo, hi in splits:
        part = np.zeros_like(out)
        for col in range(lo, hi):
            part = _fma32(x[:, col:col + 1], y[None, :, col], part)
        out = (out + part).astype(np.float32)
    return out


def _padded_rows(x, reg, sign):
    """[sru (x - xbar); sign sr1 xbar; 0] in float32 at kpad = B + 8."""
    b, d = x.shape
    xbar = x.mean(axis=0, dtype=np.float32)
    sru = np.float32(np.sqrt(reg / b))
    sr1 = np.float32(np.sqrt(reg / (1.0 + reg)))
    return np.concatenate([sru * (x - xbar), sign * sr1 * xbar[None],
                           np.zeros((7, d), np.float32)]).astype(np.float32)


@pytest.mark.parametrize("b,d", [(32, 256), (56, 1024), (32, 8192)])
def test_cluster_gram_order_within_the_one_block_order(b, d):
    """Reduction 1's Grams om om^T and om q^T, both over kpad rows."""
    rng = np.random.default_rng(b + d)
    om = _padded_rows(rng.standard_normal((b, d)).astype(np.float32), 0.5,
                      -1.0)
    q = _padded_rows((0.3 * rng.standard_normal((b, d))).astype(np.float32),
                     0.5, 1.0)
    ranks, cols = tfs.cluster_columns(d)
    cluster = [(r * cols, min(d, (r + 1) * cols)) for r in range(ranks)]
    for y in (om, q):
        exact = om.astype(np.float64) @ y.T.astype(np.float64)
        got = _gram(om, y, cluster)
        one_block = _gram(om, y, [(0, d)])
        assert not got[b + 1:].any() and not got[:, b + 1:].any()
        err = float(np.abs(got - exact).max())
        assert err <= float(np.abs(one_block - exact).max())
        assert err <= 1e-6 * max(1.0, float(np.abs(exact).max()))


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
    """The wrappers' card path on CPU tensors, launching into a recorder."""
    rec = _Recorder()
    for mod in (tfs, tbf):
        monkeypatch.setattr(mod, "_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "_library", lambda: rec)
        monkeypatch.setattr(mod, "_stream", lambda device: None)
    tfs.reset_launch_counts()
    yield rec
    tfs.reset_launch_counts()


def _rows(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _thin_rows(args):
    """(rows m, trans, split, k_per, halt) of a ``gsmvi_thin_rows`` call."""
    return args[6], args[8], args[11], args[12], args[5].value


K7_LAUNCHES = ["gsmvi_thin_rows", "gsmvi_thin_rows",
               "gsmvi_bam_smallspace_cluster", "gsmvi_bam_apply",
               "gsmvi_thin_rows", "gsmvi_thin_rows", "gsmvi_bam_finalize",
               "gsmvi_bam_select"]


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("b,d", [(1, 1), (9, 10), (32, 256), (40, 257),
                                 (56, 8192)])
def test_k7_launch_shapes(card, b, d, with_ef):
    ef = _rows(b, d) if with_ef else None
    tbf.bam_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d), _rows(d, d),
                             0.5, ef=ef)
    names = [n for n, _ in card.calls]
    assert names == ([] if with_ef else ["gsmvi_thin_rows"]) + K7_LAUNCHES
    thin = [_thin_rows(a) for a in card.named("gsmvi_thin_rows")]
    # ef = e F^T, vf = v F, t = vf F^T, t1 = gbar F', sg = t1 F'^T.
    want = [(b, 0), (b, 1), (1, 0), (1, 1)]
    assert [t[:2] for t in thin] == ([] if with_ef else [(b, 1)]) + want
    assert {t[2:4] for t in thin} == {tfs.thin_split(d)}
    assert {t[4] for t in thin} == {None}
    (cl,) = card.named("gsmvi_bam_smallspace_cluster")
    assert cl[11].value is None                       # no halt word
    assert cl[12:14] == (b, d)
    assert cl[23:26] == (*tfs.cluster_columns(d), tbf.bam_cluster_tile(b))
    (apply,) = card.named("gsmvi_bam_apply")
    assert apply[6:8] == (2 * (b + 1), d)
    counts = tfs.launch_counts()
    assert counts["bam_eps_update_fused"] == 1
    assert counts["bam_smallspace"] == 1
    assert counts["thin_product"] == len(thin)
    assert counts["bam_smallspace_panel"] == 0


@pytest.mark.parametrize("b", [56, 57, 128])
def test_k7_above_the_shared_batch_takes_the_global_small_space(card, b):
    """The small space by batch alone: the cluster kernel up to
    BAM_SHARED_MAX_B, the row-panel kernel above (the global-memory chain
    that took B 57-128 is gone); one launch of one of them per update."""
    d = 64
    tbf.bam_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d), _rows(d, d),
                             0.5)
    panel = b > tbf.BAM_SHARED_MAX_B
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows"] + [
        "gsmvi_bam_smallspace_panel" if panel
        and n == "gsmvi_bam_smallspace_cluster" else n for n in K7_LAUNCHES]
    counts = tfs.launch_counts()
    assert counts["bam_smallspace_panel"] == int(panel)
    assert counts["bam_smallspace"] == int(not panel)
    assert counts["thin_product"] == 5


def test_tile_covers_kpad_over_the_range():
    for b in range(1, tbf.BAM_SHARED_MAX_B + 1):
        tile = tbf.bam_cluster_tile(b)
        assert 1 <= tile <= 4 and 16 * (tile - 1) < b + 8 <= 16 * tile, b
        assert tbf.bam_smallspace_smem_bytes(b) <= tbf.SMEM_LIMIT_BYTES
    assert [tbf.bam_cluster_tile(b) for b in (8, 9, 24, 25, 32, 40, 41, 56)] \
        == [1, 2, 2, 3, 3, 3, 4, 4]
    assert tbf.bam_smallspace_smem_bytes(56) == 227456


@pytest.mark.parametrize("b,d", [(2, 10), (32, 256), (56, 257)])
def test_k8_forwards_the_halt_word(card, b, d):
    """Every launch of a K8 sub-step after the score reads the report's
    halt word, the thin products included, so that a stopped block's later
    launches do nothing; the score (K3) needs none."""
    spc, nmax = 3, 2
    step = tbf.make_fused_bam_multistep(tfs.gaussian_score, 2, b, d, spc)
    step([0.1] * spc, nmax, 0, _rows(spc * b, d), _rows(d), _rows(d, d),
         _rows(1, d), _rows(d, d))
    names = [n for n, _ in card.calls]
    sub_step = ["gsmvi_thin_rows", "gsmvi_thin_score"] + K7_LAUNCHES
    assert names == sub_step * nmax
    halts = set()
    for name, args in card.calls:
        if name in ("gsmvi_thin_rows", "gsmvi_bam_apply"):
            halts.add(args[5].value)
        elif name == "gsmvi_bam_smallspace_cluster":
            halts.add(args[11].value)
            assert args[23:25] == tfs.cluster_columns(d)
    assert len(halts) == 1 and None not in halts
    # The sampling product also writes x = mu + ef for the score.
    ef_calls = card.named("gsmvi_thin_rows")[::5]
    assert all(a[2].value is not None and a[4].value is not None
               and a[6] == b for a in ef_calls)
    counts = tfs.launch_counts()
    assert counts["make_fused_bam_multistep"] == 1
    assert counts["bam_smallspace"] == nmax
    assert counts["thin_product"] == 5 * nmax
