"""K replica fits of BaM, FactorBaM and ADVI (``fit_batch``) against single
fits, and K7's replica axis against the JAX package.

The kernel route of ``FactorBaM.fit_batch`` (K7 over stacked replicas) runs
on the CPU by monkeypatching ``gsmvi_tpu_torch.bam_factor.on_gpu``: its
wrapper then runs its plain version replica by replica on the CPU tensors
it is given, as ``tests/test_torch_fit_batch.py`` drives the GSM routes.
Replica i draws what ``fit(seeds[i])`` draws and ends where that fit ends,
bit for bit, whichever replicas beside it replay, resample or reject.  The
JAX side of K7's replica axis is ``jax.vmap`` of its K7 in interpret mode
(``bam_eps_update_fused(..., interpret=True)``) on the same inputs, at
``tests/test_torch_bam_fused.py``'s tolerance: 1e-5 * max(1, scale) on the
mean and the factor, the gate statistics within 1e-4 relative, flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.bam_factor as t_bf
from gsmvi_tpu.ops.pallas import bam_fused as jbf
from gsmvi_tpu_torch import ADVI, Adam, BaM, FactorBaM, Regularizers
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import bam_fused as tbf
from gsmvi_tpu_torch.ops import fused_step as tfs
from gsmvi_tpu_torch.state import replica

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
SEEDS = (4, 0, 9)
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_route(monkeypatch):
    """FactorBaM's kernel route (K7 and its replica axis) on the CPU."""
    monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)


def _equal_states(a, b, fields):
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if torch.is_tensor(x):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


FACTOR_FIELDS = ("mean", "factor", "step", "n_accepted", "n_rejected",
                 "ns_stats")


def _warm_starts(d, k, seed=1, cov_scale=None):
    """Per-replica (K, D) means and (K, D, D) covariances."""
    rng = np.random.default_rng(seed)
    means = 0.3 * rng.standard_normal((k, d))
    covs = []
    for i in range(k):
        a = rng.standard_normal((d, d)) / np.sqrt(d)
        s = 1.0 if cov_scale is None else cov_scale[i]
        covs.append(s * (a @ a.T + np.eye(d)))
    return (torch.tensor(means, dtype=torch.float32),
            torch.tensor(np.stack(covs), dtype=torch.float32))


# ---------------------------------------------------------------------------
# FactorBaM.fit_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("warm", [False, True])
def test_factor_bam_replica_equals_single_fit(route, warm, monkeypatch):
    """150 steps cross two feedback-cadence boundaries (64, 128), so the
    kernel route's replicas change NS tier on their own stats."""
    d, b, niter = 10, 4, 149
    t = dense_gaussian(3, d, scale=0.3, device=DEV)
    if route == "kernel":
        monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)
    fb = FactorBaM(d, t.lp, t.lp_g, device=DEV)
    assert fb._fused_mode(b) == ("update" if route == "kernel" else None)
    regf = Regularizers().linear(50.0)
    kw = {}
    if warm:
        kw["mean"], kw["cov"] = _warm_starts(d, len(SEEDS))
    st = fb.fit_batch(SEEDS, regf, batch_size=b, niter=niter, retries=2,
                      return_state=True, **kw)
    counts = dict(fb.fit_counts)
    assert st.mean.shape == (3, d) and st.factor.shape == (3, d, d)
    assert st.seed == SEEDS and st.step == niter + 1
    assert len(st.ns_stats) == 3
    if route == "kernel":
        assert counts["kernel_calls"] == counts["report_reads"] == niter + 1
        assert sum(counts["tiers"]) == 3 * (niter + 1)
    else:
        assert counts["kernel_calls"] == 0
    for i, seed in enumerate(SEEDS):
        one = {k: v[i] for k, v in kw.items()}
        s = fb.fit(seed, regf, batch_size=b, niter=niter, retries=2,
                   verbose=False, return_state=True, **one)
        _equal_states(replica(st, i), s, FACTOR_FIELDS)
    if route == "kernel":
        assert len({tuple(x) for x in st.ns_stats}) > 1


def test_factor_bam_fit_batch_returns_moments(kernel_route):
    d = 6
    t = dense_gaussian(5, d, scale=0.3, device=DEV)
    fb = FactorBaM(d, t.lp, t.lp_g, device=DEV)
    means, covs = fb.fit_batch((1, 2), Regularizers().linear(50.0),
                               batch_size=3, niter=30)
    st = fb.fit_batch((1, 2), Regularizers().linear(50.0), batch_size=3,
                      niter=30, return_state=True)
    assert torch.equal(means, st.mean)
    assert torch.equal(covs, st.factor @ st.factor.mT) or torch.allclose(
        covs, st.factor @ st.factor.mT, atol=1e-6)
    torch.testing.assert_close(covs, covs.mT, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["stiff", "reject"])
def test_a_stiff_or_rejecting_replica_leaves_the_others_untouched(
        kernel_route, case):
    """"stiff": replica 1 starts at a covariance 1e6 times the others', so
    it takes more stiff steps (replayed on the SVD route with its own draw)
    than they do.  "reject": two-sweep NS chains (``ns_iters`` (2, 2, 2, 2,
    2), the long profile alone) fail their residual gates, so replicas
    resample from their own retry streams while the others hold.  Every
    replica ends where its single fit ends, and the batch's replays and
    retries are the sum of the single fits'."""
    d, b, niter = 12, 4, 40
    t = dense_gaussian(8, d, scale=0.3, device=DEV)
    kw = ({} if case == "stiff"
          else {"ns_iters": (2, 2, 2, 2, 2), "ns_profile": "long"})
    fb = FactorBaM(d, t.lp, t.lp_g, device=DEV, **kw)
    regf = Regularizers().linear(5.0)
    means, covs = _warm_starts(d, 3, seed=2, cov_scale=(1.0, 1e6, 1.0))
    st = fb.fit_batch(SEEDS, regf, mean=means, cov=covs, batch_size=b,
                      niter=niter, retries=3, return_state=True)
    batch_counts = dict(fb.fit_counts)
    singles = []
    for i, seed in enumerate(SEEDS):
        s = fb.fit(seed, regf, mean=means[i], cov=covs[i], batch_size=b,
                   niter=niter, retries=3, verbose=False, return_state=True)
        singles.append(dict(fb.fit_counts))
        _equal_states(replica(st, i), s, FACTOR_FIELDS)
    for name in ("replays", "retries"):
        assert batch_counts[name] == sum(c[name] for c in singles)
    if case == "stiff":
        assert singles[1]["replays"] > max(singles[0]["replays"],
                                           singles[2]["replays"])
    else:
        assert batch_counts["retries"] > 0


def test_k7_replica_launch_reads_one_report_a_step(kernel_route,
                                                   monkeypatch):
    """The kernel route calls the replica-axis K7 once a step for all
    replicas and never the single K7."""
    d = 5
    t = dense_gaussian(2, d, scale=0.3, device=DEV)
    fb = FactorBaM(d, t.lp, t.lp_g, device=DEV)
    calls = {"replicas": 0, "single": 0}
    rep, single = tbf._bam_update_replicas_packed, tbf._bam_update_packed

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_bf, "_bam_update_replicas_packed",
                        count("replicas", rep))
    monkeypatch.setattr(t_bf, "_bam_update_packed", count("single", single))
    fb.fit_batch(range(4), Regularizers().linear(50.0), batch_size=2,
                 niter=11, retries=0)
    assert calls == {"replicas": 12, "single": 0}


# ---------------------------------------------------------------------------
# BaM.fit_batch (the dense step, as JAX vmaps it) and ADVI.fit_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("lowrank", [False, True])
def test_bam_replica_equals_dense_single_fit(warm, lowrank):
    d, b, niter = 10, 2 if lowrank else 4, 40
    t = dense_gaussian(4, d, scale=0.3, device=DEV)
    g = BaM(d, t.lp, t.lp_g, device=DEV, use_factor=False,
            use_lowrank=lowrank)
    regf = Regularizers().linear(50.0)
    kw = {}
    if warm:
        kw["mean"], kw["cov"] = _warm_starts(d, len(SEEDS), seed=3)
    st = g.fit_batch(SEEDS, regf, batch_size=b, niter=niter, retries=2,
                     return_state=True, **kw)
    assert st.seed == SEEDS and st.cov.shape == (3, d, d)
    for i, seed in enumerate(SEEDS):
        one = {k: v[i] for k, v in kw.items()}
        s = g.fit(seed, regf, batch_size=b, niter=niter, retries=2,
                  verbose=False, return_state=True, **one)
        _equal_states(replica(st, i), s, ("mean", "cov", "chol", "step",
                                          "n_accepted", "n_rejected"))
    means, covs = g.fit_batch(SEEDS, regf, batch_size=b, niter=niter,
                              retries=2, **kw)
    assert torch.equal(means, st.mean) and torch.equal(covs, st.cov)


def test_bam_fit_batch_runs_the_dense_step_whatever_use_factor(monkeypatch):
    """As the JAX package's fit_batch: the dense step even where ``fit``
    takes the factor route (use_factor=True here)."""
    d = 6
    t = dense_gaussian(6, d, scale=0.3, device=DEV)
    regf = Regularizers().linear(50.0)
    g = BaM(d, t.lp, t.lp_g, device=DEV, use_factor=True)
    dense = BaM(d, t.lp, t.lp_g, device=DEV, use_factor=False)
    st = g.fit_batch((2,), regf, batch_size=3, niter=20, return_state=True)
    s = dense.fit(2, regf, batch_size=3, niter=20, verbose=False,
                  return_state=True)
    assert torch.equal(st.mean[0], s.mean) and torch.equal(st.cov[0], s.cov)


def test_bam_rejecting_replica_retries_alone():
    """A replica whose proposals fail (a covariance far from the target's
    scale and a huge reg) resamples from its own retry stream; the others
    equal their single fits."""
    d, b = 8, 3
    t = dense_gaussian(9, d, scale=0.3, device=DEV)
    g = BaM(d, t.lp, t.lp_g, device=DEV, use_factor=False)
    regf = Regularizers().linear(1e8)
    means, covs = _warm_starts(d, 3, seed=4, cov_scale=(1.0, 1e-6, 1.0))
    st = g.fit_batch(SEEDS, regf, mean=means, cov=covs, batch_size=b,
                     niter=10, retries=3, return_state=True)
    for i, seed in enumerate(SEEDS):
        s = g.fit(seed, regf, mean=means[i], cov=covs[i], batch_size=b,
                  niter=10, retries=3, verbose=False, return_state=True)
        _equal_states(replica(st, i), s, ("mean", "cov", "chol",
                                          "n_accepted", "n_rejected"))


@pytest.mark.parametrize("warm", [False, True])
def test_advi_replica_equals_single_fit(warm):
    d, b, niter = 6, 4, 30
    t = dense_gaussian(2, d, scale=0.3, device=DEV)
    a = ADVI(d, t.lp, device=DEV)
    kw = {}
    if warm:
        kw["mean"], kw["cov"] = _warm_starts(d, len(SEEDS), seed=5)
    opt = Adam(1e-2)
    means, covs, losses = a.fit_batch(SEEDS, opt, batch_size=b, niter=niter,
                                      **kw)
    assert means.shape == (3, d) and covs.shape == (3, d, d)
    assert isinstance(losses, np.ndarray) and losses.shape == (3, niter + 1)
    for i, seed in enumerate(SEEDS):
        one = {k: v[i] for k, v in kw.items()}
        m, c, l = a.fit(seed, opt, batch_size=b, niter=niter, verbose=False,
                        **one)
        assert torch.equal(means[i], m) and torch.equal(covs[i], c)
        assert np.array_equal(losses[i], l)


def test_advi_fit_batch_losses_match_jax_shape():
    """(K, niter + 1) losses, as the JAX package's fit_batch returns."""
    import optax

    import gsmvi_tpu as g
    import gsmvi_tpu.models  # noqa: F401

    d = 4
    t = dense_gaussian(1, d, scale=0.3, device=DEV)
    jt = g.models.dense_gaussian(jax.random.PRNGKey(1), d)
    _, _, jl = g.ADVI(D=d, lp=jt.lp).fit_batch(
        jnp.stack([jax.random.PRNGKey(k) for k in range(2)]),
        optax.adam(1e-2), batch_size=3, niter=7)
    _, _, tl = ADVI(d, t.lp, device=DEV).fit_batch((0, 1), Adam(1e-2),
                                                   batch_size=3, niter=7)
    assert tl.shape == np.asarray(jl).shape == (2, 8)


def test_fit_batch_rejects_bad_warm_start_shapes():
    d = 4
    t = dense_gaussian(1, d, scale=0.3, device=DEV)
    with pytest.raises(ValueError, match="expected"):
        FactorBaM(d, t.lp, t.lp_g, device=DEV).fit_batch(
            (1, 2), Regularizers().linear(5.0), mean=torch.zeros(3, d),
            niter=2)
    with pytest.raises(ValueError, match="expected"):
        ADVI(d, t.lp, device=DEV).fit_batch((1, 2), Adam(1e-2),
                                            cov=torch.ones(3, d, d), niter=2)


# ---------------------------------------------------------------------------
# K7's replica axis against JAX, and its launches
# ---------------------------------------------------------------------------

def _replica_inputs(seed, k, b, d):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((k, b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((k, d, d))).astype(np.float32)
    mu = rng.standard_normal((k, d)).astype(np.float32)
    v = (0.05 * rng.standard_normal((k, b, d))).astype(np.float32)
    return e, v, mu, f


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("k,b,d", [(1, 4, 16), (3, 8, 32), (4, 2, 10)])
def test_replica_k7_plain_matches_jax_vmap_interpret(k, b, d, with_ef):
    """The stacked K7 step's plain version against jax.vmap of JAX's K7 in
    interpret mode, every replica on the long profile."""
    e, v, mu, f = _replica_inputs(10 * k + b + d, k, b, d)
    ef = np.einsum("kbd,ked->kbe", e, f).astype(np.float32) if with_ef \
        else None
    got = tbf.bam_eps_update_replicas(
        *(torch.from_numpy(x) for x in (e, v, mu, f)), 0.5,
        ef=None if ef is None else torch.from_numpy(ef))
    want = jax.vmap(lambda e_, v_, m_, f_: jbf.bam_eps_update_fused(
        e_, v_, m_, f_, 0.5, interpret=True))(
            *(jnp.asarray(x) for x in (e, v, mu, f)))
    assert got[2].tolist() == np.asarray(want[2]).tolist()
    assert got[3].tolist() == np.asarray(want[3]).tolist()
    _close(got[0], want[0], 1e-5, "mean")
    _close(got[1], want[1], 1e-5, "factor")
    np.testing.assert_allclose(np.asarray(got[4], np.float64),
                               np.asarray(want[4], np.float64), rtol=1e-4,
                               atol=1e-6)


def test_replica_k7_tiers_match_jax_per_replica():
    """Replicas on the four NS tiers and on a two-sweep tier with open
    gates (a residual reject) and a tier whose lmax gate every input
    passes (stiff), at one reg: replica i against JAX's K7 in interpret
    mode at its tier; flags as designed."""
    k, b, d = 6, 8, 32
    e, v, mu, f = _replica_inputs(5, k, b, d)
    tiers = list(tbf.BAM_NS_TIERS) + [((2, 2, 2, 2, 2), INF, INF),
                                      (tbf.BAM_NS_ITERS_DEFAULT,
                                       tbf.GU_GATE_DEFAULT, 1e-3)]
    got = tbf.bam_eps_update_replicas(
        *(torch.from_numpy(x) for x in (e, v, mu, f)), 0.5, tiers)
    for i, (it, gg, lm) in enumerate(tiers):
        want = jbf.bam_eps_update_fused(
            *(jnp.asarray(x[i]) for x in (e, v, mu, f)), 0.5,
            interpret=True, iters=it, gu_gate=gg, lmax_gate=lm)
        assert (bool(got[2][i]), bool(got[3][i])) == (bool(want[2]),
                                                      bool(want[3])), i
        _close(got[0][i], want[0], 1e-5, f"mean {i}")
        _close(got[1][i], want[1], 1e-5, f"factor {i}")
    keep, stiff = got[2].tolist(), got[3].tolist()
    assert keep[:3] == [True] * 3
    assert (keep[4], stiff[4]) == (False, False)
    assert (keep[5], stiff[5]) == (False, True)
    for i in range(k):
        if not keep[i]:
            assert torch.equal(got[0][i], torch.from_numpy(mu[i]))
            assert torch.equal(got[1][i], torch.from_numpy(f[i]))


def test_replica_k7_equals_single_k7_per_replica():
    k, b, d = 3, 5, 12
    e, v, mu, f = (torch.from_numpy(x) for x in
                   _replica_inputs(1, k, b, d))
    tiers = [tbf.BAM_NS_TIERS[i] for i in (0, 2, 1)]
    got = tbf.bam_eps_update_replicas(e, v, mu, f, 0.7, tiers)
    for i, (it, gg, lm) in enumerate(tiers):
        one = tbf.bam_eps_update_fused(e[i], v[i], mu[i], f[i], 0.7,
                                       iters=it, gu_gate=gg, lmax_gate=lm)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y)
    with pytest.raises(ValueError, match="expected 3 tiers"):
        tbf.bam_eps_update_replicas(e, v, mu, f, 0.7, tiers[:2])


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
    tbf._TIER_TABLES.clear()
    yield rec
    tfs.reset_launch_counts()
    tbf._TIER_TABLES.clear()


@pytest.mark.parametrize("k,b,d", [(1, 2, 10), (8, 32, 256), (8, 56, 256),
                                   (8, 128, 256), (3, 57, 33)])
def test_replica_k7_launches_one_sequence_for_all_replicas(card, k, b, d):
    """The eight launches of one K7 call, each with the replica count K
    (the thin products' replica axis, the small space's blockIdx.y, the
    apply's batch, one finalize block per replica, the select's grid.y),
    the small space reading the tier table; counted once."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    tiers = [tbf.BAM_NS_TIERS[i % 4] for i in range(k)]
    tbf.bam_eps_update_replicas(z(k, b, d), z(k, b, d), z(k, d), z(k, d, d),
                                0.5, tiers, ef=z(k, b, d))
    small = ("gsmvi_bam_smallspace_panel" if b > tbf.BAM_SHARED_MAX_B
             else "gsmvi_bam_smallspace_cluster")
    assert [n for n, _ in card.calls] == [
        "gsmvi_thin_rows", "gsmvi_thin_rows", small, "gsmvi_bam_apply",
        "gsmvi_thin_rows", "gsmvi_thin_rows", "gsmvi_bam_finalize",
        "gsmvi_bam_select"]
    for args in card.named("gsmvi_thin_rows"):
        assert args[9] == k                            # replicas
    (ss,) = card.named(small)
    assert ss[11].value is None                        # no halt word
    assert ss[-2] == k and ss[-3].value is not None    # reps, tier table
    (apply,) = card.named("gsmvi_bam_apply")
    assert apply[6:9] == (2 * (b + 1), d, k)
    (fin,) = card.named("gsmvi_bam_finalize")
    assert fin[8] == 0 and fin[-3:-1] == (d, k)
    (sel,) = card.named("gsmvi_bam_select")
    assert sel[4:6] == (d * d, k)
    counts = tfs.launch_counts()
    assert counts["bam_eps_update_replicas"] == 1
    assert counts["bam_eps_update_fused"] == 0
    table = next(iter(tbf._TIER_TABLES.values()))
    assert table.shape == (k, tbf.TIER_STRIDE)
    assert table[0].tolist() == [*tiers[0][0], tiers[0][2], tiers[0][1], 0.0]


def test_single_k7_launches_keep_one_replica(card):
    """The single K7 call launches with one replica and no tier table."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    tbf.bam_eps_update_fused(z(4, 9), z(4, 9), z(9), z(9, 9), 0.5)
    (ss,) = card.named("gsmvi_bam_smallspace_cluster")
    assert ss[-2] == 1 and ss[-3].value is None
    (apply,) = card.named("gsmvi_bam_apply")
    assert apply[8] == 1
    assert not tbf._TIER_TABLES


def test_tier_tables_are_held_and_bounded(card, monkeypatch):
    monkeypatch.setattr(tbf, "TIER_TABLES_MAX", 2)
    t1 = tbf.tier_table([tbf.BAM_NS_TIERS[0]] * 2, "cpu")
    assert tbf.tier_table([tbf.BAM_NS_TIERS[0]] * 2, "cpu") is t1
    tbf.tier_table([tbf.BAM_NS_TIERS[1]] * 2, "cpu")
    tbf.tier_table([tbf.BAM_NS_TIERS[2]] * 2, "cpu")
    assert len(tbf._TIER_TABLES) == 2
    assert tbf.tier_table([tbf.BAM_NS_TIERS[0]] * 2, "cpu") is not t1
