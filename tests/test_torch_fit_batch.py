"""K replica fits in one call (``fit_batch``) against single fits and the
JAX package, mirroring ``tests/test_fit_batch.py``.

The kernel routes (batched K1 for "auto", K6 for "fused", batched K5 for
the dense route) run on the CPU by monkeypatching the port's ``on_gpu``:
the wrappers then run their plain versions, one replica at a time, on the
CPU tensors they are given.  Replica i draws what ``fit(seeds[i])`` draws,
so it reproduces that fit; the JAX side is K6 in interpret mode on its own
``fold_in`` draws (float32, sums in other orders: 1e-5 * max(1, |x|) over
45 chained steps at D=8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.gsm as t_gsm
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu.ops.pallas import batch_fused as jbf
from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch import GSM, FactorGSM, VIState
from gsmvi_tpu_torch.driver import broadcast_replicas
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import batch_fused as tbf
from gsmvi_tpu_torch.ops import fused_step as tfs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
SEEDS = (4, 0, 9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make GSM and FactorGSM take their kernel routes on the CPU."""
    monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)


def _fitter(route, t, d):
    if route.startswith("dense"):
        return GSM(d, t.lp, t.lp_g, use_factor=False, device=DEV)
    return FactorGSM(d, t.lp, t.lp_g, steps_per_call=4, device=DEV,
                     fused_score=t.fused_score if route == "fused" else None)


@pytest.mark.parametrize("route", ["dense", "dense_k5", "chol", "auto",
                                   "fused"])
def test_replica_equals_single_fit(route, monkeypatch):
    """Replica j of fit_batch is fit(seeds[j]) bit for bit on every route;
    45 steps is not a multiple of spc=4, so K6's masked remainder runs."""
    d, b, niter = 16, 8, 44
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    if route in ("dense_k5", "auto", "fused"):
        monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)
        monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    g = _fitter(route, t, d)
    kw = {} if route.startswith("dense") else {"small_solver": route}
    if route != "chol" and not route.startswith("dense"):
        assert g._batch_mode(b, route) == {"auto": "update",
                                           "fused": "step"}[route]
    st = g.fit_batch(SEEDS, batch_size=b, niter=niter, return_state=True,
                     **kw)
    assert st.mean.shape == (3, d) and st.step == niter + 1
    assert st.seed == SEEDS and st.n_accepted.shape == (3,)
    for j, seed in enumerate(SEEDS):
        s = g.fit(seed, batch_size=b, niter=niter, verbose=False,
                  return_state=True)
        assert torch.equal(st.mean[j], s.mean)
        f_b, f_s = (st.cov, s.cov) if route.startswith("dense") else (
            st.factor, s.factor)
        assert torch.equal(f_b[j], f_s)
        assert int(st.n_accepted[j]) == int(s.n_accepted)


@pytest.mark.parametrize("fitter", ["dense", "factor"])
def test_per_replica_warm_starts(fitter):
    """A (K, D) mean and (K, D, D) cov start each replica where given:
    replica j equals fit(seed_j, mean_j, cov_j), and the replica started
    at the target stays there."""
    d, b, niter = 16, 8, 49
    t = dense_gaussian(3, d, scale=0.3, device=DEV)
    g = _fitter("dense" if fitter == "dense" else "chol", t, d)
    means0 = torch.stack([torch.zeros(d), t.mean])
    covs0 = torch.stack([torch.eye(d), t.cov])
    means, covs = g.fit_batch((0, 1), mean=means0, cov=covs0, batch_size=b,
                              niter=niter)
    np.testing.assert_allclose(means[1].numpy(), t.mean.numpy(), atol=5e-3)
    for j in range(2):
        m, c = g.fit(j, mean=means0[j], cov=covs0[j], batch_size=b,
                     niter=niter, verbose=False)
        np.testing.assert_allclose(means[j].numpy(), m.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(covs[j].numpy(), c.numpy(), rtol=0,
                                   atol=1e-6 * float(c.abs().max()))


def _k6_problem(seed, k, b, d):
    rng = np.random.default_rng(seed)
    mean_t = rng.uniform(size=(1, d)).astype(np.float32)
    l = 0.5 * rng.standard_normal((d, d))
    prec = np.linalg.inv(l @ l.T + 0.5 * np.eye(d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return mean_t, prec, keys


def _fold_in_blocks(keys, start, spc, b, d):
    """(K, spc*B, D): replica i's draws for steps start..start+spc-1, as
    the JAX fused path draws them (normal(fold_in(key_i, step)))."""
    return np.stack([np.concatenate([
        np.asarray(jax.random.normal(jax.random.fold_in(kk, start + j),
                                     (b, d), jnp.float32))
        for j in range(spc)]) for kk in keys])


def _run_k6(step, niter, spc, blocks_fn, means, factors, params):
    """Chain K6 calls over niter + 1 steps (a masked remainder last)."""
    acc = 0
    for start in range(0, niter + 1, spc):
        nmax = min(spc, niter + 1 - start)
        means, factors, n = step(nmax, blocks_fn(start), means, factors,
                                 *params)
        acc = acc + np.asarray(n)
    return means, factors, acc


@pytest.mark.parametrize("reject", [False, True])
def test_k6_plain_matches_jax_interpret_kernel(reject):
    """K6's plain version against JAX make_fused_eps_batch_multistep in
    interpret mode, K=3, B=8, D=8, spc=4, 45 steps on fold_in draws; with
    ``reject`` one replica's draws at one sub-step are scaled over three
    decades, so the residual gates reject it there and only there, on both
    sides, while the other replicas accept every step."""
    k, b, d, spc, niter = 3, 8, 8, 4, 44
    mean_t, prec, keys = _k6_problem(11, k, b, d)

    def blocks(start):
        blk = _fold_in_blocks(keys, start, spc, b, d)
        if reject and start == 20:
            blk[1, 2 * b:3 * b] *= np.logspace(0.0, 3.0, b)[:, None]
        return blk

    jstep = jbf.make_fused_eps_batch_multistep(
        jfs.gaussian_score_kernel, 2, b, d, k, spc, interpret=True)
    tstep = tbf.make_fused_eps_batch_multistep(tfs.gaussian_score, 2, b, d,
                                               k, spc)
    m0 = np.zeros((k, d), np.float32)
    f0 = np.tile(np.eye(d, dtype=np.float32), (k, 1, 1))
    mj, fj, nj = _run_k6(
        jstep, niter, spc, lambda s: jnp.asarray(blocks(s)), jnp.asarray(m0),
        jnp.asarray(f0), (jnp.asarray(mean_t), jnp.asarray(prec)))
    mt, ft, nt = _run_k6(
        tstep, niter, spc, lambda s: torch.from_numpy(blocks(s)),
        torch.from_numpy(m0), torch.from_numpy(f0),
        (torch.from_numpy(mean_t), torch.from_numpy(prec)))
    want = [niter + 1] * k
    if reject:
        want[1] -= 1
    assert nt.tolist() == nj.tolist() == want
    for got, ref in ((mt, mj), (ft, fj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * max(
            1.0, float(np.abs(ref).max())))


def test_k6_rejection_leaves_other_replicas_untouched():
    """A rejected sub-step of one replica changes no other replica: each
    equals K2 run on that replica alone, bit for bit."""
    k, b, d, spc = 3, 8, 16, 4
    mean_t, prec, _ = _k6_problem(12, k, b, d)
    params = (torch.from_numpy(mean_t), torch.from_numpy(prec))
    rng = np.random.default_rng(13)
    blocks = rng.standard_normal((k, spc * b, d)).astype(np.float32)
    blocks[0, b:2 * b] *= np.logspace(0.0, 3.0, b)[:, None]
    blocks = torch.from_numpy(blocks)
    means, factors = torch.zeros(k, d), torch.eye(d).repeat(k, 1, 1)
    step = tbf.make_fused_eps_batch_multistep(tfs.gaussian_score, 2, b, d,
                                              k, spc)
    m, f, n = step(spc, blocks, means, factors, *params)
    assert n.tolist() == [spc - 1, spc, spc]
    single = tfs.make_fused_eps_multistep(tfs.gaussian_score, 2, b, d, spc)
    for i in range(k):
        mi, fi, ni = single(spc, blocks[i], means[i], factors[i], *params)
        assert torch.equal(m[i], mi) and torch.equal(f[i], fi)
        assert int(ni) == int(n[i])


def test_gsm_fit_batch_routes_and_state_conversion(kernel_paths):
    """GSM.fit_batch on the card delegates to FactorGSM.fit_batch (as fit
    does) and hands back a stacked VIState; use_factor=False and the
    huge-batch guard keep the dense route."""
    d, b = 16, 8
    t = dense_gaussian(5, d, scale=0.3, device=DEV)
    g = GSM(d, t.lp, t.lp_g, device=DEV)
    means, covs = g.fit_batch(SEEDS, batch_size=b, niter=60)
    m_ref, c_ref = g._get_factor_fitter().fit_batch(SEEDS, batch_size=b,
                                                    niter=60)
    assert torch.equal(means, m_ref) and torch.equal(covs, c_ref)
    st = g.fit_batch(SEEDS, batch_size=b, niter=10, return_state=True)
    assert isinstance(st, VIState) and st.seed == SEEDS and st.step == 11
    assert st.cov.shape == (3, d, d) and st.chol.shape == (3, d, d)
    assert torch.isfinite(st.chol).all()
    dense = GSM(d, t.lp, t.lp_g, use_factor=False, device=DEV)
    m_d, _ = dense.fit_batch(SEEDS, batch_size=b, niter=300)
    np.testing.assert_allclose(m_d[0].numpy(), t.mean.numpy(), atol=0.05)
    assert not g._factor_route(128) and g._dense_fused(128)


def test_fit_batch_gates(kernel_paths, monkeypatch):
    """On the card "fused" without fused_score raises (the JAX package
    falls back silently); a bad small_solver or replica stack raises; off
    the card "fused" is the plain step."""
    d = 16
    t = dense_gaussian(5, d, scale=0.3, device=DEV)
    g = FactorGSM(d, t.lp, t.lp_g, device=DEV)
    with pytest.raises(ValueError, match="fused_score"):
        g.fit_batch((0, 1), batch_size=8, niter=2, small_solver="fused")
    with pytest.raises(ValueError, match="small_solver"):
        g.fit_batch((0, 1), batch_size=8, niter=2, small_solver="qr")
    with pytest.raises(ValueError, match=r"B in \[1, 512\]"):
        g.fit_batch((0, 1), batch_size=513, niter=2)
    assert g._batch_mode(513, "chol") is None
    with pytest.raises(ValueError, match="expected"):
        broadcast_replicas(torch.zeros(3, d), None, 2, (d,), torch.float32,
                           DEV)
    with pytest.warns(UserWarning, match="fused_score is set"):
        GSM(d, t.lp, t.lp_g, use_factor=False, fused_score=t.fused_score,
            device=DEV).fit_batch((0,), batch_size=8, niter=1)
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: False)
    assert g._batch_mode(8, "fused") is None
