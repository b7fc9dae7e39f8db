"""FactorGSM's ``method="twophase"`` and ``"qr"`` against the JAX package
on the CPU: the step statistics (``factor_gsm_step_stats``, ``_v2``), the
Newton refresh, the QR sign freedom, ``refresh_every``'s cadence, fits on
JAX's draws and to convergence, ``fit_batch`` and checkpoints with Finv.

Tolerances: one step in float64 on the same (samples, vs, mu0, F, Finv)
within 1e-10 x max(1, |x|) (LAPACK's QR, eigh and solves in another
order); a 40-step fit on JAX's draws within 1e-8; converged moments
within the JAX package's own recovery bounds (tests/test_gsm_factor.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.gsm_factor as t_gf
import gsmvi_tpu_torch.ops.gsm_factor as t_ops
from gsmvi_tpu import FactorGSM as JFactorGSM
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.ops import gsm_factor as j_ops
from gsmvi_tpu_torch import FactorGSM, load_state, save_state
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
STEP_TOL = 1e-10
FIT_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_inputs(seed, b, d):
    """(samples, vs, mu0, F, Finv) in float64: a non-triangular factor, a
    Gaussian score, samples from N(mu0, F F^T)."""
    rng = np.random.default_rng(seed)
    f = np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    finv = np.linalg.inv(f)
    mu0 = rng.standard_normal(d)
    x = mu0 + rng.standard_normal((b, d)) @ f.T
    prec = np.eye(d) * 0.7
    vs = (0.2 - x) @ prec
    return x, vs, mu0, f, finv


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


STEPS = {"qr": (t_ops.factor_gsm_step_stats, j_ops.factor_gsm_step_stats),
         "twophase": (t_ops.factor_gsm_step_stats_v2,
                      j_ops.factor_gsm_step_stats_v2)}


@pytest.mark.parametrize("method", ["qr", "twophase"])
@pytest.mark.parametrize("d", [10, 64])
@pytest.mark.parametrize("b", [2, 8, 32])
def test_step_stats_match_jax(method, d, b):
    """One step of each method, float64, against JAX on the same inputs
    (at D=10, B=32 the QR's k = min(D, 2B) = D)."""
    inputs = _step_inputs(100 * d + b, b, d)
    mine, theirs = STEPS[method]
    got = mine(*map(torch.from_numpy, inputs))
    want = theirs(*map(jnp.asarray, inputs))
    assert bool(got[3]) == bool(want[3])
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, STEP_TOL)
    # The step's factor and inverse stay consistent.
    if bool(got[3]):
        eye = torch.eye(d, dtype=torch.float64)
        assert torch.allclose(got[2] @ got[1], eye, atol=1e-9)


@pytest.mark.parametrize("d", [10, 64])
def test_refresh_matches_jax(d):
    rng = np.random.default_rng(d)
    f = np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    finv = np.linalg.inv(f) + 1e-4 * rng.standard_normal((d, d))
    for steps in (1, 2, 3):
        got = t_ops.factor_refresh(torch.from_numpy(f),
                                   torch.from_numpy(finv), steps)
        want = j_ops.factor_refresh(jnp.asarray(f), jnp.asarray(finv), steps)
        _close(got, want, STEP_TOL)
    # Quadratic convergence: two steps square the residual twice.
    res = lambda inv: float(np.abs(np.eye(d) - f @ inv).max())
    assert res(t_ops.factor_refresh(torch.from_numpy(f),
                                    torch.from_numpy(finv)).numpy()) \
        < 10 * res(finv) ** 4 + 1e-13


def test_qr_sign_conventions_cancel(monkeypatch):
    """Q -> Q S, R -> S R (S a diagonal of signs, the freedom of any QR)
    leaves F' and Finv' unchanged: W -> S W S, C -> S C S, Q C Q^T the
    same.  Both packages' LAPACK QRs may pick other signs; the step does
    not see them."""
    inputs = tuple(map(torch.from_numpy, _step_inputs(5, 8, 20)))
    want = t_ops.factor_gsm_step_stats(*inputs)
    real_qr = torch.linalg.qr
    signs = torch.tensor([(-1.0) ** (i * i // 3) for i in range(16)],
                         dtype=torch.float64)

    def flipped(p):
        q, r = real_qr(p)
        return q * signs, signs[:, None] * r

    monkeypatch.setattr(t_ops.torch.linalg, "qr", flipped)
    got = t_ops.factor_gsm_step_stats(*inputs)
    assert bool(got[3]) == bool(want[3])
    for g, w in zip(got[:3], want[:3]):
        assert torch.allclose(g, w, rtol=0, atol=1e-12)


def test_indefinite_downdate_is_rejected_by_both():
    """A huge score drives the proposal indefinite: ``good`` is False in
    both methods, as in JAX."""
    d, b = 4, 1
    x = np.ones((b, d))
    v = 100.0 * np.ones((b, d))
    inputs = (x, v, np.zeros(d), np.eye(d), np.eye(d))
    for mine, theirs in STEPS.values():
        got = mine(*map(torch.from_numpy, inputs))
        want = theirs(*map(jnp.asarray, inputs))
        assert bool(got[3]) == bool(want[3])


def _targets(seed, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = 0.6 * np.eye(d) + 0.3 * a @ a.T / d
    mean = rng.standard_normal(d)
    return (_gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g"),
            gaussian_target_from_arrays(mean, cov, device=DEV))


def _split_chain_draws(key, n, b, d):
    """JAX's draws on the methods' XLA step: ``key, ks = split(key)``, then
    ``normal(ks, (B, D))`` per step (gsmvi_tpu/gsm_factor.py:420-421)."""
    draws = []
    for _ in range(n):
        key, ks = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(ks, (b, d), jnp.float64)))
    return draws


@pytest.mark.parametrize("method", ["qr", "twophase"])
@pytest.mark.parametrize("refresh_every", [0, 7])
def test_fit_on_jax_draws_matches_jax(method, refresh_every):
    """A 40-step fit of each method, float64, fed JAX's draws, against JAX
    ``FactorGSM(method=m, refresh_every=r)``: mean, F and Finv within
    1e-8 (with and without Finv's refresh)."""
    d, b, niter = 8, 4, 39
    tj, tt = _targets(1, d)
    key = jax.random.PRNGKey(7)
    sj = JFactorGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float64,
                    method=method, refresh_every=refresh_every).fit(
        key, batch_size=b, niter=niter, verbose=False, return_state=True)
    draws = _split_chain_draws(key, niter + 1, b, d)
    fg = FactorGSM(d, tt.lp, tt.lp_g, dtype=torch.float64, method=method,
                   refresh_every=refresh_every, device=DEV)
    fg._eps = lambda seed, step, batch, dd, dtype: torch.tensor(draws[step])
    st = fg.fit(0, batch_size=b, niter=niter, verbose=False,
                return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    for got, want in ((st.mean, sj.mean), (st.factor, sj.factor),
                      (st.finv, sj.finv)):
        _close(got, want, FIT_TOL)


@pytest.mark.parametrize("method", ["qr", "twophase"])
def test_fits_converge_as_jax_does(method):
    """JAX's recovery test configuration (D=10, B=8, 500 steps,
    tests/test_gsm_factor.py::test_e2e_recovery) on both methods in
    float32, the port and JAX each on its own draws: both within JAX's
    bounds of the target, 1e-3 on the mean and 1e-2 on the covariance
    (relative to max|cov|)."""
    d = 10
    t = dense_gaussian(3, d, scale=0.3, device=DEV)
    mean, cov = FactorGSM(d, t.lp, t.lp_g, method=method, device=DEV).fit(
        99, niter=500, batch_size=8, verbose=False)
    scale = float(t.cov.abs().max())
    assert torch.allclose(mean, t.mean, atol=1e-3 * max(1.0, scale))
    assert torch.allclose(cov, t.cov, atol=1e-2 * scale)
    tj = _gaussian_target(jnp.asarray(t.mean.numpy()),
                          jnp.asarray(t.cov.numpy()), "g")
    mj, cj = JFactorGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float32,
                        method=method).fit(jax.random.PRNGKey(99), niter=500,
                                           batch_size=8, verbose=False)
    np.testing.assert_allclose(np.asarray(mj), t.mean.numpy(),
                               atol=1e-3 * max(1.0, scale))
    np.testing.assert_allclose(np.asarray(cj), t.cov.numpy(),
                               atol=1e-2 * scale)


def test_refresh_fires_at_its_cadence(monkeypatch):
    """Finv's refresh runs after every ``refresh_every``-th step (absolute
    step + 1 a multiple of it), whatever the chunking, and never at 0."""
    calls = []
    real = t_gf.factor_refresh

    def spy(f, finv):
        calls.append(len(calls))
        return real(f, finv)

    monkeypatch.setattr(t_gf, "factor_refresh", spy)
    d, b = 6, 4
    t = dense_gaussian(2, d, scale=0.3, device=DEV)
    for every, niter, want in ((5, 22, 4), (1, 9, 10), (0, 30, 0)):
        calls.clear()
        FactorGSM(d, t.lp, t.lp_g, method="qr", refresh_every=every,
                  device=DEV).fit(0, niter=niter, batch_size=b, nprint=3,
                                  verbose=True)
        assert len(calls) == want, (every, niter)


def test_methods_take_no_kernel(monkeypatch):
    """JAX has no Pallas kernel for these methods: on the card they run
    torch's own ops, and use_fused=True with one raises."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    d = 6
    t = dense_gaussian(2, d, scale=0.3, device=DEV)
    for method in ("qr", "twophase"):
        fg = FactorGSM(d, t.lp, t.lp_g, method=method,
                       fused_score=t.fused_score, device=DEV)
        assert fg._fused_mode(4) is None
        assert fg._batch_mode(4, "fused") is None
        with pytest.raises(ValueError, match="no kernel"):
            FactorGSM(d, t.lp, t.lp_g, method=method, use_fused=True,
                      device=DEV)
    eps = FactorGSM(d, t.lp, t.lp_g, device=DEV)
    assert eps._fused_mode(4) == "update"


@pytest.mark.parametrize("method", ["qr", "twophase"])
def test_fit_batch_replicas_equal_single_fits(method):
    """``fit_batch`` runs the method's step per replica (JAX vmaps it,
    gsmvi_tpu/gsm_factor.py:663-680): each replica, Finv included, equals
    its single fit bit for bit; the initial Finv is the triangular inverse
    of each replica's Cholesky factor."""
    d, b, seeds = 6, 4, (0, 3)
    t = dense_gaussian(4, d, scale=0.3, device=DEV)
    fg = FactorGSM(d, t.lp, t.lp_g, method=method, refresh_every=5,
                   device=DEV)
    cov0 = 1.5 * torch.eye(d)
    batch = fg.fit_batch(seeds, cov=cov0, batch_size=b, niter=12,
                         return_state=True, small_solver="fused")
    for i, s in enumerate(seeds):
        one = fg.fit(s, cov=cov0, batch_size=b, niter=12, verbose=False,
                     return_state=True)
        for name in ("mean", "factor", "finv", "n_accepted"):
            assert torch.equal(getattr(batch, name)[i], getattr(one, name))


def test_finv_initialises_as_jax_and_checkpoints(tmp_path):
    """Finv starts as the triangular inverse of chol(cov) (JAX's
    solve_triangular, gsmvi_tpu/gsm_factor.py:492-498), the eps method
    carries none, and a saved method state resumes exactly."""
    d, b = 6, 4
    t = dense_gaussian(6, d, scale=0.3, dtype=np.float64, device=DEV)
    cov0 = np.diag(np.arange(1.0, d + 1.0)) + 0.1
    fg = FactorGSM(d, t.lp, t.lp_g, method="twophase", refresh_every=4,
                   dtype=torch.float64, device=DEV)
    s0 = fg.fit(1, cov=cov0, batch_size=b, niter=-1, verbose=False,
                return_state=True)
    jf0 = jnp.linalg.cholesky(jnp.asarray(cov0))
    jfinv0 = jax.scipy.linalg.solve_triangular(jf0, jnp.eye(d), lower=True)
    _close(s0.finv, jfinv0, 1e-12)
    assert FactorGSM(d, t.lp, t.lp_g, dtype=torch.float64, device=DEV).fit(
        1, niter=-1, verbose=False, return_state=True).finv is None
    full = fg.fit(1, cov=cov0, batch_size=b, niter=20, verbose=False,
                  return_state=True)
    half = fg.fit(1, cov=cov0, batch_size=b, niter=9, verbose=False,
                  return_state=True)
    save_state(str(tmp_path / "ck"), half)
    loaded = load_state(str(tmp_path / "ck"), device=DEV)
    assert torch.equal(loaded.finv, half.finv)
    res = fg.fit(1, batch_size=b, niter=10, verbose=False,
                 return_state=True, state=loaded)
    assert res.step == full.step == 21
    for name in ("mean", "factor", "finv"):
        assert torch.equal(getattr(res, name), getattr(full, name))
