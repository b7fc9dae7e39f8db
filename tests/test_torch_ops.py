"""Exact algebra of the port against the JAX package, float64 on both sides.

Inputs are made with numpy from a seed and handed to both packages (the
conftest turns JAX x64 on).  The algebra is identical and only the order of
sums differs, so float64 results agree to ~1e-12 relative; the tests allow
1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu import distributions as jdist
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.ops import gsm as jgsm
from gsmvi_tpu.ops import gsm_eps as jeps
from gsmvi_tpu.ops.gsm_factor import factor_to_cov as j_factor_to_cov
from gsmvi_tpu_torch import distributions as tdist
from gsmvi_tpu_torch import state as tstate
from gsmvi_tpu_torch.models import gaussian_target_from_arrays, make_target
from gsmvi_tpu_torch.ops import gsm as tgsm
from gsmvi_tpu_torch.ops import gsm_eps as teps
from gsmvi_tpu_torch.ops.gsm_factor import factor_to_cov

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, d, shift=1.0):
    a = rng.standard_normal((d, d))
    return a @ a.T / d + shift * np.eye(d)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def test_gsm_update_stats_matches_jax():
    rng = np.random.default_rng(0)
    b, d = 6, 10
    s0 = _spd(rng, d)
    mu0 = rng.standard_normal(d)
    x = mu0 + rng.standard_normal((b, d)) @ np.linalg.cholesky(s0).T
    v = rng.standard_normal((b, d))
    dmu_t, ds_t = tgsm.gsm_update_stats(*map(torch.from_numpy, (x, v, mu0, s0)))
    dmu_j, ds_j = jgsm.gsm_update_stats(*map(jnp.asarray, (x, v, mu0, s0)))
    _close(dmu_t, dmu_j)
    _close(ds_t, ds_j)
    mu_t, s_t = tgsm.gsm_update(*map(torch.from_numpy, (x, v, mu0, s0)))
    mu_j, s_j = jgsm.gsm_update(*map(jnp.asarray, (x, v, mu0, s0)))
    _close(mu_t, mu_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("b,d", [(4, 32), (8, 12)], ids=["2B<D", "2B>=D"])
def test_apply_eps_step_matches_jax(b, d):
    """Both regimes of the exact eps step: the (2B)^2 small-space route with
    its two triangular solves (``trans=1`` in JAX), and the direct D x D
    factorisation when 2B >= D."""
    rng = np.random.default_rng(b * d)
    f = np.linalg.cholesky(_spd(rng, d))
    mu = rng.standard_normal(d)
    eps = rng.standard_normal((b, d))
    v = 0.5 * rng.standard_normal((b, d))
    m_t, f_t, g_t = teps.apply_eps_step(*map(torch.from_numpy, (mu, f, eps, v)))
    m_j, f_j, g_j = jeps.apply_eps_step(*map(jnp.asarray, (mu, f, eps, v)))
    assert bool(g_t) == bool(g_j) is True
    _close(m_t, m_j)
    _close(f_t, f_j, 1e-9)
    # The new factor carries the GSM covariance update exactly.
    x = mu + eps @ f.T
    _, s_ref = jgsm.gsm_update(*map(jnp.asarray, (x, v, mu, f @ f.T)))
    _close(factor_to_cov(f_t), s_ref, 1e-9)


@pytest.mark.parametrize("down_scale,pd", [(0.1, True), (3.0, False)])
def test_eps_core_triangular_solves_match_jax(down_scale, pd):
    """The small core with both triangular solves, and its exact PD flag
    on a downdate small enough (PD) and too large (not PD)."""
    rng = np.random.default_rng(3)
    zt = 0.3 * rng.standard_normal((8, 20))
    zt[4:] *= down_scale
    s2_t, g_t = teps.eps_core(torch.from_numpy(zt), 4)
    s2_j, g_j = jeps.eps_core(jnp.asarray(zt), 4)
    assert bool(g_t) == bool(g_j) == pd
    _close(s2_t, s2_j, 1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eps_core_rejects_a_gram_it_cannot_factor(dtype):
    """An update row and its downdate row nearly parallel (as c_b and eps_b
    become near a fit's end) with a jitter below G's smallest eigenvalue:
    G's Cholesky fails at its last pivot while K = I + Lg^T J Lg of the
    partial factor would pass.  JAX's NaN factor rejects the step; so must
    the port, never passing the partial factor's S2 as good."""
    rng = np.random.default_rng(1)
    b, d, jitter = 4, 16, -1e-4
    zt = rng.standard_normal((2 * b, d)) / np.sqrt(d)
    zt[-1] = zt[b - 1] + 1e-2 * rng.standard_normal(d) / np.sqrt(d)
    zt = zt.astype(dtype)
    g = zt.astype(np.float64) @ zt.T.astype(np.float64)
    g += jitter * (np.trace(g) / (2 * b) + 1.0) * np.eye(2 * b)
    info = torch.linalg.cholesky_ex(torch.from_numpy(g))[1]
    assert int(info) == 2 * b          # only the last pivot fails
    _, g_t = teps.eps_core(torch.from_numpy(zt), b, jitter)
    _, g_j = jeps.eps_core(jnp.asarray(zt), b, jitter)
    assert bool(g_t) == bool(g_j) is False


def test_factor_to_cov_and_safe_cholesky_match_jax():
    rng = np.random.default_rng(1)
    f = rng.standard_normal((7, 7))
    _close(factor_to_cov(torch.from_numpy(f)), j_factor_to_cov(jnp.asarray(f)))
    s = _spd(rng, 7)
    _close(tdist.safe_cholesky(torch.from_numpy(s), jitter=1e-3),
           jdist.safe_cholesky(jnp.asarray(s), jitter=1e-3))
    bad = s - 10.0 * np.eye(7)
    l_t = tdist.safe_cholesky(torch.from_numpy(bad))
    l_j = jdist.safe_cholesky(jnp.asarray(bad))
    assert not torch.isfinite(l_t).all()
    assert not np.isfinite(np.asarray(l_j)).all()
    # Batched input: only the non-PD member is masked.
    both = tdist.safe_cholesky(torch.from_numpy(np.stack([s, bad])))
    assert torch.isfinite(both[0]).all() and torch.isnan(both[1]).all()


def test_mvn_logpdf_and_sample_match_jax():
    rng = np.random.default_rng(2)
    d = 5
    s = _spd(rng, d)
    chol = np.linalg.cholesky(s)
    mean = rng.standard_normal(d)
    x = rng.standard_normal((3, 4, d))
    _close(tdist.mvn_logpdf(*map(torch.from_numpy, (x, mean, chol))),
           jdist.mvn_logpdf(*map(jnp.asarray, (x, mean, chol))))
    gen = torch.Generator().manual_seed(0)
    draws = tdist.mvn_sample(gen, torch.from_numpy(mean),
                             torch.from_numpy(chol), 20000)
    np.testing.assert_allclose(np.cov(draws.numpy().T), s, atol=0.06)


def test_gaussian_target_from_arrays_matches_jax_target():
    """Built from the same numpy arrays, both packages hold identical
    precision matrices (f64 inverse on the host, cast once) and give the
    same lp, lp_g and kernel-score pair."""
    rng = np.random.default_rng(4)
    d = 6
    for dtype in (np.float32, np.float64):
        mean = rng.uniform(size=d).astype(dtype)
        cov = _spd(rng, d, 1e-2).astype(dtype)
        t_t = gaussian_target_from_arrays(mean, cov, device=DEV)
        t_j = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
        prec_t = t_t.fused_score[1][1]
        assert prec_t.dtype == torch.from_numpy(mean).dtype
        np.testing.assert_array_equal(prec_t.numpy(),
                                      np.asarray(t_j.pallas_score[1][1]))
        if dtype is np.float64:
            x = rng.standard_normal((3, d))
            _close(t_t.lp(torch.from_numpy(x)), t_j.lp(jnp.asarray(x)))
            _close(t_t.lp_g(torch.from_numpy(x)), t_j.lp_g(jnp.asarray(x)))
            score_fn, params = t_t.fused_score
            _close(score_fn(torch.from_numpy(x), *params),
                   t_j.lp_g(jnp.asarray(x)))


def test_make_target_autodiff_score():
    mean = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    t = make_target(lambda x: -0.5 * torch.sum((x - mean) ** 2, dim=-1), 3)
    x = torch.zeros((4, 3), dtype=torch.float64)
    np.testing.assert_allclose(t.lp_g(x).numpy(),
                               np.broadcast_to(mean.numpy(), (4, 3)))
    assert float(t.lp(x)) == pytest.approx(-0.5 * 4 * float(mean @ mean))


def test_states_init_accept_revert_and_from_numpy():
    s = tstate.init_state(5, 3, dtype=torch.float64, device=DEV)
    assert s.seed == 5 and s.step == 0 and int(s.n_accepted) == 0
    np.testing.assert_array_equal(s.chol.numpy(), np.eye(3))
    good = tstate.accept_or_revert(s, s.mean + 1.0, 2.0 * s.cov)
    assert good.step == 1 and int(good.n_accepted) == 1
    np.testing.assert_allclose(good.chol.numpy(), np.sqrt(2.0) * np.eye(3))
    bad = tstate.accept_or_revert(good, good.mean + 1.0, -good.cov)
    assert bad.step == 2 and int(bad.n_rejected) == 1
    np.testing.assert_array_equal(bad.mean.numpy(), good.mean.numpy())
    np.testing.assert_array_equal(bad.cov.numpy(), good.cov.numpy())

    mean = np.arange(3, dtype=np.float32)
    factor = np.tril(np.ones((3, 3), np.float32))
    fs = tstate.factor_state_from_numpy(mean, factor, 9, 40, 38, 2,
                                        device=DEV)
    assert fs.mean.dtype == torch.float32 and fs.seed == 9 and fs.step == 40
    assert int(fs.n_accepted) == 38 and fs.n_accepted.dtype == torch.int32
    np.testing.assert_array_equal(fs.cov.numpy(), factor @ factor.T)
