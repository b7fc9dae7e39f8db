"""The zoo's non-Gaussian targets (funnel, banana, Student-t) and their K11a
score pairs against the JAX package, on the CPU.

The same numpy-made inputs go through both packages.  Funnel and banana are
built from the same scalars on both sides; the port's Student-t comes from
the JAX target's own arrays (``student_t_from_arrays`` with JAX's ``prec``).
The JAX score kernels are plain jnp functions, called as such; its
whole-step kernel runs in interpret mode, as ``tests/test_pallas.py`` runs
it.  Tolerances: float32 scores within 1e-5 (rtol and atol) of JAX's; the
analytic twins within 2e-4 of autodiff (``tests/test_models.py:116``) and
float64 finite differences within 1e-4 (``:25``); one whole step within
1e-4 on the mean and 2e-4 * max(1, max|S|) on S = F F^T
(``tests/test_pallas.py:42-84``); a 100-step FactorGSM trajectory within
1e-4 (mean) and 1e-4 * max|F| (factor), as
``tests/test_torch_fit.py::test_step_runner_matches_jax_fused_fit`` holds
the Gaussian's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.gsm_factor as j_gf
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu import FactorGSM as JFactorGSM
from gsmvi_tpu.models import banana as j_banana
from gsmvi_tpu.models import funnel as j_funnel
from gsmvi_tpu.models.student_t import student_t as j_student_t
from gsmvi_tpu.ops.pallas.fused_step import make_fused_eps_step as j_step
from gsmvi_tpu_torch import FactorGSM
from gsmvi_tpu_torch.models import (banana, funnel, student_t,
                                    student_t_from_arrays)
from gsmvi_tpu_torch.ops import fused_step as tfs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
NAMES = ["funnel", "banana", "student_t"]
DF = 6.0
TWINS = {"funnel": tfs.funnel_score_reference,
         "banana": tfs.banana_score_reference,
         "student_t": tfs.student_t_score_reference}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_student_t(jt, dtype=np.float32):
    """The port's Student-t on the JAX target's arrays: loc, the scale
    matrix (cov (df-2)/df) and JAX's own precision."""
    sigma = np.asarray(jt.cov, np.float64) * (DF - 2.0) / DF
    return student_t_from_arrays(np.asarray(jt.mean).astype(dtype), sigma,
                                 DF, prec=np.asarray(jt.pallas_score[1][1]),
                                 device=DEV)


def _pair(name, d, dtype=np.float32):
    """(JAX target, port target) of the same density at dimension d."""
    if name == "funnel":
        return j_funnel(d), funnel(d, device=DEV)
    if name == "banana":
        return j_banana(d), banana(d, device=DEV)
    jt = j_student_t(jax.random.PRNGKey(2), d, df=DF)
    return jt, _port_student_t(jt, dtype)


def _dim(name):
    return 8 if name == "student_t" else 5


def _f32(params):
    return [np.asarray(p, np.float32) for p in params]


@pytest.mark.parametrize("name", NAMES)
def test_lp_matches_jax(name):
    d = _dim(name)
    jt, tt = _pair(name, d)
    x = (0.5 * np.random.default_rng(0).normal(size=(3, d))).astype(
        np.float32)
    got = float(tt.lp(torch.from_numpy(x)))
    want = float(jt.lp(jnp.asarray(x, jnp.float32)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_score_twin_matches_jax_kernel(name):
    d = _dim(name)
    jt, tt = _pair(name, d)
    x = (np.random.default_rng(1).normal(size=(5, d))).astype(np.float32)
    j_fn, j_params = jt.pallas_score
    want = np.asarray(j_fn(jnp.asarray(x), *map(jnp.asarray,
                                               _f32(j_params))))
    fn, params = tt.fused_score
    got = fn(torch.from_numpy(x), *params)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TWINS[name](torch.from_numpy(x), *params).numpy(), want, rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_score_matches_autodiff_and_finite_differences(name):
    d = _dim(name)
    _, tt = _pair(name, d)
    x = (np.random.default_rng(2).normal(size=(3, d)) * 0.5)
    x32 = torch.from_numpy(x.astype(np.float32))
    fn, params = tt.fused_score
    np.testing.assert_allclose(fn(x32, *params).numpy(),
                               tt.lp_g(x32).numpy(), rtol=2e-4, atol=2e-4)
    # Central differences of lp in float64 against the float64 score.
    _, t64 = _pair(name, d, np.float64)
    x64 = torch.from_numpy(x)
    g = t64.lp_g(x64).numpy()
    eps = 1e-6
    for b in range(3):
        for j in range(d):
            xp, xm = x64.clone(), x64.clone()
            xp[b, j] += eps
            xm[b, j] -= eps
            fd = (float(t64.lp(xp)) - float(t64.lp(xm))) / (2 * eps)
            assert g[b, j] == pytest.approx(fd, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_mean(name):
    d = _dim(name)
    _, tt = _pair(name, d)
    n = 400_000 if name == "student_t" else 200_000
    draws = tt.ref_samples(torch.Generator().manual_seed(1), n)
    # A draw repeats from the same generator state (Student-t's gamma
    # variates come from a numpy generator seeded from it).
    assert torch.equal(
        tt.ref_samples(torch.Generator().manual_seed(3), 10),
        tt.ref_samples(torch.Generator().manual_seed(3), 10))
    assert tuple(draws.shape) == (n, d) and bool(torch.isfinite(draws).all())
    if tt.mean is None:
        return
    mean = tt.mean.numpy()
    scale = np.abs(mean).max() + 1.0
    np.testing.assert_allclose(draws.mean(0).numpy(), mean,
                               atol=0.05 * scale)
    cov = tt.cov.numpy()
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov,
                               atol=0.1 * np.abs(cov).max())


def test_banana_needs_two_dims():
    with pytest.raises(ValueError, match="d >= 2"):
        banana(1, device=DEV)
    with pytest.raises(ValueError, match="D >= 2"):
        tfs.banana_score(torch.zeros(3, 1), torch.zeros(1, 2))


def test_funnel_at_one_dim_and_overflow_match_the_reference():
    """D=1 (rest is empty: g0 = -x0/sigma^2), and e^{-x0} overflowing for
    x0 < -88 exactly as the JAX kernel's does (no clamp)."""
    x = np.array([[0.7], [-2.0]], np.float32)
    jt, tt = j_funnel(1), funnel(1, device=DEV)
    got = tt.fused_score[0](torch.from_numpy(x), *tt.fused_score[1])
    np.testing.assert_allclose(got.numpy(), -x / 9.0, rtol=1e-6)
    x = np.array([[-90.0, 1.0, 0.5], [1.0, 2.0, 3.0]], np.float32)
    jt, tt = j_funnel(3), funnel(3, device=DEV)
    want = np.asarray(jt.pallas_score[0](
        jnp.asarray(x), jnp.asarray(_f32(jt.pallas_score[1])[0])))
    got = tt.fused_score[0](torch.from_numpy(x), *tt.fused_score[1]).numpy()
    assert np.isinf(want[0]).all() and np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_whole_step_matches_jax_interpret_kernel(name):
    """The port's K4 (plain version on CPU tensors) with the zoo pair
    against JAX's ``make_fused_eps_step(..., external_eps=True,
    interpret=True)`` with its zoo kernel traced in, at B=8, D=16."""
    b, d = 8, 16
    jt, tt = _pair(name, d)
    rng = np.random.default_rng(3)
    mu = rng.normal(size=d).astype(np.float32)
    f = (0.3 * rng.normal(size=(d, d)) + np.eye(d)).astype(np.float32)
    eps = rng.normal(size=(b, d)).astype(np.float32)
    j_fn, j_params = jt.pallas_score
    j_params = [jnp.asarray(p) for p in _f32(j_params)]
    m_j, f_j, g_j = j_step(j_fn, len(j_params), b, d, external_eps=True,
                           interpret=True)(jnp.asarray(eps), jnp.asarray(mu),
                                           jnp.asarray(f), *j_params)
    fn, params = tt.fused_score
    step = tfs.make_fused_eps_step(fn, len(params), b, d, external_eps=True)
    m_t, f_t, g_t = step(*map(torch.from_numpy, (eps, mu, f)), *params)
    assert bool(g_t) == bool(g_j)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-4,
                               atol=1e-4)
    s_t = f_t.double().numpy() @ f_t.double().numpy().T
    f_j = np.asarray(f_j, np.float64)
    s_j = f_j @ f_j.T
    np.testing.assert_allclose(s_t, s_j,
                               atol=2e-4 * max(1.0, float(np.abs(s_j).max())))


@pytest.mark.parametrize("name", NAMES)
def test_factor_gsm_trajectory_matches_jax(monkeypatch, name):
    """100 steps of the port's whole-step runner with the zoo pair, fed
    JAX's own ``normal(fold_in(key, s))`` draws, against JAX FactorGSM on
    its fused multistep kernel (zoo score traced in) in interpret mode."""
    d, b, niter = 16, 8, 99
    jt, tt = _pair(name, d)
    monkeypatch.setattr(j_gf, "on_tpu", lambda: True)
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    gj = JFactorGSM(D=d, lp=jt.lp, lp_g=jt.lp_g, dtype=jnp.float32,
                    pallas_score=jt.pallas_score)
    gj._interpret = True
    assert gj._pallas_mode(b) == "step"
    key = jax.random.PRNGKey(0)
    sj = gj.fit(key, niter=niter, batch_size=b, verbose=False,
                return_state=True)
    spc = gj.steps_per_call
    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                     jnp.float32))
        for s in range(niter + 1 + spc)])
    gt = FactorGSM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score, device=DEV)
    assert gt._fused_mode(b) == "step" and gt.steps_per_call == spc
    gt._eps = lambda seed, step, batch, dd, dtype: torch.from_numpy(
        draws[step])
    st = gt.fit(0, niter=niter, batch_size=b, verbose=False,
                return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=0,
                               atol=1e-4)
    f_j = np.asarray(sj.factor)
    np.testing.assert_allclose(st.factor.numpy(), f_j, rtol=0,
                               atol=1e-4 * float(np.abs(f_j).max()))


def test_student_t_constructors():
    """``student_t`` draws loc and the scale factor with numpy from the
    seed; prec is inv(sigma) built in float64 and cast once; the kernel
    pair's params are float32 (1, D), (D, D), [[df, D]]."""
    t = student_t(0, 6, df=5.0, device=DEV)
    rng = np.random.default_rng(0)
    loc = rng.standard_normal(6)
    l = rng.standard_normal((6, 6)) / np.sqrt(6)
    sigma = l @ l.T + np.eye(6)
    np.testing.assert_array_equal(t.mean.numpy(), loc.astype(np.float32))
    np.testing.assert_allclose(t.cov.numpy(), 5.0 / 3.0 * sigma, rtol=1e-6)
    _, prec, dfd = t.fused_score[1]
    np.testing.assert_array_equal(
        prec.numpy(), np.linalg.inv(sigma).astype(np.float32))
    assert dfd.tolist() == [[5.0, 6.0]] and prec.dtype == torch.float32
    assert t.name == "student_t_d6_df5"
