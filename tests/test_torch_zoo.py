"""The zoo's non-Gaussian targets (funnel, banana, Student-t, the Gaussian
mixture, logistic regression) and their K11a/K11b score pairs against the
JAX package, on the CPU; ``from_distribution`` against JAX's.

The same numpy-made inputs go through both packages.  Funnel and banana are
built from the same scalars on both sides; the port's Student-t, mixture
and logistic regression come from the JAX targets' own arrays
(``student_t_from_arrays`` with JAX's ``prec``,
``gaussian_mixture_from_arrays`` on its padded means and logmask,
``logistic_regression_from_arrays`` on its X and y).
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
from gsmvi_tpu.distributions import Gaussian as JGaussian
from gsmvi_tpu.models import banana as j_banana
from gsmvi_tpu.models import funnel as j_funnel
from gsmvi_tpu.models.mixture import gaussian_mixture as j_mixture
from gsmvi_tpu.models.numpyro_compat import \
    from_distribution as j_from_distribution
from gsmvi_tpu.models.regression import logistic_regression as j_logreg
from gsmvi_tpu.models.student_t import student_t as j_student_t
from gsmvi_tpu.ops.pallas.fused_step import make_fused_eps_step as j_step
from gsmvi_tpu_torch import FactorGSM
from gsmvi_tpu_torch.models import (banana, funnel, gaussian_mixture,
                                    gaussian_mixture_from_arrays,
                                    logistic_regression,
                                    logistic_regression_from_arrays,
                                    student_t, student_t_from_arrays)
from gsmvi_tpu_torch.models.numpyro_compat import from_distribution
from gsmvi_tpu_torch.ops import fused_step as tfs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
NAMES = ["funnel", "banana", "student_t", "mixture", "logreg"]
DF = 6.0
TWINS = {"funnel": tfs.funnel_score_reference,
         "banana": tfs.banana_score_reference,
         "student_t": tfs.student_t_score_reference,
         "mixture": tfs.mixture_score_reference,
         "logreg": tfs.logreg_score_reference}


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
    if name == "mixture":
        jt = j_mixture(jax.random.PRNGKey(3), d)
        means_pad, logmask = (np.asarray(p) for p in jt.pallas_score[1])
        return jt, gaussian_mixture_from_arrays(means_pad.astype(dtype),
                                                logmask, device=DEV)
    if name == "logreg":
        jt = j_logreg(jax.random.PRNGKey(4), d, n_data=24)
        xd, y, _ = (np.asarray(p) for p in jt.pallas_score[1])
        return jt, logistic_regression_from_arrays(xd.astype(dtype), y,
                                                   device=DEV)
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
    if name == "logreg":
        # No sampler and no moments, as in the JAX package.
        assert tt.mean is None and tt.cov is None
        with pytest.raises(ValueError, match="no exact sampler"):
            tt.ref_samples(torch.Generator().manual_seed(1), 10)
        return
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
    its fused multistep kernel (zoo score traced in) in interpret mode.

    The mixture's fit starts 4 away from its second component (the others
    lie >= 13 away): from (0, I), between two components, its draws
    straddle both modes, where the responsibilities turn float32 rounding
    into 1e-3 within 30 steps on either package, so equal trajectories
    cannot be asked for there."""
    d, b, niter = 16, 8, 99
    jt, tt = _pair(name, d)
    mean0 = None
    if name == "mixture":
        mean0 = np.asarray(jt.pallas_score[1][0], np.float32)[1] + 1.0
    monkeypatch.setattr(j_gf, "on_tpu", lambda: True)
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    gj = JFactorGSM(D=d, lp=jt.lp, lp_g=jt.lp_g, dtype=jnp.float32,
                    pallas_score=jt.pallas_score)
    gj._interpret = True
    assert gj._pallas_mode(b) == "step"
    key = jax.random.PRNGKey(0)
    sj = gj.fit(key, mean=None if mean0 is None else jnp.asarray(mean0),
                niter=niter, batch_size=b, verbose=False, return_state=True)
    spc = gj.steps_per_call
    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                     jnp.float32))
        for s in range(niter + 1 + spc)])
    gt = FactorGSM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score, device=DEV)
    assert gt._fused_mode(b) == "step" and gt.steps_per_call == spc
    gt._eps = lambda seed, step, batch, dd, dtype: torch.from_numpy(
        draws[step])
    st = gt.fit(0, mean=None if mean0 is None else torch.from_numpy(mean0),
                niter=niter, batch_size=b, verbose=False, return_state=True)
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


def _j_score(jt, x, params=None):
    """JAX's zoo kernel on x, called as a jnp function, in float32."""
    j_fn, j_params = jt.pallas_score
    params = _f32(j_params if params is None else params)
    return np.asarray(j_fn(jnp.asarray(x), *map(jnp.asarray, params)))


@pytest.mark.parametrize("separation", [3.0, 0.3])
@pytest.mark.parametrize("padded", [True, False])
def test_mixture_score_layouts_match_jax_kernel(padded, separation):
    """The mixture pair on JAX's padded (means_pad, logmask), K=8 with five
    -1e30 rows, and on the unpadded K=3 pair, at separation 3 (near
    one-hot responsibilities) and 0.3 (blended), against JAX's kernel on
    its padded arrays."""
    d = 6
    jt = j_mixture(jax.random.PRNGKey(3), d)
    means_pad, logmask = _f32(jt.pallas_score[1])
    means_pad = means_pad * np.float32(separation / 3.0)
    x = np.random.default_rng(4).normal(size=(7, d)).astype(np.float32)
    want = _j_score(jt, x, (means_pad, logmask))
    tt = (gaussian_mixture_from_arrays(means_pad, logmask, device=DEV)
          if padded else gaussian_mixture_from_arrays(means_pad[:3],
                                                      device=DEV))
    fn, params = tt.fused_score
    assert tuple(params[0].shape) == ((8, d) if padded else (3, d))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(fn(xt, *params).numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tfs.mixture_score_reference(xt, *params),
                               want, rtol=1e-5, atol=1e-5)
    # The density and moments are the real components' either way.
    assert tt.name == f"gmm_d{d}_k3"
    np.testing.assert_allclose(tt.mean.numpy(), means_pad[:3].mean(0),
                               rtol=1e-6, atol=1e-6)
    if separation == 0.3:
        r = torch.softmax(xt @ params[0].T - 0.5 * (params[0] ** 2).sum(1)
                          + params[1], dim=1)[:, :3]
        assert float(r.max()) < 0.99, "responsibilities should blend"


def test_logreg_saturated_rows_match_jax_kernel():
    """Rows with |w . x_n| > 100: the sigmoid saturates to 0 or 1 with no
    NaN, and the score equals JAX's kernel's."""
    jt, tt = _pair("logreg", 5)
    w = (300.0 * np.random.default_rng(5).normal(size=(6, 5))).astype(
        np.float32)
    w[1] = 0.3
    fn, params = tt.fused_score
    z = w @ params[0].numpy().T
    assert (np.abs(z) > 100).any(axis=1).sum() >= 4
    got = fn(torch.from_numpy(w), *params).numpy()
    want = _j_score(jt, w)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["mixture", "logreg"])
def test_k11b_constructors_follow_the_numpy_recipe(name):
    """``gaussian_mixture(0, 6)`` and ``logistic_regression(0, 6,
    n_data=10)`` draw with numpy from the seed, in the JAX package's order;
    the kernel pair's params are float32 (K, D) + (1, K) and (N, D) +
    (1, N) + (1, 1)."""
    rng = np.random.default_rng(0)
    if name == "mixture":
        t = gaussian_mixture(0, 6, device=DEV)
        means = (3.0 * rng.standard_normal((3, 6))).astype(np.float32)
        got_means, logmask = t.fused_score[1]
        np.testing.assert_array_equal(got_means.numpy(), means)
        assert logmask.tolist() == [[0.0, 0.0, 0.0]]
        np.testing.assert_allclose(t.mean.numpy(), means.mean(0), rtol=1e-6)
        dev = means - means.mean(0)
        np.testing.assert_allclose(t.cov.numpy(),
                                   np.eye(6) + dev.T @ dev / 3, rtol=1e-5)
        assert t.name == "gmm_d6_k3" and t.fused_score[0] is tfs.mixture_score
        with pytest.raises(ValueError, match="logmask"):
            gaussian_mixture_from_arrays(means, np.array([[0.0, -1.0, 0.0]]),
                                         device=DEV)
    else:
        t = logistic_regression(0, 6, n_data=10, device=DEV)
        w_true = rng.standard_normal(6)
        x = rng.standard_normal((10, 6)) / np.sqrt(6)
        y = rng.uniform(size=10) < 1.0 / (1.0 + np.exp(-(x @ w_true)))
        xd, y_row, inv_ps2 = t.fused_score[1]
        np.testing.assert_array_equal(xd.numpy(), x.astype(np.float32))
        np.testing.assert_array_equal(y_row.numpy(),
                                      y.astype(np.float32)[None])
        assert inv_ps2.tolist() == [[0.25]] and t.mean is None
        assert t.name == "logreg_d6_n10" and t.fused_score[0] is tfs.logreg_score
    assert all(p.dtype == torch.float32 for p in t.fused_score[1])


def test_from_distribution_matches_jax():
    """``from_distribution`` on ``torch.distributions.MultivariateNormal``
    against the JAX adapter on its ``Gaussian`` of the same loc and cov, in
    float64 (``tests/test_numpyro_compat.py``); mean and cov carried; a
    draw repeats from the same generator state and leaves the global
    generator as it was."""
    d = 6
    rng = np.random.default_rng(0)
    loc = rng.normal(size=d)
    l = 0.3 * rng.normal(size=(d, d))
    cov = l @ l.T + np.eye(d)
    x = rng.normal(size=(4, d))
    jt = j_from_distribution(JGaussian(loc, cov), d)
    tt = from_distribution(torch.distributions.MultivariateNormal(
        torch.from_numpy(loc), covariance_matrix=torch.from_numpy(cov)), d)
    xt = torch.from_numpy(x)
    assert float(tt.lp(xt)) == pytest.approx(float(jt.lp(x)), rel=1e-10)
    np.testing.assert_allclose(tt.lp_g(xt).numpy(), np.asarray(jt.lp_g(x)),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(tt.mean.numpy(), loc)
    np.testing.assert_allclose(tt.cov.numpy(), cov, rtol=1e-12)
    state = torch.get_rng_state()
    a = tt.ref_samples(torch.Generator().manual_seed(3), 5)
    b = tt.ref_samples(torch.Generator().manual_seed(3), 5)
    assert torch.equal(torch.get_rng_state(), state)
    assert tuple(a.shape) == (5, d) and torch.equal(a, b)
    assert not torch.equal(
        a, tt.ref_samples(torch.Generator().manual_seed(4), 5))


def _range_case(case):
    """(JAX target, the port's kernel pair) of one K11b range case."""
    name, size, d = case
    if name == "mixture":
        jt = j_mixture(jax.random.PRNGKey(3), d, n_components=min(size, 3))
        means_pad, logmask = _f32(jt.pallas_score[1])
        if size != 8:
            means_pad, logmask = means_pad[:size], logmask[:, :size]
        return jt, (tfs.mixture_score, (torch.tensor(means_pad),
                                        torch.tensor(logmask)))
    jt = j_logreg(jax.random.PRNGKey(4), d, n_data=size)
    return jt, (tfs.logreg_score, tuple(map(torch.tensor,
                                            _f32(jt.pallas_score[1]))))


@pytest.mark.parametrize("case", [("mixture", 1, 5), ("mixture", 8, 5),
                                  ("mixture", 3, 1), ("logreg", 1, 5),
                                  ("logreg", 24, 1)],
                         ids=lambda c: f"{c[0]}-{c[1]}-D{c[2]}")
def test_k11b_range_edges_match_jax_kernel(case):
    """The plain path at the kernels' range edges: mixture K=1, JAX's
    padded K=8 and D=1; logreg N=1 and D=1."""
    jt, (fn, params) = _range_case(case)
    x = np.random.default_rng(6).normal(size=(4, case[2])).astype(np.float32)
    np.testing.assert_allclose(fn(torch.from_numpy(x), *params).numpy(),
                               _j_score(jt, x), rtol=1e-5, atol=1e-5)


def test_k11b_wrappers_reject_wrong_shapes():
    x = torch.zeros(4, 5)
    means, logmask = torch.zeros(3, 5), torch.zeros(1, 3)
    for bad in (torch.zeros(1, 4), torch.zeros(3), torch.zeros(3, 1)):
        with pytest.raises(ValueError, match="logmask"):
            tfs.mixture_score(x, means, bad)
    with pytest.raises(ValueError, match="means"):
        tfs.mixture_score(x, torch.zeros(3, 6), logmask)
    xd, y, inv_ps2 = torch.zeros(7, 5), torch.zeros(1, 7), torch.ones(1, 1)
    for bad in (torch.ones(1, 2), torch.ones(1), torch.ones(())):
        with pytest.raises(ValueError, match="inv_ps2"):
            tfs.logreg_score(x, xd, y, bad)
    with pytest.raises(ValueError, match="y_row"):
        tfs.logreg_score(x, xd, torch.zeros(7), inv_ps2)
    with pytest.raises(ValueError, match="xdata"):
        tfs.logreg_score(x, torch.zeros(7, 4), y, inv_ps2)
