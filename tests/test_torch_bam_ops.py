"""The port's plain BaM ops (gsmvi_tpu_torch/ops/{sqrtm,bam,bam_eps}.py and
``ops/gsm_factor._update_corr``) against the JAX package on identical
numpy-made inputs.

Tolerances: in float64 both sides agree to 1e-9 relative (LAPACK on both
sides, sums in other orders); in float32 to 1e-4 relative to the output's
scale (one update of O(1) quantities through an eigh/SVD and a few D-sized
products).  eigh/SVD sign and order conventions differ between the
packages; the updates are invariant to them, so the tests compare updates,
not factors.  The conftest turns JAX x64 on, so arrays keep their numpy
dtype on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops import bam as jbam
from gsmvi_tpu.ops import bam_eps as jbe
from gsmvi_tpu.ops import gsm_factor as jgf
from gsmvi_tpu.ops import sqrtm as jsq
from gsmvi_tpu_torch.ops import bam as tbam
from gsmvi_tpu_torch.ops import bam_eps as tbe
from gsmvi_tpu_torch.ops import gsm_factor as tgf
from gsmvi_tpu_torch.ops import sqrtm as tsq

TOL = {np.float64: 1e-9, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale,
                               err_msg=what)


def _spd(rng, k, cond_scale=1.0):
    a = rng.standard_normal((k, k))
    return a @ a.T * cond_scale / k + np.eye(k)


def _bam_inputs(seed, b, d, dtype, score_scale=1.0):
    """Draws, the factor they were sampled through, mean, and Gaussian
    scores at the samples."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((b, d))
    f = np.eye(d) + 0.2 * rng.standard_normal((d, d)) / np.sqrt(d)
    mu = rng.standard_normal(d)
    prec = np.linalg.inv(_spd(rng, d))
    x = mu + eps @ f.T
    vs = score_scale * (rng.uniform(size=d) - x) @ prec
    return [np.asarray(a, dtype) for a in (eps, vs, mu, f, x)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sqrtm_variants_match_jax(dtype):
    m = _spd(np.random.default_rng(1), 12, 5.0).astype(dtype)
    mt = torch.from_numpy(m)
    _close(tsq.spd_sqrtm(mt), jsq.spd_sqrtm(jnp.asarray(m)), dtype)
    for got, want in zip(tsq.spd_sqrtm_and_inv(mt),
                         jsq.spd_sqrtm_and_inv(jnp.asarray(m))):
        _close(got, want, dtype)
    _close(tsq.spd_sqrtm_newton(mt, 20),
           jsq.spd_sqrtm_newton(jnp.asarray(m), 20), dtype)
    bad = torch.full((3, 3), float("nan"), dtype=mt.dtype)
    assert torch.isnan(tsq.spd_sqrtm(bad)).all()      # NaN, as JAX, no raise


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_corr_matches_jax(dtype):
    rng = np.random.default_rng(2)
    om = rng.standard_normal((9, 30)) * 2.0
    g = (om @ om.T / 9).astype(dtype)
    got = tgf._update_corr(torch.from_numpy(g), 20)
    want = jgf._update_corr(jnp.asarray(g), 20)
    for a, b in zip(got, want):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,sqrt_method", [("full", "eigh"),
                                              ("full", "newton"),
                                              ("lowrank", "eigh")])
def test_dense_updates_match_jax(kind, sqrt_method, dtype):
    b, d = 8, 24
    eps, vs, mu, _, x = _bam_inputs(3, b, d, dtype)
    s0 = _spd(np.random.default_rng(4), d).astype(dtype)
    reg = 2.5
    tf = tbam.bam_update if kind == "full" else tbam.bam_lowrank_update
    jf = jbam.bam_update if kind == "full" else jbam.bam_lowrank_update
    got = tf(*[torch.from_numpy(a) for a in (x, vs, mu, s0)],
             torch.tensor(reg, dtype=torch.from_numpy(s0).dtype), 1e-6,
             sqrt_method=sqrt_method)
    want = jf(*[jnp.asarray(a) for a in (x, vs, mu, s0)],
              jnp.asarray(reg, dtype), 1e-6, sqrt_method=sqrt_method)
    _close(got[0], want[0], dtype, "mean")
    _close(got[1], want[1], dtype, "cov")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("solver", ["auto", "svd", "eigh"])
def test_bam_eps_update_matches_jax(solver, dtype):
    b, d = 8, 32
    eps, vs, mu, f, _ = _bam_inputs(5, b, d, dtype)
    reg = 1.7
    m_t, f_t, g_t = tbe.bam_eps_update(
        *[torch.from_numpy(a) for a in (eps, vs, mu, f)], reg, solver=solver)
    m_j, f_j, g_j = jbe.bam_eps_update(
        *[jnp.asarray(a) for a in (eps, vs, mu, f)], jnp.asarray(reg, dtype),
        solver=solver)
    assert bool(g_t) == bool(g_j) is True
    _close(m_t, m_j, dtype, "mean")
    # The factor is unique only up to the eigen/singular basis chosen for
    # degenerate (padded, null) directions; the covariance is unique.
    _close(f_t @ f_t.T, np.asarray(f_j) @ np.asarray(f_j).T, dtype, "cov")
    _close(f_t, f_j, dtype, "factor")


def test_auto_takes_the_svd_branch_on_a_stiff_step():
    """Scores 10x larger push the Gram's row-sum bound above
    1e-3 / eps_f32: "auto" must route to the thin SVD (bit-identical to
    solver="svd") and still match JAX's "auto" (both sit ~1e-5 from the
    float64 SVD result here)."""
    b, d = 8, 32
    eps, vs, mu, f, _ = _bam_inputs(6, b, d, np.float32, score_scale=10.0)
    args = [torch.from_numpy(a) for a in (eps, vs, mu, f)]
    reg = 2.0
    auto = tbe.bam_eps_update(*args, reg, solver="auto")
    svd = tbe.bam_eps_update(*args, reg, solver="svd")
    eigh = tbe.bam_eps_update(*args, reg, solver="eigh")
    assert torch.equal(auto[1], svd[1]) and torch.equal(auto[0], svd[0])
    assert not torch.equal(auto[1], eigh[1])
    want = jbe.bam_eps_update(*[jnp.asarray(a) for a in (eps, vs, mu, f)],
                              jnp.float32(reg), solver="auto")
    assert bool(auto[2]) == bool(want[2])
    _close(auto[0], want[0], np.float32, "mean")
    _close(auto[1] @ auto[1].T,
           np.asarray(want[1]) @ np.asarray(want[1]).T, np.float32, "cov")


def test_auto_below_k1_and_apply_step():
    """D < B+1 takes the SVD unconditionally; apply_bam_eps_step selects
    the old state on a failed flag."""
    b, d = 8, 6
    eps, vs, mu, f, _ = _bam_inputs(7, b, d, np.float64)
    args = [torch.from_numpy(a) for a in (eps, vs, mu, f)]
    got = tbe.bam_eps_update(*args, 0.8)
    want = jbe.bam_eps_update(*[jnp.asarray(a) for a in (eps, vs, mu, f)],
                              0.8)
    _close(got[0], want[0], np.float64)
    _close(got[1] @ got[1].T, np.asarray(want[1]) @ np.asarray(want[1]).T,
           np.float64)
    m, ff, good = tbe.apply_bam_eps_step(args[2], args[3], args[0], args[1],
                                         0.8)
    assert bool(good) and torch.equal(ff, got[1])
    nan_vs = torch.full_like(args[1], float("nan"))
    m, ff, good = tbe.apply_bam_eps_step(args[2], args[3], args[0], nan_vs,
                                         0.8)
    assert not bool(good) and torch.equal(ff, args[3])
    assert torch.equal(m, args[2])


def test_regularizers_match_jax():
    for name, arg in (("constant", 3.0), ("linear", 100.0),
                      ("custom", lambda i: 5.0 / i ** 0.5)):
        t = getattr(tbam.Regularizers(), name)(arg)
        j = getattr(jbam.Regularizers(), name)(arg)
        for i in (0, 1, 7, 63, 1000):
            assert t(i) == pytest.approx(float(j(i)), rel=1e-15)
    r = tbam.Regularizers()
    f = r.linear(1.0)
    f(0), f(1)
    assert r.counter == 2
    r.reset()
    assert r.counter == 0
