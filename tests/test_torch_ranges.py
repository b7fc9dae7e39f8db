"""The kernels' shape ranges on the CPU: the fitters take their kernel
routes at the reference examples' shapes (B 1-3, D 1-10) and at the bench's
large batches (B=128) instead of raising, and the kernels' plain twins match
the JAX package's steps at B=1 and B=2.

The kernel routes are driven on the CPU by monkeypatching the port's
``on_gpu`` (the wrappers then run their plain versions on the CPU tensors
they are given).  The JAX side runs as its own tests run it: the XLA twins,
the exact eps and BaM steps, and the Pallas kernels in interpret mode.
Tolerances as in ``tests/test_torch_fused_step.py`` and
``tests/test_torch_bam_fused.py``: float32 on both sides with sums in other
orders, one update within 1e-5 (mean) and 1e-5 * max|F| (factor) against the
same algorithm; against the exact steps, which factor the same covariance
differently, the covariance S = F F^T within 2e-4 * max(1, max|S|) and the
mean within 1e-4 (``tests/test_pallas.py``'s whole-step bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.advi as t_advi
import gsmvi_tpu_torch.bam as t_bam
import gsmvi_tpu_torch.bam_factor as t_bf
import gsmvi_tpu_torch.gsm as t_gsm
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu.ops import bam_eps as jbe
from gsmvi_tpu.ops import gsm_eps as jeps
from gsmvi_tpu.ops.pallas import bam_fused as jbf
from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch import (ADVI, GSM, Adam, BaM, FactorBaM, FactorGSM,
                             Regularizers)
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import bam_fused as tbf
from gsmvi_tpu_torch.ops import fused_step as tfs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
SMALL_SHAPES = [(b, d) for b in (1, 2, 3) for d in (1, 5, 10)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make every fitter take its kernel route on the CPU."""
    for mod in (t_gf, t_gsm, t_bf, t_bam, t_advi):
        monkeypatch.setattr(mod, "on_gpu", lambda device: True)


def _finite(*tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


@pytest.mark.parametrize("b,d", SMALL_SHAPES + [(128, 8)])
def test_factor_gsm_takes_its_kernel_routes(kernel_paths, b, d):
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    niter = 3 if b == 128 else 20
    for fused, mode in ((None, "update"), (t.fused_score, "step")):
        g = FactorGSM(d, t.lp, t.lp_g, fused_score=fused, device=DEV)
        assert g._fused_mode(b) == mode
        s = g.fit(0, niter=niter, batch_size=b, verbose=False,
                  return_state=True)
        assert s.step == niter + 1 and _finite(s.mean, s.factor)


@pytest.mark.parametrize("b,d", SMALL_SHAPES + [(128, 8)])
def test_factor_bam_takes_its_kernel_routes(kernel_paths, b, d):
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    niter = 2 if b == 128 else 10
    regf = Regularizers().custom(lambda i: 100 / (1 + i))
    for fused, mode in ((None, "update"), (t.fused_score, "step")):
        g = FactorBaM(d, t.lp, t.lp_g, fused_score=fused, device=DEV)
        assert g._fused_mode(b) == mode
        s = g.fit(0, regf, niter=niter, batch_size=b, verbose=False,
                  retries=0, return_state=True)
        assert s.step == niter + 1 and _finite(s.mean, s.factor)


@pytest.mark.parametrize("b,d", SMALL_SHAPES + [(128, 8)])
def test_advi_fit_fused_takes_its_kernel_route(kernel_paths, b, d):
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = ADVI(d, t.lp, fused_score=t.fused_score, device=DEV)
    g._check_fused(b)
    mean, cov, _ = g.fit_fused(0, niter=9, batch_size=b, verbose=False)
    assert _finite(mean, cov) and tuple(cov.shape) == (d, d)


def test_examples_defaults_route_to_the_kernels(kernel_paths):
    """The reference examples' calls with the fitters' defaults (B=2) take
    the factor route and its kernel path: ``GSM(10, ...).fit`` and
    ``BaM(5, ..., use_lowrank=True).fit``."""
    t = dense_gaussian(3, 10, device=DEV)
    g = GSM(10, t.lp, t.lp_g, device=DEV)
    assert g._factor_route(2)
    assert g._get_factor_fitter()._fused_mode(2) == "update"
    s = g.fit(0, niter=30, verbose=False, return_state=True)
    assert s.step == 31 and _finite(s.mean, s.cov)
    t5 = dense_gaussian(5, 5, device=DEV)
    bam = BaM(5, t5.lp, t5.lp_g, use_lowrank=True, device=DEV)
    assert bam._factor_route()
    assert bam._get_factor_fitter()._fused_mode(2) == "update"
    mean, cov = bam.fit(0, Regularizers().custom(lambda i: 100 / (1 + i)),
                        niter=30, batch_size=2, verbose=False)
    assert _finite(mean, cov)
    g1 = ADVI(16, dense_gaussian(11, 16, device=DEV).lp, device=DEV)
    mean, cov, losses = g1.fit(0, Adam(1e-2), batch_size=1, niter=5,
                               verbose=False)
    assert _finite(mean, cov) and len(losses) == 6


def _eps_inputs(seed, b, d):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _within(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("b,d", [(1, 1), (1, 5), (2, 10), (2, 3)])
def test_update_twin_matches_jax_at_small_batch(b, d):
    """K1's plain twin at B=1, 2: the JAX NS twin and its interpret kernel
    (same algorithm: mean and factor), and the exact eps step
    ``apply_eps_step`` (covariance)."""
    eps, v, mu, f = _eps_inputs(10 * b + d, b, d)
    m_t, f_t, g_t = tfs.gsm_eps_update_fused(*_t(eps, v, mu, f))
    scale = float(np.abs(f).max())
    for want in (jfs.gsm_eps_update_ns_xla(*_j(eps, v, mu, f)),
                 jfs.gsm_eps_update_fused(*_j(eps, v, mu, f),
                                          interpret=True)):
        assert bool(g_t) == bool(want[2]) is True
        np.testing.assert_allclose(m_t.numpy(), np.asarray(want[0]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(want[1]), rtol=0,
                                   atol=1e-5 * scale)
    m_e, f_e, g_e = jeps.apply_eps_step(*_j(mu, f, eps, v))
    assert bool(g_e)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_e), rtol=0,
                               atol=1e-4)
    f_e = np.asarray(f_e, np.float64)
    s_t = f_t.double().numpy() @ f_t.double().numpy().T
    _within(s_t, f_e @ f_e.T, 2e-4)


@pytest.mark.parametrize("b,d", [(1, 8), (2, 16), (2, 5)])
def test_bam_update_twin_matches_jax_at_small_batch(b, d):
    """K7's plain twin at B=1, 2: JAX's K7 in interpret mode (same
    algorithm, kpad = B + 8: mean, factor, flags and gate statistics) and
    the exact BaM eps step ``bam_eps_update`` (mean and covariance)."""
    rng = np.random.default_rng(b + d)
    e = rng.standard_normal((b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    v = (-(mu + e @ f.T - rng.standard_normal(d))).astype(np.float32)
    reg = 1.5
    m_t, f_t, keep_t, stiff_t, ns_t = tbf.bam_eps_update_fused(
        *_t(e, v, mu, f), reg)
    m_j, f_j, keep_j, stiff_j, ns_j = jbf.bam_eps_update_fused(
        *_j(e, v, mu, f), reg, interpret=True)
    assert (bool(keep_t), bool(stiff_t)) == (bool(keep_j), bool(stiff_j)) \
        == (True, False)
    np.testing.assert_allclose(ns_t.numpy(), np.asarray(ns_j), rtol=1e-4,
                               atol=1e-6)
    _within(m_t, m_j, 1e-5)
    _within(f_t, f_j, 1e-5)
    m_e, f_e, g_e = jbe.bam_eps_update(*_j(e, v, mu, f), jnp.float32(reg))
    assert bool(g_e)
    _within(m_t, m_e, 1e-4)
    f_e = np.asarray(f_e, np.float64)
    s_t = f_t.double().numpy() @ f_t.double().numpy().T
    _within(s_t, f_e @ f_e.T, 2e-4)
