"""The port's eps-NS step (gsmvi_tpu_torch/ops/fused_step.py) against the
JAX package on identical numpy-made inputs.

The JAX side runs as its own tests run it on the CPU: the plain-XLA twin
``gsm_eps_update_ns_xla`` and the Pallas kernels in interpret mode.  The
conftest turns JAX x64 on, so every array handed to JAX is cast to float32.

Tolerances: both sides are float32 and sum in different orders (MKL vs
XLA:CPU); one step moves the mean and factor by O(1), so 1e-5 absolute on
the mean and 1e-5 * max|F| on the factor (the JAX package's own
kernel-vs-twin bound, tests/test_gsm_fused_foldin.py) hold with margin for a
single call, and 1e-4 for the four chained steps of a multistep block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.ops import fused_step as tfs

MEAN_TOL = 1e-5
F_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # MKL's threaded LAPACK/BLAS costs milliseconds per tiny call on a
    # shared CPU; the comparisons are about values, not speed.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, d, decades=0.0):
    """Random factor, mean, draws and scores; ``decades`` > 0 scales the
    draw rows over that many decades."""
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    ladder = np.logspace(0.0, decades, b)[:, None]
    eps = (ladder * rng.standard_normal((b, d))).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _close(got, want, f_scale):
    m_t, f_t = got
    m_j, f_j = want
    np.testing.assert_allclose(np.asarray(m_t), np.asarray(m_j), rtol=0,
                               atol=MEAN_TOL)
    np.testing.assert_allclose(np.asarray(f_t), np.asarray(f_j), rtol=0,
                               atol=F_TOL * f_scale)


@pytest.mark.parametrize("b,d", [(8, 48), (32, 64)])
def test_smallspace_reference_matches_jax(b, d):
    eps, v, mu, f = _inputs(b + d, b, d)
    vf = v @ f
    m_j, f_j, g_j = jfs._eps_smallspace_ns(*_j(eps, v, vf, mu[None], f),
                                           batch=b)
    m_t, f_t, g_t = tfs.eps_smallspace_ns_reference(
        *_t(eps, v, vf, mu[None], f), batch=b)
    assert bool(g_t) == bool(g_j) is True
    _close((m_t, f_t), (m_j, f_j), float(np.abs(f).max()))


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("b,d", [(8, 48), (32, 64)])
def test_update_cpu_wrapper_matches_jax_twin_and_interpret_kernel(b, d,
                                                                  with_ef):
    eps, v, mu, f = _inputs(7 * b + d, b, d)
    ef = (eps @ f.T).astype(np.float32) if with_ef else None
    got = tfs.gsm_eps_update_fused(*_t(eps, v, mu, f),
                                   ef=None if ef is None else _t(ef)[0])
    je = None if ef is None else _j(ef)[0]
    xla = jfs.gsm_eps_update_ns_xla(*_j(eps, v, mu, f), ef_t=je)
    kern = jfs.gsm_eps_update_fused(*_j(eps, v, mu, f), interpret=True,
                                    ef=je)
    scale = float(np.abs(f).max())
    for want in (xla, kern):
        assert bool(got[2]) == bool(want[2]) is True
        _close(got[:2], want[:2], scale)


def test_update_rejects_and_keeps_old_state():
    """Draw rows scaled over three decades make I + Gu so ill-conditioned
    (~1e6) that the short Newton-Schulz chains cannot converge: the residual
    gate trips on both sides and the old (mean, F) come back unchanged."""
    b, d = 8, 48
    eps, v, mu, f = _inputs(5, b, d, decades=3.0)
    m_t, f_t, g_t = tfs.gsm_eps_update_fused(*_t(eps, v, mu, f))
    m_j, f_j, g_j = jfs.gsm_eps_update_ns_xla(*_j(eps, v, mu, f))
    assert not bool(g_t) and not bool(g_j)
    np.testing.assert_array_equal(m_t.numpy(), mu)
    np.testing.assert_array_equal(f_t.numpy(), f)
    np.testing.assert_array_equal(np.asarray(m_j), mu)


def test_batch_64_resolves_long_profile():
    """iters=None resolves through ns_iters_for_batch: B=64 runs the long
    profile (the short one silently biases there) and matches JAX's twin
    run with that profile."""
    assert tfs.ns_iters_for_batch(32) == tfs.NS_ITERS_DEFAULT
    assert tfs.ns_iters_for_batch(64) == tfs.NS_ITERS_LARGE_B
    assert tfs.ns_iters_for_batch(64, (1, 2, 3, 4, 5)) == (1, 2, 3, 4, 5)
    b, d = 64, 96
    eps, v, mu, f = _inputs(3, b, d)
    got = tfs.gsm_eps_update_fused(*_t(eps, v, mu, f))
    long_ = tfs.gsm_eps_update_ns_reference(*_t(eps, v, mu, f),
                                            iters=tfs.NS_ITERS_LARGE_B)
    short = tfs.gsm_eps_update_ns_reference(*_t(eps, v, mu, f),
                                            iters=tfs.NS_ITERS_DEFAULT)
    np.testing.assert_array_equal(got[1].numpy(), long_[1].numpy())
    assert not np.array_equal(got[1].numpy(), short[1].numpy())
    want = jfs.gsm_eps_update_ns_xla(*_j(eps, v, mu, f),
                                     iters=jfs.NS_ITERS_LARGE_B)
    assert bool(got[2]) == bool(want[2]) is True
    _close(got[:2], want[:2], float(np.abs(f).max()))


@pytest.mark.parametrize("nmax", [2, 4])
def test_multistep_matches_jax_interpret_kernel(nmax):
    """K2's plain path against make_fused_eps_multistep(interpret=True) on
    one eps block with the Gaussian score: same trajectory, same count."""
    b, d, spc = 8, 16, 4
    rng = np.random.default_rng(nmax)
    mean_t = rng.uniform(size=d).astype(np.float32)
    l = 0.5 * rng.standard_normal((d, d))
    prec = np.linalg.inv(l @ l.T + 1e-3 * np.eye(d)).astype(np.float32)
    eps_block = rng.standard_normal((spc * b, d)).astype(np.float32)
    mu = np.zeros(d, np.float32)
    f = np.eye(d, dtype=np.float32)

    jstep = jfs.make_fused_eps_multistep(jfs.gaussian_score_kernel, 2, b, d,
                                         spc, interpret=True)
    m_j, f_j, n_j = jstep(nmax, *_j(eps_block, mu, f, mean_t[None], prec))
    tstep = tfs.make_fused_eps_multistep(tfs.gaussian_score, 2, b, d, spc)
    m_t, f_t, n_t = tstep(nmax, *_t(eps_block, mu, f, mean_t[None], prec))
    assert int(n_t) == int(n_j) == nmax
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(f_j)).max()))


def test_gaussian_score_matches_jax():
    rng = np.random.default_rng(4)
    b, d = 8, 48
    x = rng.standard_normal((b, d)).astype(np.float32)
    mu_t = rng.standard_normal((1, d)).astype(np.float32)
    p = rng.standard_normal((d, d)).astype(np.float32)
    prec = (p @ p.T / d + np.eye(d)).astype(np.float32)
    got = tfs.gaussian_score(*_t(x, mu_t, prec))
    want = jfs.gaussian_score_kernel(*_j(x, mu_t, prec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_wrappers_take_cpu_or_cuda_only():
    """A wrapper runs its plain version only for CPU tensors; any other
    device raises (no silent fallback), as does a device mix."""
    b, d = 8, 16
    eps, v, mu, f = _t(*_inputs(0, b, d))
    meta = [t.to("meta") for t in (eps, v, mu, f)]
    with pytest.raises(ValueError, match="no kernel for device"):
        tfs.gsm_eps_update_fused(*meta)
    with pytest.raises(ValueError, match="several devices"):
        tfs.gaussian_score(eps, mu[None].to("meta"), f)
    step = tfs.make_fused_eps_multistep(tfs.gaussian_score, 2, b, d, 2)
    with pytest.raises(ValueError, match="nmax"):
        step(3, torch.zeros(2 * b, d), mu, f, mu[None], f)
    assert tfs.kernel_supports(1, 1) and tfs.kernel_supports(512, 8192)
    assert tfs.kernel_supports(64, 256, "chol")
    assert not tfs.kernel_supports(65, 256, "chol")
    assert not tfs.kernel_supports(513, 256)
    assert not tfs.kernel_supports(32, 8193)


def test_cpu_calls_launch_nothing_and_build_is_lazy(monkeypatch, tmp_path):
    """Plain-path calls do not count as launches, importing builds nothing,
    and a missing nvcc raises instead of falling back."""
    from gsmvi_tpu_torch.ops.cuda import _build

    tfs.reset_launch_counts()
    b, d = 8, 16
    eps, v, mu, f = _t(*_inputs(1, b, d))
    tfs.gsm_eps_update_fused(eps, v, mu, f)
    tfs.gaussian_score(eps, mu[None], f)
    counts = tfs.launch_counts()
    assert {"gsm_eps_update_fused", "make_fused_eps_multistep",
            "gaussian_score"} <= set(counts)
    assert counts == dict.fromkeys(tfs.KERNEL_WRAPPERS, 0)
    assert _build._LIBRARY is None
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path == _build.library_path()
    assert {p.name for p in _build._sources()} >= {
        "gemm.cuh", "gemm.cu", "eps_smallspace_cluster.cu", "thin_gemm.cu"}
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
