"""The port's dense GSM route against the JAX package: the update
(``ops/gsm.py``), K5's plain version (``ops/gsm_step.py``) against JAX's
``gsm_update_fused`` in interpret mode, and ``GSM(use_factor=False)`` fits
on JAX's own split-chain draws.

The K5 path runs on the CPU by monkeypatching the port's ``on_gpu``: the
wrapper then runs its plain version on the CPU tensors it is given.
Tolerances: float64 algebra agrees to 1e-12 (one update) and 1e-9 (a fit);
float32 sums in other orders agree to 1e-5 * max(1, |S|) for one update
(the JAX package's kernel-vs-XLA bound, tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.gsm as t_gsm
from gsmvi_tpu import GSM as JGSM
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.ops import gsm as jgsm
from gsmvi_tpu.ops.pallas.gsm_step import gsm_update_fused as j_fused
from gsmvi_tpu_torch import GSM
from gsmvi_tpu_torch.models import gaussian_target_from_arrays
from gsmvi_tpu_torch.ops import gsm as tgsm
from gsmvi_tpu_torch.ops import gsm_step

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def k5_path(monkeypatch):
    """Make GSM's dense route take its K5 path on the CPU."""
    monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)


def _update_inputs(seed, b, d, dtype, k=None):
    """(samples, vs, mu0, S0), S0 exactly symmetric; a leading replica axis
    with ``k``."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    l = 0.3 * rng.standard_normal((*lead, d, d))
    s0 = (l @ np.swapaxes(l, -1, -2) + np.eye(d)).astype(dtype)
    s0 = 0.5 * (s0 + np.swapaxes(s0, -1, -2))
    mu0 = rng.standard_normal((*lead, d)).astype(dtype)
    x = (mu0[..., None, :] + rng.standard_normal((*lead, b, d))).astype(dtype)
    v = rng.standard_normal((*lead, b, d)).astype(dtype)
    return x, v, mu0, s0


def _targets(seed, d, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = (0.6 * np.eye(d) + 0.3 * a @ a.T / d).astype(dtype)
    mean = rng.standard_normal(d).astype(dtype)
    return (_gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g"),
            gaussian_target_from_arrays(mean, cov, device=DEV))


def _split_chain_draws(key, n, b, d, dtype):
    """JAX's dense-route draws: ``key, ks = split(key)`` then
    ``normal(ks, (B, D))`` per step (gsmvi_tpu/gsm.py:221-222)."""
    draws = []
    for _ in range(n):
        key, ks = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(ks, (b, d), dtype)))
    return draws


@pytest.mark.parametrize("b,d", [(4, 6), (32, 64)])
def test_gsm_update_matches_jax_float64(b, d):
    x, v, mu0, s0 = _update_inputs(b + d, b, d, np.float64)
    mu_t, s_t = tgsm.gsm_update(*map(torch.from_numpy, (x, v, mu0, s0)))
    mu_j, s_j = jgsm.gsm_update(*map(jnp.asarray, (x, v, mu0, s0)))
    scale = max(1.0, float(np.abs(np.asarray(s_j)).max()))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0,
                               atol=1e-12 * max(1.0, float(np.abs(mu0).max())))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("b,d", [(8, 16), (32, 64), (1, 8), (1, 33),
                                 (129, 16)])
def test_k5_plain_matches_jax_interpret_kernel(b, d):
    """K5's plain version against the JAX Pallas kernel in interpret mode,
    float32 on both sides; S symmetric bit for bit on both."""
    x, v, mu0, s0 = _update_inputs(7 * b + d, b, d, np.float32)
    mu_t, s_t = gsm_step.gsm_update_fused(*map(torch.from_numpy,
                                               (x, v, mu0, s0)))
    mu_j, s_j = j_fused(*(jnp.asarray(a, jnp.float32) for a in
                          (x, v, mu0, s0)), interpret=True)
    s_j = np.asarray(s_j)
    scale = max(1.0, float(np.abs(s_j).max()))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(mu0).max())))
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=1e-5 * scale)
    assert torch.equal(s_t, s_t.T) and np.array_equal(s_j, s_j.T)


def test_k5_batched_equals_single_calls():
    x, v, mu0, s0 = map(torch.from_numpy,
                        _update_inputs(3, 8, 16, np.float32, k=3))
    mu, s = gsm_step.gsm_update_fused(x, v, mu0, s0)
    assert mu.shape == (3, 16) and s.shape == (3, 16, 16)
    for i in range(3):
        mu_i, s_i = gsm_step.gsm_update_fused(x[i], v[i], mu0[i], s0[i])
        assert torch.equal(mu[i], mu_i) and torch.equal(s[i], s_i)


def test_dense_fit_matches_jax_float64():
    """GSM(use_factor=False) in float64 on the plain route, fed JAX's own
    split-chain draws, against JAX GSM(use_factor=False): 1e-9."""
    d, b, niter = 6, 4, 40
    tj, tt = _targets(1, d, np.float64)
    key = jax.random.PRNGKey(3)
    sj = JGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float64,
              use_factor=False).fit(key, batch_size=b, niter=niter,
                                    verbose=False, return_state=True)
    draws = _split_chain_draws(key, niter + 1, b, d, jnp.float64)
    g = GSM(d, tt.lp, tt.lp_g, dtype=torch.float64, use_factor=False,
            device=DEV)
    g._eps = lambda seed, step, batch, dd, dtype: torch.tensor(draws[step])
    st = g.fit(0, batch_size=b, niter=niter, verbose=False,
               return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=0,
                               atol=1e-9)


def test_dense_fit_on_the_k5_path_matches_jax_float32(k5_path):
    """The same fit in float32 through the K5 path (its plain version on
    the CPU) against JAX's dense float32 step over 31 steps: float32 sums
    in other orders, compounded over the steps, within 1e-4 * max(1, |x|)."""
    d, b, niter = 16, 8, 30
    tj, tt = _targets(2, d, np.float32)
    key = jax.random.PRNGKey(4)
    sj = JGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float32,
              use_factor=False).fit(key, batch_size=b, niter=niter,
                                    verbose=False, return_state=True)
    draws = _split_chain_draws(key, niter + 1, b, d, jnp.float32)
    g = GSM(d, tt.lp, tt.lp_g, use_factor=False, device=DEV)
    assert g._dense_fused(b)
    g._eps = lambda seed, step, batch, dd, dtype: torch.tensor(draws[step])
    st = g.fit(0, batch_size=b, niter=niter, verbose=False,
               return_state=True)
    assert int(st.n_accepted) == int(sj.n_accepted)
    for got, want in ((st.mean, sj.mean), (st.cov, sj.cov)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * max(
            1.0, float(np.abs(want).max())))
    assert torch.equal(st.cov, st.cov.T)


def test_huge_batch_guard_sends_the_fit_to_k5(k5_path, monkeypatch):
    """B=128 with 2B > D=64 runs the dense route even on the card, and its
    step goes through K5."""
    d, b = 64, 128
    tt = _targets(3, d, np.float32)[1]
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return gsm_step.gsm_update_fused(*args)

    monkeypatch.setattr(t_gsm, "gsm_update_fused", spy)
    g = GSM(d, tt.lp, tt.lp_g, device=DEV)
    assert not g._factor_route(b) and g._dense_fused(b)
    mean, cov = g.fit(0, batch_size=b, niter=4, verbose=False)
    assert calls == [(b, d)] * 5
    assert torch.isfinite(mean).all() and torch.isfinite(cov).all()


def test_k5_range_and_dtype_raise_on_the_card(k5_path):
    """On the card the dense route runs K5 or raises; use_fused=False is
    the plain route there.  The wrapper takes CPU or CUDA tensors only."""
    d = 16
    tt = _targets(5, d, np.float32)[1]
    with pytest.raises(NotImplementedError, match="float32"):
        GSM(d, tt.lp, tt.lp_g, dtype=torch.float64, use_factor=False,
            device=DEV)._dense_fused(8)
    with pytest.raises(ValueError, match=r"B in \[1, 65536\]"):
        GSM(d, tt.lp, tt.lp_g, use_factor=False,
            device=DEV)._dense_fused(65537)
    with pytest.raises(ValueError, match=r"D in \[1, 8192\]"):
        GSM(8193, tt.lp, tt.lp_g, use_factor=False,
            device=DEV)._dense_fused(8)
    assert not GSM(d, tt.lp, tt.lp_g, dtype=torch.float64, use_factor=False,
                   use_fused=False, device=DEV)._dense_fused(8)
    x, v, mu0, s0 = map(torch.from_numpy,
                        _update_inputs(0, 4, d, np.float32))
    with pytest.raises(ValueError, match="no kernel for device"):
        gsm_step.gsm_update_fused(*(a.to("meta") for a in (x, v, mu0, s0)))
    assert gsm_step.gsm_step_supports(1, 1)
    assert gsm_step.gsm_step_supports(65536, 8192)
    assert not gsm_step.gsm_step_supports(0, 16)
