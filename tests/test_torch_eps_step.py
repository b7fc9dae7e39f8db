"""K4 of the port (``make_fused_eps_step``), its exact variant K4a
(``gsm_eps_update_fused(method="chol")``) and its Philox draw, against the
JAX package on identical numpy-made inputs.

The JAX side runs as ``tests/test_pallas.py`` runs it on the CPU: the Pallas
kernels in interpret mode, with ``external_eps=True`` (the TPU's hardware
PRNG has no CPU path, and its stream cannot be reproduced anyway, so the
Philox draw is tested on its own plain version and on its distribution).
The conftest turns JAX x64 on, so every array handed to JAX is float32.

Tolerances: float32 on both sides, sums in other orders.  A whole step
(score, then update) within 1e-4 on the mean and 2e-4 * max|S| on S = F F^T,
the JAX package's own kernel-vs-exact bound (tests/test_pallas.py:78-84);
K4a alone, a single update on given scores, within 1e-5 on the mean and
1e-5 * max|F| on F (the bound of tests/test_torch_fused_step.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu_torch.ops import fused_step as tfs

MEAN_TOL, COV_TOL = 1e-4, 2e-4
UPDATE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _step_problem(seed, b, d):
    """A Gaussian target's score params, a state and a draw (float32)."""
    rng = np.random.default_rng(seed)
    mean_t = rng.uniform(size=(1, d)).astype(np.float32)
    l = 0.5 * rng.standard_normal((d, d))
    prec = np.linalg.inv(l @ l.T + 1e-3 * np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    return (mean_t, prec), mu, f, eps


def _indefinite_problem(b, d):
    """Draws at 1e4 with the score v = e (prec = -I, mean 0, F = I): the
    update's E^T E - C^T C cancels to O(1) between entries of 1e8, so in
    float32 the Cholesky of K = I + Lg^T J Lg meets a negative pivot in any
    summation order."""
    rng = np.random.default_rng(b + d)
    params = (np.zeros((1, d), np.float32), -np.eye(d, dtype=np.float32))
    eps = (1e4 * rng.standard_normal((b, d))).astype(np.float32)
    return params, np.zeros(d, np.float32), np.eye(d, dtype=np.float32), eps


def _cov_close(f_got, f_want):
    s_got = np.asarray(f_got, np.float64) @ np.asarray(f_got, np.float64).T
    s_want = np.asarray(f_want, np.float64) @ np.asarray(f_want, np.float64).T
    np.testing.assert_allclose(
        s_got, s_want, rtol=0,
        atol=COV_TOL * max(1.0, float(np.abs(s_want).max())))


@pytest.mark.parametrize("method", ["ns", "chol"])
@pytest.mark.parametrize("b,d", [(8, 16), (8, 32)])
def test_step_plain_matches_jax_interpret_kernel(b, d, method):
    params, mu, f, eps = _step_problem(10 * b + d, b, d)
    jstep = jfs.make_fused_eps_step(jfs.gaussian_score_kernel, 2, b, d,
                                    external_eps=True, interpret=True,
                                    method=method)
    m_j, f_j, g_j = jstep(*_j(eps, mu, f, *params))
    tstep = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d,
                                    external_eps=True, method=method)
    m_t, f_t, g_t = tstep(*_t(eps, mu, f, *params))
    assert bool(g_t) == bool(g_j) is True
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=MEAN_TOL)
    _cov_close(f_t.numpy(), np.asarray(f_j))


def test_chol_step_rejects_with_jax_and_keeps_state():
    b, d = 8, 16
    params, mu, f, eps = _indefinite_problem(b, d)
    jstep = jfs.make_fused_eps_step(jfs.gaussian_score_kernel, 2, b, d,
                                    external_eps=True, interpret=True,
                                    method="chol")
    _, _, g_j = jstep(*_j(eps, mu, f, *params))
    tstep = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d,
                                    external_eps=True, method="chol")
    m_t, f_t, g_t = tstep(*_t(eps, mu, f, *params))
    assert not bool(g_t) and not bool(g_j)
    np.testing.assert_array_equal(m_t.numpy(), mu)
    np.testing.assert_array_equal(f_t.numpy(), f)


def _update_inputs(seed, b, d):
    rng = np.random.default_rng(seed)
    f = (0.3 * rng.standard_normal((d, d)) + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return eps, v, mu, f


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("b,d", [(8, 16), (8, 32), (16, 64)])
def test_chol_update_plain_matches_jax_interpret_kernel(b, d, with_ef):
    eps, v, mu, f = _update_inputs(b * d, b, d)
    ef = (eps @ f.T).astype(np.float32) if with_ef else None
    m_t, f_t, g_t = tfs.gsm_eps_update_fused(
        *_t(eps, v, mu, f), method="chol",
        ef=None if ef is None else _t(ef)[0])
    m_j, f_j, g_j = jfs.gsm_eps_update_fused(*_j(eps, v, mu, f),
                                             interpret=True, method="chol")
    assert bool(g_t) == bool(g_j) is True
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=UPDATE_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=UPDATE_TOL * float(np.abs(f).max()))
    # The twin's core and select are the pieces the wrapper runs.
    m_c, f_c, g_c = tfs.eps_update_core_reference(
        *_t(eps, v, mu[None], f), batch=b,
        ef_t=None if ef is None else _t(ef)[0])
    assert bool(g_c)
    np.testing.assert_array_equal(m_t.numpy(), m_c[0].numpy())


def test_chol_update_nan_score_rejects_like_jax():
    """A NaN score makes G and K NaN: the NaN pivot must fail the
    ``minpiv > 0`` test (a NaN-dropping min would let it pass), and the old
    state comes back on both sides."""
    b, d = 8, 16
    eps, v, mu, f = _update_inputs(3, b, d)
    v[2, 5] = np.nan
    m_t, f_t, g_t = tfs.gsm_eps_update_fused(*_t(eps, v, mu, f),
                                             method="chol")
    m_j, f_j, g_j = jfs.gsm_eps_update_fused(*_j(eps, v, mu, f),
                                             interpret=True, method="chol")
    assert not bool(g_t) and not bool(g_j)
    np.testing.assert_array_equal(m_t.numpy(), mu)
    np.testing.assert_array_equal(f_t.numpy(), f)
    np.testing.assert_array_equal(np.asarray(f_j), f)


def test_cholesky_twins_pivots_and_inverse():
    """``_cholt_reference`` factors an SPD matrix (L^T upper, L L^T = W),
    reports a negative minimum pivot for an indefinite one and a NaN one
    for a NaN entry; ``_triu_inv_reference`` inverts the upper triangle."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12))
    w = torch.from_numpy(a @ a.T + 12 * np.eye(12))
    lt, minpiv = tfs._cholt_reference(w)
    torch.testing.assert_close(lt.T @ lt, w, rtol=0, atol=1e-10)
    assert torch.equal(lt, torch.triu(lt)) and float(minpiv) > 0
    m = tfs._triu_inv_reference(lt)
    torch.testing.assert_close(m @ lt, torch.eye(12, dtype=w.dtype), rtol=0,
                               atol=1e-12)
    indefinite = w.clone()
    indefinite[5, 5] = -50.0
    assert float(tfs._cholt_reference(indefinite)[1]) < 0
    poisoned = w.clone()
    poisoned[7, 7] = float("nan")
    assert math.isnan(float(tfs._cholt_reference(poisoned)[1]))


def test_multistep_plain_is_chained_steps():
    """K2's plain path is K4's plain step per sub-step, bit for bit (the
    two share one per-step helper on the card as well)."""
    b, d, spc = 8, 16, 4
    params, mu, f, _ = _step_problem(5, b, d)
    block = np.random.default_rng(6).standard_normal(
        (spc * b, d)).astype(np.float32)
    p = _t(*params)
    multi = tfs.make_fused_eps_multistep(tfs.gaussian_score, 2, b, d, spc)
    m_k2, f_k2, n_k2 = multi(spc, *_t(block, mu, f), *p)
    step = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d,
                                   external_eps=True)
    m, ff = _t(mu, f)
    n = 0
    for j in range(spc):
        m, ff, good = step(_t(block[j * b:(j + 1) * b])[0], m, ff, *p)
        n += int(good)
    assert torch.equal(m, m_k2) and torch.equal(ff, f_k2) and n == int(n_k2)


PHILOX_KAT = [  # Random123 known answers, Philox4x32-10
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = tfs.philox4x32_reference(torch.tensor([ctr], dtype=torch.int64),
                                   *key)
    assert tuple(got[0].tolist()) == want
    if ctr == (0, 0, 0, 0):
        assert tuple(tfs.philox4x32(1, *key, device="cpu")[0].tolist()) == want


def test_philox_normal_distribution():
    """2^20 draws: |mean| < 5e-3 (5 sigma), |var - 1| < 1e-2 (7 sigma), the
    Kolmogorov-Smirnov distance to N(0, 1) < 3e-3 (its 0.1 % critical value
    is 1.9e-3); another seed gives other draws."""
    z = tfs.philox_normal(12345, 1024, 1024, device="cpu")
    assert z.shape == (1024, 1024) and z.dtype == torch.float32
    x = z.reshape(-1).double()
    assert abs(float(x.mean())) < 5e-3
    assert abs(float(x.var()) - 1.0) < 1e-2
    xs, _ = torch.sort(x)
    n = xs.numel()
    cdf = 0.5 * (1.0 + torch.erf(xs / math.sqrt(2.0)))
    i = torch.arange(1, n + 1, dtype=torch.float64)
    ks = max(float((i / n - cdf).max()), float((cdf - (i - 1) / n).max()))
    assert ks < 3e-3
    z2 = tfs.philox_normal(12346, 1024, 1024, device="cpu")
    assert float((z2 - z).abs().mean()) > 0.5
    # Odd count: the last block's second normal is dropped.
    odd = tfs.philox_normal_reference(7, 3, 5, device="cpu")
    assert torch.equal(odd.reshape(-1),
                       tfs.philox_normal_reference(7, 2, 8, "cpu")
                       .reshape(-1)[:15])


def test_onchip_draw_step_runs_the_philox_draw():
    """``external_eps=False``: the first argument is a seed and the step
    equals the external-draw step on ``philox_normal(seed)``."""
    b, d = 8, 16
    params, mu, f, _ = _step_problem(9, b, d)
    p = _t(*params)
    on_chip = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d)
    external = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d,
                                       external_eps=True)
    got = on_chip(77, *_t(mu, f), *p)
    want = external(tfs.philox_normal(77, b, d, device="cpu"), *_t(mu, f),
                    *p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    other = on_chip(78, *_t(mu, f), *p)
    assert not torch.equal(other[1], got[1])


def test_wrappers_refuse_what_they_do_not_take():
    b, d = 8, 16
    eps, v, mu, f = _t(*_update_inputs(0, b, d))
    with pytest.raises(ValueError, match="method"):
        tfs.gsm_eps_update_fused(eps, v, mu, f, method="lu")
    with pytest.raises(ValueError, match="method"):
        tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d, method="qr")
    with pytest.raises(ValueError, match=r"\(B, D\) required"):
        tfs.gsm_eps_update_fused(eps[None], v[None], mu[None], f[None],
                                 method="chol")
    step = tfs.make_fused_eps_step(tfs.gaussian_score, 2, b, d,
                                   external_eps=True)
    with pytest.raises(ValueError, match="score params"):
        step(eps, mu, f, mu[None])
    meta = [x.to("meta") for x in (eps, mu, f)]
    with pytest.raises(ValueError, match="no kernel for device"):
        step(*meta, mu[None].to("meta"), f.to("meta"))
    tfs.reset_launch_counts()
    step(eps, mu, f, mu[None], f)
    tfs.gsm_eps_update_fused(eps, v, mu, f, method="chol")
    assert tfs.launch_counts()["make_fused_eps_step"] == 0
    assert tfs.launch_counts()["gsm_eps_update_fused"] == 0
