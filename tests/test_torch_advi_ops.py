"""The port's ADVI ops (gsmvi_tpu_torch/ops/advi_fused.py and the ADVI loss)
against the JAX package on identical numpy-made inputs.

K9's and K10's wrappers run their plain versions on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_advi_fused.py
and tests/test_advi_stl_fused.py do, on the same eps blocks and the same
per-step learning rates and bias corrections.  Counts and flags must be
equal.  Tolerance 2e-5 (absolute and relative), the JAX package's own
interpret-vs-autodiff bound (tests/test_advi_fused.py:96-99): float32 on
both sides with sums in other orders.  The loss and its gradient are
compared in float64, where both packages compute the same expression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmvi_tpu import ADVI as JADVI
from gsmvi_tpu.advi import _lr_bias_arrays as j_lr_bias_arrays
from gsmvi_tpu.ops.pallas import advi_fused as jaf
from gsmvi_tpu.ops.pallas.fused_step import gaussian_score_kernel
from gsmvi_tpu_torch import ADVI
from gsmvi_tpu_torch.ops import advi_fused as taf
from gsmvi_tpu_torch.ops import fused_step as tfs

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _problem(seed, b, d, spc, lscale=0.1):
    """A Gaussian target's score params, a start state and an eps block
    (numpy float32)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = 0.5 * np.eye(d) + 0.25 * a @ a.T / d
    prec = np.linalg.inv(cov).astype(np.float32)
    mu_t = rng.standard_normal((1, d)).astype(np.float32)
    loc = rng.standard_normal(d).astype(np.float32)
    l = np.tril(np.eye(d) + lscale * rng.standard_normal((d, d))
                ).astype(np.float32)
    block = rng.standard_normal((spc * b, d)).astype(np.float32)
    return (mu_t, prec), loc, l, block


def _bias(spc, lrs, step0=0):
    t = np.arange(step0 + 1, step0 + spc + 1, dtype=np.float32)
    return (np.asarray(lrs, np.float32),
            (1.0 / (1.0 - np.float32(0.9) ** t)).astype(np.float32),
            (1.0 / (1.0 - np.float32(0.999) ** t)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _moments(d, rng=None):
    """Zero moments, or (with ``rng``) a warm set: m ~ N(0, 0.1), v > 0."""
    if rng is None:
        return [np.zeros(d, np.float32), np.zeros(d, np.float32),
                np.zeros((d, d), np.float32), np.zeros((d, d), np.float32)]
    return [(0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.01 + rng.random(d)).astype(np.float32),
            np.tril(0.1 * rng.standard_normal((d, d))).astype(np.float32),
            np.tril(0.01 + rng.random((d, d))).astype(np.float32)]


K9_CASES = {
    "full": (5, [1e-2] * 5, False),
    "nmax_lt_spc": (3, [1e-2] * 5, False),
    "lr_schedule_warm_moments": (5, [0.05, 0.03, 0.02, 0.05, 0.01], True),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_k9_plain_version_matches_jax_kernel(case):
    nmax, lr_list, warm = K9_CASES[case]
    b, d, spc = 8, 12, 5
    (mu_t, prec), loc, l, block = _problem(3, b, d, spc)
    lrs, bc1s, bc2s = _bias(spc, lr_list, step0=7 if warm else 0)
    moments = _moments(d, np.random.default_rng(4) if warm else None)
    jmulti = jaf.make_fused_advi_multistep(gaussian_score_kernel, 2, b, d,
                                           spc, interpret=True)
    want = jmulti(lrs, bc1s, bc2s, nmax, *_j(block, loc, l, *moments,
                                             mu_t, prec))
    tmulti = taf.make_fused_advi_multistep(tfs.gaussian_score, 2, b, d, spc)
    got = tmulti(lrs, bc1s, bc2s, nmax, *_t(block, loc, l, *moments, mu_t,
                                            prec))
    for name, g, w in zip(("loc", "l", "mloc", "vloc", "ml", "vl"), got,
                          want):
        _close(g.numpy(), w, what=f"{case}: {name}")
    assert np.all(np.triu(got[1].numpy(), 1) == 0)
    if nmax < spc:
        # The tail of the block is never read.
        block2 = block.copy()
        block2[nmax * b:] = 123.0
        again = tmulti(lrs, bc1s, bc2s, nmax, *_t(block2, loc, l, *moments,
                                                  mu_t, prec))
        for g, g2 in zip(got, again):
            assert torch.equal(g, g2)


K10_CASES = {
    # name: (nmax, lrs, poison sub-step, stale ainv, (n_done, stiff))
    "full": (5, [0.02, 0.01, 0.02, 0.015, 0.01], None, False, (5, 0)),
    "nmax_lt_spc": (3, [1e-2] * 5, None, False, (3, 0)),
    # A huge step at sub-step 2 moves L so far that sub-step 3's tracking
    # residual trips the gate: the block stops there, unconsumed.
    "gate_trip_at_3": (5, [1e-3, 1e-3, 0.5, 1e-3, 1e-3], None, False, (3, 1)),
    # A stale inverse trips the gate at sub-step 0.
    "gate_trip_at_0": (4, [1e-2] * 5, None, True, (0, 1)),
    # s ~ 1e30 at sub-step 2: G^T E overflows, the block freezes there.
    "nonfinite_gradient": (5, [1e-2] * 5, 2, False, (2, 1)),
}


@pytest.mark.parametrize("case", sorted(K10_CASES))
def test_k10_plain_version_matches_jax_kernel(case):
    nmax, lr_list, poison, stale, counts = K10_CASES[case]
    b, d, spc = 8, 12, 5
    (mu_t, prec), loc, l, block = _problem(5, b, d, spc, lscale=0.05)
    if stale:
        l = np.tril(2.0 * np.eye(d) + 0.5 * np.random.default_rng(6)
                    .standard_normal((d, d))).astype(np.float32)
        ainv = np.eye(d, dtype=np.float32)
    else:
        ainv = np.linalg.inv(l.astype(np.float64)).astype(np.float32)
        ainv = np.tril(ainv)
    if poison is not None:
        block[poison * b:(poison + 1) * b] = 1e30
    lrs, bc1s, bc2s = _bias(spc, lr_list)
    moments = _moments(d)
    jmulti = jaf.make_fused_advi_stl_multistep(gaussian_score_kernel, 2, b,
                                               d, spc, interpret=True)
    want = jmulti(lrs, bc1s, bc2s, nmax, *_j(block, loc, l, ainv, *moments,
                                             mu_t, prec))
    tmulti = taf.make_fused_advi_stl_multistep(tfs.gaussian_score, 2, b, d,
                                               spc)
    got = tmulti(lrs, bc1s, bc2s, nmax, *_t(block, loc, l, ainv, *moments,
                                            mu_t, prec))
    assert (int(got[7]), int(got[8])) == (int(want[7]), int(want[8])) \
        == counts
    assert got[7].dtype == got[8].dtype == torch.int32
    for name, g, w in zip(("loc", "l", "ainv", "mloc", "vloc", "ml", "vl"),
                          got[:7], want[:7]):
        assert np.all(np.isfinite(g.numpy())), name
        _close(g.numpy(), w, what=f"{case}: {name}")
    if counts[0] == 0:
        assert torch.equal(got[0], torch.from_numpy(loc))
        assert torch.equal(got[2], torch.from_numpy(ainv))
    # The report carries the same counts for the one host read.
    rep = tmulti.packed(lrs, bc1s, bc2s, nmax, *_t(block, loc, l, ainv,
                                                   *moments, mu_t, prec))[-1]
    assert (rep[taf.REP_NDONE].item(), rep[taf.REP_STIFF].item()) == counts


def test_lr_bias_arrays_and_adam_match_jax():
    """Per-step rates and float32 bias corrections of a schedule at
    absolute steps, and one Adam update, as the JAX package computes
    them."""
    steps = np.arange(995, 1003, dtype=np.int32)
    sched_j = lambda s: 3e-2 * 0.5 ** (s / 20)
    sched_t = lambda s: 3e-2 * 0.5 ** (s / 20)
    want = j_lr_bias_arrays(sched_j, jnp.float32(0.9), jnp.float32(0.999),
                            jnp.asarray(steps))
    got = taf.lr_bias_arrays(sched_t, 0.9, 0.999, torch.from_numpy(steps))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    const = taf.lr_bias_arrays(lambda s: 1e-2, 0.9, 0.999, [0, 1])
    assert const[0].tolist() == [np.float32(1e-2)] * 2
    rng = np.random.default_rng(0)
    p, m, g = rng.standard_normal((3, 6)).astype(np.float32)
    v = rng.random(6).astype(np.float32)
    want = jaf._adam_apply(*_j(p, m, v, g), jnp.float32(0.01),
                           jnp.float32(10.0), jnp.float32(1000.0), 0.9,
                           0.999, 1e-8)
    got = taf._adam_apply(*_t(p, m, v, g), 0.01, 10.0, 1000.0, 0.9, 0.999,
                          1e-8)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_neg_elbo_and_gradient_match_jax(estimator):
    """Value and gradient in float64 on the same draw (JAX's own
    ``normal(key, (B, D))``), with one diagonal entry below the STL clamp."""
    from gsmvi_tpu.models.gaussian import _gaussian_target

    from gsmvi_tpu_torch.models import gaussian_target_from_arrays

    b, d = 8, 10
    rng = np.random.default_rng(2)
    a = rng.standard_normal((d, d))
    cov = np.eye(d) + 0.3 * a @ a.T / d
    mean = rng.standard_normal(d)
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov)
    loc = rng.standard_normal(d)
    l = np.tril(np.eye(d) + 0.2 * rng.standard_normal((d, d)))
    l[3, 3] = 1e-9                         # under 1e-5 * max|diag|
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (b, d), jnp.float64))
    gj = JADVI(D=d, lp=tj.lp, dtype=jnp.float64)
    fj = lambda p: gj.neg_elbo(p, key, b, estimator)
    want, want_g = jax.value_and_grad(fj)((jnp.asarray(loc), jnp.asarray(l)))
    gt = ADVI(d, tt.lp, dtype=torch.float64)
    lt = torch.tensor(loc, requires_grad=True)
    st = torch.tensor(l, requires_grad=True)
    got = gt.neg_elbo((lt, st), torch.from_numpy(eps), estimator)
    got_g = torch.autograd.grad(got, (lt, st))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="estimator"):
        gt.neg_elbo((lt, st), torch.from_numpy(eps), "slt")


def test_parameter_forms_match_jax():
    d = 5
    rng = np.random.default_rng(1)
    flat = rng.standard_normal(d * (d + 1) // 2)
    dense = rng.standard_normal((d, d))
    gj = JADVI(D=d, lp=lambda x: jnp.sum(x), dtype=jnp.float64)
    gt = ADVI(d, lambda x: torch.sum(x), dtype=torch.float64)
    for arr in (flat, dense):
        np.testing.assert_array_equal(
            gt.scales_to_tril(torch.from_numpy(arr)).numpy(),
            np.asarray(gj.scales_to_tril(jnp.asarray(arr))))
        np.testing.assert_allclose(
            gt.scales_to_cov(torch.from_numpy(arr)).numpy(),
            np.asarray(gj.scales_to_cov(jnp.asarray(arr))), rtol=1e-12)
    l = np.tril(dense)
    l[2, 2] = -1e-12
    np.testing.assert_array_equal(
        gt._safe_tril(torch.from_numpy(l)).numpy(),
        np.asarray(JADVI._safe_tril(jnp.asarray(l))))


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors the wrappers count no launch and check their
    arguments; the range gate is K3's."""
    tfs.reset_launch_counts()
    b, d, spc = 8, 16, 2
    (mu_t, prec), loc, l, block = _problem(0, b, d, spc)
    args = _t(block, loc, l, *_moments(d), mu_t, prec)
    multi = taf.make_fused_advi_multistep(tfs.gaussian_score, 2, b, d, spc)
    multi([1e-2] * spc, [1.0] * spc, [1.0] * spc, spc, *args)
    with pytest.raises(ValueError, match="nmax"):
        multi([1e-2] * spc, [1.0] * spc, [1.0] * spc, spc + 1, *args)
    with pytest.raises(ValueError, match="learning rates"):
        multi([1e-2], [1.0] * spc, [1.0] * spc, spc, *args)
    with pytest.raises(ValueError, match="sweeps"):
        taf.make_fused_advi_stl_multistep(tfs.gaussian_score, 2, b, d, spc,
                                          sweeps=0)
    counts = tfs.launch_counts()
    assert counts["make_fused_advi_multistep"] == 0
    assert counts["make_fused_advi_stl_multistep"] == 0
    assert taf.advi_kernel_supports(8, 16) and taf.advi_kernel_supports(
        64, 1024)
    assert not taf.advi_kernel_supports(4, 256)
    assert not taf.advi_kernel_supports(32, 2048)
    assert taf.stl_gate_first(0.05, 2) == 0.05 ** 0.25
