"""The fitters' options against the JAX package on the CPU: host (numpy)
score callables (GSM's dense eager loop, ``BaM(jit_compile=False)``), the
port's ``compat.gsm_numpy``, and ``pallas_precision`` "bf16"/"high" on the
plain versions of the O(B D^2) products.

Tolerances: float64 algebra on the same draws agrees to 1e-9 over a short
fit; a numpy wrapper of a tensor score computes the same numbers, so its
fit equals the tensor fit bit for bit; the numpy GSM is the same numpy
code on the same seed, bit for bit.  The precisions: ``bf16_round`` is
round to nearest even, as JAX's ``astype(jnp.bfloat16)``, bit for bit;
bf16x3 drops only a_lo b_lo and the rounding of a_lo, b_lo (each below
2^-18 of |a b|), so "high" lies within 2^-16 of the float64 product
relative to |a| @ |b|; "bf16" rounds each operand by at most 2^-9, so its
product lies within 2^-8 (1 + 2^-8) |a| @ |b| of the exact one, plus
float32 sums.  JAX on the CPU ignores ``Precision.DEFAULT``/``HIGH``: its
"bf16" and "high" products are float32 there, so the port's plain
versions are held to the bounds above against JAX's float32 results, not
to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.gsm as t_gsm
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu import BaM as JBaM
from gsmvi_tpu import GSM as JGSM
from gsmvi_tpu import Regularizers as JRegularizers
from gsmvi_tpu.compat.gsm_numpy import GSM as JNumpyGSM
from gsmvi_tpu.compat.gsm_numpy import gsm_update as j_np_update
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.ops.pallas.fused_step import gsm_eps_update_ns_xla
from gsmvi_tpu_torch import (BaM, FactorBaM, FactorGSM, GSM, Regularizers)
from gsmvi_tpu_torch.compat import GSM as NumpyGSM
from gsmvi_tpu_torch.compat import gsm_update as np_update
from gsmvi_tpu_torch.driver import host_score, takes_tensors
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
HIGH_REL = 2.0 ** -16
BF16_REL = 2.0 ** -8 * (1 + 2.0 ** -8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _targets(seed, d, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = (0.6 * np.eye(d) + 0.3 * a @ a.T / d).astype(dtype)
    mean = rng.standard_normal(d).astype(dtype)
    return (_gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g"),
            gaussian_target_from_arrays(mean, cov, device=DEV), mean, cov)


def _numpy_score(mean, cov):
    """A plain-numpy score of N(mean, cov), as the reference's users write
    one (examples/example_gsm_numpy.py)."""
    prec = np.linalg.inv(cov)
    return lambda x: (mean - np.atleast_2d(x)) @ prec


def _numpy_wrapper(lp_g):
    """A numpy callable around a tensor score: the same numbers."""
    return lambda x: lp_g(torch.from_numpy(np.asarray(x))).numpy()


def _split_chain_draws(key, n, b, d, dtype):
    """JAX's dense (and eager) draws: ``key, ks = split(key)``, then
    ``normal(ks, (B, D))`` per step (gsmvi_tpu/gsm.py:221-222, :247-249)."""
    draws = []
    for _ in range(n):
        key, ks = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(ks, (b, d), dtype)))
    return draws


def _feed(fitter, draws):
    fitter._eps = lambda seed, step, batch, dd, dtype: torch.tensor(
        draws[step])


# ---------------------------------------------------------------------------
# Host callables
# ---------------------------------------------------------------------------

def test_takes_tensors_probe_follows_jax_rule():
    """A tensor callable passes the probe; one that raises on a tensor, or
    returns something that is not a tensor, is a host callable (any
    exception counts, as in ``is_traceable``)."""
    _, tt, mean, cov = _targets(0, 5, np.float64)
    probe = dict(batch=3, d=5, dtype=torch.float64, device=DEV)
    assert takes_tensors(tt.lp_g, **probe)
    assert not takes_tensors(_numpy_score(mean, cov), **probe)
    assert not takes_tensors(_numpy_wrapper(tt.lp_g), **probe)

    def raises(x):
        raise RuntimeError("not on tensors")

    assert not takes_tensors(raises, **probe)
    x = torch.randn(3, 5, dtype=torch.float64)
    v = host_score(_numpy_score(mean, cov))(x)
    assert v.dtype == x.dtype and v.device == x.device
    assert torch.allclose(v, tt.lp_g(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("niter", [0, 12])
def test_numpy_gsm_step_matches_jax_eager_loop(niter):
    """GSM with a numpy ``lp_g``: the port's dense eager loop against JAX's
    (``_make_eager_step``) on JAX's draws, float64: one step (niter=0) and
    a short fit within 1e-9."""
    d, b = 6, 4
    _, _, mean, cov = _targets(1, d, np.float64)
    lp_g = _numpy_score(mean, cov)
    key = jax.random.PRNGKey(5)
    sj = JGSM(D=d, lp=None, lp_g=lp_g, dtype=jnp.float64).fit(
        key, batch_size=b, niter=niter, verbose=False, return_state=True)
    g = GSM(d, None, lp_g, dtype=torch.float64, device=DEV)
    assert g._host(b) and not g._factor_route(b, True)
    _feed(g, _split_chain_draws(key, niter + 1, b, d, jnp.float64))
    st = g.fit(0, batch_size=b, niter=niter, verbose=False,
               return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("niter", [0, 12])
def test_numpy_bam_step_matches_jax_eager_loop(niter):
    """BaM with a numpy ``lp_g`` and ``jit_compile=False``: the port's
    eager loop against JAX's on JAX's draws (retries=0, one attempt a
    step), float64, within 1e-9."""
    d, b = 6, 4
    _, _, mean, cov = _targets(2, d, np.float64)
    lp_g = _numpy_score(mean, cov)
    key = jax.random.PRNGKey(6)
    sj = JBaM(D=d, lp=None, lp_g=lp_g, dtype=jnp.float64,
              jit_compile=False).fit(
        key, JRegularizers().linear(10.0), batch_size=b, niter=niter,
        verbose=False, retries=0, return_state=True)
    bm = BaM(d, None, lp_g, jit_compile=False, dtype=torch.float64,
             device=DEV)
    _feed(bm, _split_chain_draws(key, niter + 1, b, d, jnp.float64))
    st = bm.fit(0, Regularizers().linear(10.0), batch_size=b, niter=niter,
                verbose=False, retries=0, return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("k5", [False, True])
def test_numpy_wrapped_gsm_fit_equals_tensor_fit(monkeypatch, k5):
    """A numpy wrapper of a tensor score gives the tensor score's numbers,
    so its eager fit equals the tensor dense fit bit for bit, on the plain
    update and on K5's path (its plain version on the CPU)."""
    if k5:
        monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)
    d, b = 12, 8
    t = dense_gaussian(3, d, scale=0.3, device=DEV)
    kw = dict(batch_size=b, niter=60, verbose=False, return_state=True)
    ref = GSM(d, t.lp, t.lp_g, use_factor=False, device=DEV).fit(1, **kw)
    g = GSM(d, t.lp, _numpy_wrapper(t.lp_g), device=DEV)
    assert g._dense_fused(b) == k5
    st = g.fit(1, **kw)
    for name in ("mean", "cov", "chol", "n_accepted"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name


def test_numpy_wrapped_bam_fit_equals_tensor_fit():
    d, b = 12, 8
    t = dense_gaussian(4, d, scale=0.3, device=DEV)
    regf = Regularizers().linear(10.0)
    kw = dict(batch_size=b, niter=40, verbose=False, return_state=True)
    ref = BaM(d, t.lp, t.lp_g, use_factor=False, device=DEV).fit(1, regf,
                                                                  **kw)
    for bm in (BaM(d, t.lp, _numpy_wrapper(t.lp_g), device=DEV),
               BaM(d, t.lp, _numpy_wrapper(t.lp_g), jit_compile=False,
                   use_factor=True, device=DEV)):
        st = bm.fit(1, regf, **kw)
        for name in ("mean", "cov", "chol", "n_accepted"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name


def test_numpy_score_fit_batch_replicas_equal_single_fits(monkeypatch):
    """``fit_batch`` with a numpy score takes the dense route (JAX's rule,
    gsmvi_tpu/gsm.py:356), and each replica equals its single fit bit for
    bit, for GSM and BaM."""
    d, b, seeds = 8, 4, (0, 5, 9)
    t = dense_gaussian(5, d, scale=0.3, device=DEV)
    lp_g = _numpy_wrapper(t.lp_g)
    g = GSM(d, t.lp, lp_g, use_factor=True, device=DEV)
    with pytest.warns(UserWarning, match="does not take tensors"):
        batch = g.fit_batch(seeds, batch_size=b, niter=20,
                            return_state=True)
    bm = BaM(d, t.lp, lp_g, device=DEV)
    regf = Regularizers().linear(10.0)
    bbatch = bm.fit_batch(seeds, regf, batch_size=b, niter=20,
                          return_state=True)
    for i, s in enumerate(seeds):
        with pytest.warns(UserWarning, match="does not take tensors"):
            one = g.fit(s, batch_size=b, niter=20, verbose=False,
                        return_state=True)
        assert torch.equal(batch.mean[i], one.mean)
        assert torch.equal(batch.cov[i], one.cov)
        bone = bm.fit(s, regf, batch_size=b, niter=20, verbose=False,
                      return_state=True)
        assert torch.equal(bbatch.mean[i], bone.mean)
        assert torch.equal(bbatch.cov[i], bone.cov)


def test_factor_fitters_refuse_host_callables():
    """FactorGSM and FactorBaM need a tensor score, as JAX's raise
    TypeError on a non-traceable one (gsmvi_tpu/gsm_factor.py:502-506,
    gsmvi_tpu/bam_factor.py:528-531)."""
    d = 5
    _, _, mean, cov = _targets(3, d, np.float32)
    lp_g = _numpy_score(mean, cov)
    with pytest.raises(TypeError, match="use GSM"):
        FactorGSM(d, None, lp_g, device=DEV).fit(0, niter=2, verbose=False)
    with pytest.raises(TypeError, match="use BaM"):
        FactorBaM(d, None, lp_g, device=DEV).fit(
            0, Regularizers().linear(1.0), niter=2, verbose=False)


def test_numpy_gsm_converges_and_prints_the_route(capsys):
    """The reference's numpy example configuration (D=5, B=8, 500 steps,
    examples/example_gsm_numpy.py) on the port's eager loop recovers the
    target, and the fit says which loop it took, as JAX's does."""
    rng = np.random.default_rng(42)
    d = 5
    mean = rng.random(d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    g = GSM(d, None, _numpy_score(mean, cov), dtype=torch.float64,
            device=DEV)
    m, c = g.fit(99, niter=500, batch_size=8, nprint=1)
    assert "eager host loop" in capsys.readouterr().out
    np.testing.assert_allclose(m.numpy(), mean, atol=1e-2)
    np.testing.assert_allclose(c.numpy(), cov, atol=0.2)


# ---------------------------------------------------------------------------
# compat.gsm_numpy
# ---------------------------------------------------------------------------

def test_numpy_compat_equals_jax_compat_bit_for_bit():
    """The port's copy of the numpy GSM against the JAX package's on the
    same int seed: the update and a 200-step fit, bit for bit."""
    rng = np.random.default_rng(0)
    d, b = 7, 5
    mean = rng.random(d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    lp_g = _numpy_score(mean, cov)
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    for got, want in zip(np_update(x, v, mean, cov),
                         j_np_update(x, v, mean, cov)):
        assert np.array_equal(got, want)
    fit = dict(key=11, niter=200, batch_size=b, verbose=False)
    for got, want in zip(NumpyGSM(d, None, lp_g).fit(**fit),
                         JNumpyGSM(d, None, lp_g).fit(**fit)):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Precision of the O(B D^2) products (plain versions)
# ---------------------------------------------------------------------------

def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return a, b


def test_bf16_rounding_equals_jax_bit_for_bit():
    """Round to nearest even on random values, exact halfway cases (ties to
    even both ways), values past bfloat16's largest finite one, subnormals,
    zeros and infinities."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(1e3)
    ties = (np.arange(1, 257, dtype=np.uint32) << 16) | np.uint32(0x8000)
    extra = np.array([3.3961e38, -3.3961e38, 1e-40, -1e-42, 0.0, -0.0,
                      np.inf, -np.inf], np.float32)
    x = np.concatenate([x, ties.view(np.float32), extra])
    got = fs.bf16_round(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("m,k,n", [(32, 256, 256), (8, 200, 200),
                                   (64, 64, 10)])
def test_high_lies_within_2_pow_16_of_float64(m, k, n):
    a, b = _operands(m + k, m, k, n)
    got = fs.mm_prec(torch.from_numpy(a), torch.from_numpy(b), "high")
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.all(np.abs(got.numpy() - exact) <= HIGH_REL * scale)
    # bf16x3 is not plain float32: it differs from it where a_lo b_lo
    # matters, and bf16 alone is far coarser.
    one = fs.mm_prec(torch.from_numpy(a), torch.from_numpy(b), "bf16")
    assert (np.abs(one.numpy() - exact).max()
            > 16 * np.abs(got.numpy() - exact).max())


@pytest.mark.parametrize("m,k,n", [(32, 256, 256), (8, 200, 200)])
def test_bf16_lies_within_its_bound_of_jax(m, k, n):
    """Against JAX's ``Precision.DEFAULT`` product, which the CPU computes
    in float32: within the bf16 operand-rounding bound."""
    a, b = _operands(3 * m + k, m, k, n)
    got = fs.mm_prec(torch.from_numpy(a), torch.from_numpy(b), "bf16")
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              precision=jax.lax.Precision.DEFAULT))
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= BF16_REL * scale + 2.0 ** -22 * scale)
    # The operands really are rounded: far from float32.
    assert err.max() > 2.0 ** -12 * scale.max()


def _update_inputs(seed, b, d):
    rng = np.random.default_rng(seed)
    l = 0.3 * rng.standard_normal((d, d))
    f = (np.eye(d) + l / np.sqrt(d)).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    x = mean + eps @ f.T
    prec = np.eye(d, dtype=np.float32) * 0.8
    vs = ((0.1 - x) @ prec).astype(np.float32)
    return eps, vs, mean, f


@pytest.mark.parametrize("precision,tol", [("high", 1e-5), ("bf16", 1e-2)])
@pytest.mark.parametrize("b,d", [(8, 64), (32, 128)])
def test_k1_plain_at_precision_against_jax_big_prec(precision, tol, b, d):
    """K1's plain version (``gsm_eps_update_ns_reference``) at ``precision``
    against JAX's ``gsm_eps_update_ns_xla(big_prec=...)``, float32 on the
    CPU (so JAX's products are float32): one update within ``tol`` x
    max(1, |F|) -- "high" at float32 rounding carried through the small
    space (measured 2.9e-6), "bf16" at 2.5 x its 2^-8 operand rounding
    carried through it (measured 2.2e-3).  Both accept; "highest" equals
    the float32 route bit for bit."""
    eps, vs, mean, f = _update_inputs(b * d, b, d)
    jprec = {"high": jax.lax.Precision.HIGH,
             "bf16": jax.lax.Precision.DEFAULT}[precision]
    mj, fj, gj = gsm_eps_update_ns_xla(
        *map(jnp.asarray, (eps, vs, mean, f)),
        iters=fs.ns_iters_for_batch(b), big_prec=jprec)
    t = tuple(map(torch.from_numpy, (eps, vs, mean, f)))
    mt, ft, gt = fs.gsm_eps_update_ns_reference(*t, precision=precision)
    assert bool(gt) and bool(gj)
    scale = max(1.0, float(np.abs(np.asarray(fj)).max()))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=tol * scale)
    m32, f32, _ = fs.gsm_eps_update_ns_reference(*t)
    m_hi, f_hi, _ = fs.gsm_eps_update_ns_reference(*t, precision="highest")
    assert torch.equal(m32, m_hi) and torch.equal(f32, f_hi)


def test_precision_reaches_only_the_big_products(monkeypatch):
    """The precision reaches ``ef``, ``vf``, ``t`` and the fat apply, and
    the small space runs in float32: with ``mm_prec`` spied on, a whole
    step at "bf16" asks for exactly those four products."""
    b, d = 4, 16
    eps, vs, mean, f = map(torch.from_numpy, _update_inputs(7, b, d))
    seen = []
    real = fs.mm_prec

    def spy(a, bb, precision="highest"):
        seen.append((tuple(a.shape), tuple(bb.shape), precision))
        return real(a, bb, precision)

    monkeypatch.setattr(fs, "mm_prec", spy)
    prec = (torch.eye(d) * 0.8, )
    score = lambda x, p: (0.1 - x) @ p
    fs.eps_step_reference(score, prec, eps, mean, f, precision="bf16")
    assert seen == [((b, d), (d, d), "bf16"), ((b, d), (d, d), "bf16"),
                    ((b, d), (d, d), "bf16"), ((d, 2 * b), (2 * b, d),
                                               "bf16")]


def test_chol_route_takes_float32_only():
    b, d = 4, 16
    with pytest.raises(ValueError, match="float32 only"):
        fs.make_fused_eps_step(fs.gaussian_score, 2, b, d, method="chol",
                               external_eps=True, precision="bf16")
    eps, vs, mean, f = map(torch.from_numpy, _update_inputs(8, b, d))
    with pytest.raises(ValueError, match="float32 only"):
        fs.gsm_eps_update_fused(eps, vs, mean, f, method="chol",
                                precision="high")
    with pytest.raises(ValueError, match="must be one of"):
        fs.thin_product(eps, f, trans=True, precision="tf32")


@pytest.mark.parametrize("precision", ["high", "bf16"])
def test_plain_products_and_apply_at_precision(precision):
    """The wrappers' plain versions: ``thin_product`` is ``mm_prec`` of
    the rows and F (or F^T, with x = mu + out), and ``factor_apply`` is F +
    mm_prec(su^T, sw) with its select, per replica."""
    b, d, k = 8, 40, 3
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.standard_normal((k, b, d)).astype(np.float32))
    f = torch.from_numpy(rng.standard_normal((k, d, d)).astype(np.float32))
    mu = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    out, x = fs.thin_product(rows, f, trans=True, mu=mu, precision=precision)
    for i in range(k):
        want = fs.mm_prec(rows[i], f[i].T, precision)
        assert torch.equal(out[i], want)
        assert torch.equal(x[i], mu[i] + want)
    su = torch.from_numpy(rng.standard_normal((k, 2 * b, d))
                          .astype(np.float32))
    sw = torch.from_numpy(rng.standard_normal((k, 2 * b, d))
                          .astype(np.float32))
    good = torch.tensor([True, False, True])
    got = fs.factor_apply(su, sw, f, good, precision=precision)
    for i in range(k):
        want = (f[i] + fs.mm_prec(su[i].T, sw[i], precision) if good[i]
                else f[i])
        assert torch.equal(got[i], want)
    # "highest" is the float32 apply (apply_f32.cu on the card); any other
    # name is refused.
    assert torch.equal(fs.factor_apply(su, sw, f, good, precision="highest"),
                       fs.factor_apply_reference(su, sw, f, good, "highest"))
    with pytest.raises(ValueError, match="must be one of"):
        fs.factor_apply(su, sw, f, precision="tf32")


def test_factor_gsm_precision_on_cpu_matches_jax_fit():
    """``FactorGSM(pallas_precision=p)`` off the card runs the plain eps
    step in float32, as JAX's does on the CPU (its "high" and "bf16" fits
    there run float32 products): on JAX's draws, each p's trajectory
    against JAX's, float64, within 1e-9."""
    d, b, niter = 8, 4, 30
    tj, tt, _, _ = _targets(6, d, np.float64)
    key = jax.random.PRNGKey(2)
    draws = _split_chain_draws(key, niter + 1, b, d, jnp.float64)
    from gsmvi_tpu import FactorGSM as JFactorGSM
    for p in ("high", "bf16"):
        sj = JFactorGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float64,
                        pallas_precision=p).fit(
            key, batch_size=b, niter=niter, verbose=False, return_state=True)
        fg = FactorGSM(d, tt.lp, tt.lp_g, dtype=torch.float64,
                       pallas_precision=p, device=DEV)
        _feed(fg, draws)
        st = fg.fit(0, batch_size=b, niter=niter, verbose=False,
                    return_state=True)
        assert int(st.n_accepted) == int(sj.n_accepted)
        np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(st.factor.numpy(), np.asarray(sj.factor),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("precision", ["high", "bf16"])
def test_factor_gsm_kernel_paths_run_the_precision(monkeypatch, precision):
    """On the kernel paths (their plain versions on the CPU) the fitter
    hands ``pallas_precision`` to K1 ("update" mode), K2 ("step" mode) and
    K6 (``fit_batch`` "fused"): each fit equals the plain versions driven
    at that precision by hand, and K6's replica 0 equals the K2 fit."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    d, b, niter = 16, 4, 23
    t = dense_gaussian(8, d, scale=0.3, device=DEV)
    kw = dict(batch_size=b, niter=niter, verbose=False, return_state=True)
    fg = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                   pallas_precision=precision, device=DEV)
    st = fg.fit(3, **kw)
    score_fn, params = t.fused_score
    mean, f = torch.zeros(d), torch.eye(d)
    for s in range(niter + 1):
        mean, f, _ = fs.eps_step_reference(score_fn, params,
                                           fg._eps(3, s, b, d), mean, f,
                                           precision=precision)
    assert torch.equal(st.mean, mean) and torch.equal(st.factor, f)
    hi = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                   device=DEV).fit(3, **kw)
    assert not torch.equal(st.factor, hi.factor)
    batch = fg.fit_batch((3, 4), batch_size=b, niter=niter,
                         return_state=True, small_solver="fused")
    assert torch.equal(batch.mean[0], st.mean)
    assert torch.equal(batch.factor[0], st.factor)
    upd = FactorGSM(d, t.lp, t.lp_g, pallas_precision=precision, device=DEV)
    su = upd.fit(3, **kw)
    mean, f = torch.zeros(d), torch.eye(d)
    for s in range(niter + 1):
        e = upd._eps(3, s, b, d)
        ef = e @ f.T
        v = t.lp_g(mean + ef)
        mean, f, _ = fs.gsm_eps_update_ns_reference(e, v, mean, f, ef_t=ef,
                                                    precision=precision)
    assert torch.equal(su.mean, mean) and torch.equal(su.factor, f)


def test_factor_gsm_high_fit_converges_on_cpu(monkeypatch):
    """A "high" fit on the K2 path (plain versions on the CPU) converges to
    the moments of the float32 fit: within 1e-3 of them at D=16."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    d, b = 16, 8
    t = dense_gaussian(9, d, scale=0.3, device=DEV)
    kw = dict(batch_size=b, niter=400, verbose=False)
    m_hi, c_hi = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                           pallas_precision="high", device=DEV).fit(0, **kw)
    m32, c32 = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                         device=DEV).fit(0, **kw)
    assert torch.allclose(m_hi, m32, atol=1e-3)
    assert torch.allclose(c_hi, c32, atol=1e-3 * float(c32.abs().max()))


# ---------------------------------------------------------------------------
# The tensor-core variants' launches, on a stand-in library
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))

    def size(self, name, *args):
        return 16

    def named(self, name):
        return [args for n, args in self.calls if n == name]


@pytest.fixture
def card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _rows(*shape):
    return torch.zeros(shape, dtype=torch.float32)


@pytest.mark.parametrize("precision,mode,tag", [("bf16", 1, "bf16"),
                                                ("high", 2, "bf16x3")])
@pytest.mark.parametrize("k", [None, 3])
def test_k1_at_precision_launches_the_tensor_core_variants(card, precision,
                                                           mode, tag, k):
    """K1 at "bf16"/"high": its three row products on ``thin_mma.cu`` and
    the fat apply on ``apply_mma.cu`` at the precision's mode, with the
    float32 kernels' partition (``thin_split``); the small space is the
    float32 one.  Counted in the variants' counters only."""
    b, d = 32, 256
    lead = () if k is None else (k,)
    fs.gsm_eps_update_fused(_rows(*lead, b, d), _rows(*lead, b, d),
                            _rows(*lead, d), _rows(*lead, d, d),
                            precision=precision)
    names = [n for n, _ in card.calls]
    assert names == ["gsmvi_thin_rows_mma"] * 3 + [
        "gsmvi_eps_smallspace_cluster", "gsmvi_factor_apply_mma"]
    for args in card.named("gsmvi_thin_rows_mma"):
        assert args[8] == (k or 1) and args[10:13] == (*fs.thin_split(d),
                                                       mode)
    (apply,) = card.named("gsmvi_factor_apply_mma")
    assert apply[5:9] == (2 * b, d, k or 1, mode)
    counts = fs.launch_counts()
    assert counts[f"thin_product_{tag}"] == 3
    assert counts[f"factor_apply_{tag}"] == 1
    assert counts["thin_product"] == 0 and counts["gsm_eps_update_fused"] == 1


@pytest.mark.parametrize("precision", ["bf16", "high"])
def test_k2_k4_k6_at_precision_launch_the_variants(card, precision):
    """A whole step at "bf16"/"high" (K4, each K2 and K6 sub-step): ef with
    x = mu + ef on the tensor-core thin product, K3 in float32, vf and t
    on the tensor-core thin product, the float32 small space, the
    tensor-core fat apply."""
    b, d, spc, k = 32, 256, 8, 3
    params = (_rows(1, d), _rows(d, d))
    sub_step = ["gsmvi_thin_rows_mma", "gsmvi_thin_score",
                "gsmvi_thin_rows_mma", "gsmvi_thin_rows_mma",
                "gsmvi_eps_smallspace_cluster", "gsmvi_factor_apply_mma"]
    step = fs.make_fused_eps_step(fs.gaussian_score, 2, b, d,
                                  external_eps=True, precision=precision)
    step(_rows(b, d), _rows(d), _rows(d, d), *params)
    assert [n for n, _ in card.calls] == sub_step
    card.calls.clear()
    multi = fs.make_fused_eps_multistep(fs.gaussian_score, 2, b, d, spc,
                                        precision=precision)
    multi(2, _rows(spc * b, d), _rows(d), _rows(d, d), *params)
    assert [n for n, _ in card.calls] == sub_step * 2
    card.calls.clear()
    batch = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d, k,
                                               spc, precision=precision)
    batch(2, _rows(k, spc * b, d), _rows(k, d), _rows(k, d, d), *params)
    assert [n for n, _ in card.calls] == sub_step * 2
    assert all(a[8] == k for a in card.named("gsmvi_thin_rows_mma"))
    # The x = mu + ef launch carries mu and x_out; vf and t do not.
    ef = card.named("gsmvi_thin_rows_mma")[0]
    assert ef[2].value is not None and ef[4].value is not None
    assert ef[7] == 1


def test_highest_launches_are_unchanged(card):
    """"highest" keeps the float32 kernels: no tensor-core launch."""
    b, d = 8, 64
    fs.gsm_eps_update_fused(_rows(b, d), _rows(b, d), _rows(d), _rows(d, d),
                            precision="highest")
    assert [n for n, _ in card.calls] == ["gsmvi_thin_rows"] * 3 + [
        "gsmvi_eps_smallspace_cluster", "gsmvi_factor_apply"]
    counts = fs.launch_counts()
    assert all(counts[n] == 0 for n in counts if n.endswith(("bf16",
                                                             "bf16x3")))
