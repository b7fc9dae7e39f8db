"""The port's public surface around the fits against the JAX package on
identical numpy-made inputs: ``mvn_entropy``/``mvn_kl``/``Gaussian``
(``distributions.py``), ``Posterior``, ``KLMonitor`` and its estimators,
``lbfgs_init``/``map_init``, checkpoints, the profiling helpers and the
package's exported names.

Tolerances: float64 on both sides within 1e-10 (relative to max(1, |x|));
float32 within 1e-5 relative; ``lbfgs_init``'s MAP within 1e-4 of JAX's
(both optimizers stop at their own tolerance on their own rounding);
``map_init`` within 1e-5 of JAX's after its Adam steps (optax's update is
the port's ``Adam``'s, float32 both sides).  Resumed fits equal the
uninterrupted ones bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu
import gsmvi_tpu.distributions as jd
import gsmvi_tpu_torch
import gsmvi_tpu_torch.bam_factor as t_bf
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.posterior import Posterior as JPosterior
from gsmvi_tpu.state import VIState as JVIState
from gsmvi_tpu.utils import initializers as jinit
from gsmvi_tpu.utils import monitors as jmon
from gsmvi_tpu_torch import (GSM, FactorBaM, FactorGSM, Gaussian, KLMonitor,
                             Posterior, Regularizers, lbfgs_init,
                             load_state, map_init, mvn_kl, save_state)
from gsmvi_tpu_torch.distributions import mvn_entropy, mvn_logpdf
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays
from gsmvi_tpu_torch.state import FactorVIState, VIState, replica
from gsmvi_tpu_torch.utils import (fit_throughput, forward_kl, reverse_kl,
                                   time_fn, trace)
from gsmvi_tpu_torch.utils.monitors import sample_and_logq

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"
TOL = {np.float64: 1e-10, np.float32: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype, what=""):
    got = (got.detach().cpu().numpy() if torch.is_tensor(got)
           else np.asarray(got))
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=0,
                               atol=TOL[dtype] * scale, err_msg=what)


def _gaussians(seed, d, dtype):
    """Two SPD Gaussians (mean, cov, chol) and points x, numpy ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = rng.standard_normal((d, d))
        cov = a @ a.T / d + np.eye(d)
        out.append((rng.standard_normal(d), cov, np.linalg.cholesky(cov)))
    x = rng.standard_normal((5, d))
    cast = lambda z: np.asarray(z, dtype)
    return [tuple(cast(z) for z in g) for g in out], cast(x)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# distributions: mvn_entropy, mvn_kl, Gaussian
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d", [1, 3, 16])
def test_mvn_entropy_and_kl_match_jax(dtype, d):
    ((m0, c0, l0), (m1, c1, l1)), _ = _gaussians(d, d, dtype)
    _close(mvn_entropy(*_t(l0)), jd.mvn_entropy(jnp.asarray(l0)), dtype)
    for a, b in (((m0, l0), (m1, l1)), ((m1, l1), (m0, l0)),
                 ((m0, l0), (m0, l0))):
        _close(mvn_kl(*_t(*a, *b)), jd.mvn_kl(*map(jnp.asarray, (*a, *b))),
               dtype, "kl")
    # KL of a distribution to itself is 0; against float64 numpy otherwise.
    assert abs(float(mvn_kl(*_t(m0, l0, m0, l0)))) <= TOL[dtype] * d
    s1i = np.linalg.inv(c1.astype(np.float64))
    diff = (m1 - m0).astype(np.float64)
    want = 0.5 * (np.trace(s1i @ c0) + diff @ s1i @ diff - d
                  + np.linalg.slogdet(c1.astype(np.float64))[1]
                  - np.linalg.slogdet(c0.astype(np.float64))[1])
    _close(mvn_kl(*_t(m0, l0, m1, l1)), want, dtype, "kl vs numpy")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", ["cov", "scale_tril", "identity"])
def test_gaussian_matches_jax(dtype, form):
    d = 6
    ((m, c, l), _), x = _gaussians(7, d, dtype)
    kw = {"cov": {"cov": c}, "scale_tril": {"scale_tril": l},
          "identity": {}}[form]
    g = Gaussian(torch.from_numpy(m), **{k: torch.from_numpy(v)
                                        for k, v in kw.items()})
    jg = jd.Gaussian(jnp.asarray(m), **{k: jnp.asarray(v)
                                       for k, v in kw.items()})
    _close(g.covariance_matrix, jg.covariance_matrix, dtype, "cov")
    _close(g.scale_tril, jg.scale_tril, dtype, "scale_tril")
    _close(g.log_prob(torch.from_numpy(x)), jg.log_prob(jnp.asarray(x)),
           dtype, "log_prob")
    _close(g.log_prob(torch.from_numpy(x[0])), jg.log_prob(jnp.asarray(x[0])),
           dtype, "log_prob of one point")


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_gaussian_sample_shapes_and_draws(shape):
    """Draws of ``sample_shape + (D,)`` (JAX's shapes), each loc + eps L^T
    on the draws of the seeded generator; a generator is taken as is."""
    d = 5
    ((m, c, l), _), _ = _gaussians(3, d, np.float64)
    g = Gaussian(*_t(m), scale_tril=torch.from_numpy(l))
    jshape = jd.Gaussian(jnp.asarray(m), scale_tril=jnp.asarray(l)).sample(
        jax.random.PRNGKey(0), shape).shape
    got = g.sample(11, shape)
    assert tuple(got.shape) == tuple(jshape) == (*shape, d)
    n = int(np.prod(shape)) if shape else 1
    eps = torch.randn((n, d), generator=torch.Generator().manual_seed(11),
                      dtype=torch.float64)
    want = (torch.from_numpy(m) + eps @ torch.from_numpy(l).T)
    assert torch.equal(got.reshape(n, d), want)
    gen = torch.Generator().manual_seed(11)
    assert torch.equal(g.sample(gen, shape), got)


def test_gaussian_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Gaussian(np.zeros(3))
    assert Gaussian(np.zeros(3), device="cpu").loc.device.type == "cpu"


# ---------------------------------------------------------------------------
# Posterior
# ---------------------------------------------------------------------------

@pytest.fixture
def posteriors():
    d = 7
    ((m, c, l), (m1, c1, l1)), x = _gaussians(21, d, np.float64)
    return ((Posterior.from_fit(*_t(m, c)), Posterior(*_t(m1, l1))),
            (JPosterior.from_fit(jnp.asarray(m), jnp.asarray(c)),
             JPosterior(jnp.asarray(m1), jnp.asarray(l1))), x)


def test_posterior_methods_match_jax(posteriors):
    (p, q), (jp, jq), x = posteriors
    dt = np.float64
    assert p.d == jp.d == 7
    _close(p.chol, jp.chol, dt, "chol")
    _close(p.cov, jp.cov, dt, "cov")
    _close(p.log_prob(x), jp.log_prob(jnp.asarray(x)), dt, "log_prob")
    _close(p.entropy(), jp.entropy(), dt, "entropy")
    _close(p.kl_to(q), jp.kl_to(jq), dt, "kl_to")
    _close(q.kl_to(p), jq.kl_to(jp), dt, "kl_to reversed")
    for idx in (None, [0, 3, 6], 2):
        for got, want in zip(p.marginal(idx), jp.marginal(idx)):
            _close(got, want, dt, f"marginal {idx}")


def test_posterior_sample(posteriors):
    (p, _), (jp, _), _ = posteriors
    xs = p.sample(5, 2000)
    assert tuple(xs.shape) == tuple(jp.sample(jax.random.PRNGKey(0),
                                              2000).shape) == (2000, 7)
    eps = torch.randn((2000, 7), generator=torch.Generator().manual_seed(5),
                      dtype=torch.float64)
    assert torch.equal(xs, p.mean + eps @ p.chol.T)
    # The draws' moments approach the posterior's (3 sigma of 2000 draws).
    err = (xs.mean(0) - p.mean).abs().max() / p.marginal()[1].max()
    assert float(err) < 3.0 / np.sqrt(2000) * 2


@pytest.mark.parametrize("kind", ["vistate", "factor"])
def test_posterior_from_state_matches_jax(kind):
    d = 5
    ((m, c, l), _), x = _gaussians(4, d, np.float64)
    zero = torch.zeros((), dtype=torch.int32)
    if kind == "vistate":
        st = VIState(*_t(m, c, l), 0, 0, zero, zero)
        jst = JVIState(*map(jnp.asarray, (m, c, l)), jax.random.PRNGKey(0),
                       0, 0, 0)
    else:
        f = l @ np.linalg.qr(np.random.default_rng(0).standard_normal(
            (d, d)))[0]               # another factor of the same cov
        st = FactorVIState(*_t(m, f), 0, 0, zero, zero)
        from gsmvi_tpu.gsm_factor import FactorVIState as JFactorVIState

        jst = JFactorVIState(jnp.asarray(m), jnp.asarray(f),
                             jnp.zeros((0, 0)), jax.random.PRNGKey(0), 0, 0,
                             0)
    p, jp = Posterior.from_state(st), JPosterior.from_state(jst)
    _close(p.chol, jp.chol, np.float64, "chol")
    _close(p.log_prob(x), jp.log_prob(jnp.asarray(x)), np.float64)


@pytest.mark.parametrize("suffix", ["", ".npz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_posterior_files_load_in_the_other_package(tmp_path, posteriors,
                                                   writer, suffix):
    (p, _), (jp, _), _ = posteriors
    path = str(tmp_path / ("post" + suffix))
    if writer == "port":
        p.save(path)
        back_t = Posterior.load(path, device=DEV)
        back_j = JPosterior.load(path)
    else:
        jp.save(path)
        back_j = JPosterior.load(path)
        back_t = Posterior.load(path, device=DEV)
    assert os.path.exists(str(tmp_path / "post.npz"))
    want_m = (p.mean.numpy() if writer == "port" else np.asarray(jp.mean))
    want_l = (p.chol.numpy() if writer == "port" else np.asarray(jp.chol))
    for mean, chol in ((back_t.mean.numpy(), back_t.chol.numpy()),
                       (np.asarray(back_j.mean), np.asarray(back_j.chol))):
        assert np.array_equal(mean, want_m) and np.array_equal(chol, want_l)
    assert back_t.mean.device.type == "cpu"


def test_posterior_load_prefers_the_npz(tmp_path, posteriors):
    """An extensionless file of the same name is not read when ``save``'s
    ``.npz`` exists (the JAX package's rule)."""
    (p, _), _, _ = posteriors
    (tmp_path / "post").write_text("not an npz")
    p.save(str(tmp_path / "post"))
    assert torch.equal(Posterior.load(str(tmp_path / "post"),
                                      device=DEV).chol, p.chol)


# ---------------------------------------------------------------------------
# KLMonitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sample_and_logq_matches_jax_on_its_draws(dtype):
    d, n = 6, 32
    ((m, c, l), _), _ = _gaussians(8, d, dtype)
    key = jax.random.PRNGKey(3)
    qs_j, logq_j = jmon.KLMonitor._sample_and_logq(
        jnp.asarray(m), jnp.asarray(l), key, n)
    eps = np.asarray(jax.random.normal(key, (n, d), jnp.asarray(m).dtype))
    qs_t, logq_t = sample_and_logq(*_t(m, l, eps))
    _close(qs_t, qs_j, dtype, "q-samples")
    np.testing.assert_allclose(float(logq_t), float(logq_j),
                               rtol=TOL[dtype], atol=0)


@pytest.mark.parametrize("which", ["reverse", "forward"])
def test_kl_estimators_match_jax(which):
    d = 4
    ((m, c, l), (m1, c1, l1)), _ = _gaussians(2, d, np.float64)
    x = np.random.default_rng(1).standard_normal((50, d))
    lpq_t = lambda z: mvn_logpdf(torch.as_tensor(z), *_t(m, l))
    lpp_t = lambda z: mvn_logpdf(torch.as_tensor(z), *_t(m1, l1))
    lpq_j = lambda z: jd.mvn_logpdf(jnp.asarray(z), jnp.asarray(m),
                                    jnp.asarray(l))
    lpp_j = lambda z: jd.mvn_logpdf(jnp.asarray(z), jnp.asarray(m1),
                                    jnp.asarray(l1))
    fn_t, fn_j = ((reverse_kl, jmon.reverse_kl) if which == "reverse"
                  else (forward_kl, jmon.forward_kl))
    np.testing.assert_allclose(fn_t(torch.from_numpy(x), lpq_t, lpp_t),
                               fn_j(x, lpq_j, lpp_j), rtol=1e-10)


def _targets(d=8, seed=11):
    """The port's ``dense_gaussian`` and the JAX target on its arrays."""
    t = dense_gaussian(seed, d, device=DEV)
    jt = _gaussian_target(jnp.asarray(t.mean.numpy()),
                          jnp.asarray(t.cov.numpy()), "dense")
    return t, jt


@pytest.mark.parametrize("niter,checkpoint,batch", [(20, 10, 4), (45, 7, 2),
                                                    (3, 5, 1)])
def test_monitor_cadence_and_nevals_match_jax(niter, checkpoint, batch):
    """One (rkl, fkl, nevals) entry per checkpoint and one after the loop,
    nevals the cumulative score evaluations from ``offset_evals``, as the
    JAX monitor records over a fit of the same niter and batch."""
    t, jt = _targets()
    mon = KLMonitor(batch_size_kl=8, checkpoint=checkpoint, offset_evals=100)
    GSM(t.d, t.lp, t.lp_g, device=DEV).fit(
        2, niter=niter, batch_size=batch, verbose=False, monitor=mon)
    jm = gsmvi_tpu.KLMonitor(batch_size_kl=8, checkpoint=checkpoint,
                             offset_evals=100)
    gsmvi_tpu.GSM(D=t.d, lp=jt.lp, lp_g=jt.lp_g).fit(
        jax.random.PRNGKey(2), niter=niter, batch_size=batch, verbose=False,
        monitor=jm)
    assert mon.nevals == jm.nevals
    assert len(mon.rkl) == len(mon.fkl) == len(jm.rkl) == len(jm.fkl) \
        == niter // checkpoint + 2
    assert np.isfinite(mon.rkl).all() and np.isnan(mon.fkl).all()
    assert mon.offset_evals == mon.nevals[-1]


def test_monitor_rkl_falls_and_tracks_forward_kl():
    t, _ = _targets()
    ref = t.mean + torch.randn((500, t.d), generator=torch.Generator()
                               .manual_seed(0)) @ torch.linalg.cholesky(
                                   t.cov).T
    mon = KLMonitor(batch_size_kl=64, checkpoint=50, ref_samples=ref.numpy(),
                    store_params=True)
    GSM(t.d, t.lp, t.lp_g, device=DEV).fit(2, niter=400, batch_size=8,
                                            verbose=False, monitor=mon)
    assert len(mon.rkl) == len(mon.fkl) == len(mon.params_trace) == 10
    assert mon.rkl[-1] < mon.rkl[0] and mon.rkl[-1] < 0.05
    assert np.isfinite(mon.fkl).all() and mon.fkl[-1] < mon.fkl[0]
    m, c = mon.params_trace[-1]
    assert m.shape == (t.d,) and c.shape == (t.d, t.d)


def test_monitor_estimates_equal_jax_on_the_same_draws(monkeypatch):
    """rkl and fkl of one call against the JAX monitor's formulas on the
    port's own q-draws and p-subset (float64)."""
    t, jt = _targets(6)
    ((m, c, l), _), _ = _gaussians(9, 6, np.float64)
    ref = np.random.default_rng(4).standard_normal((40, 6))
    mon = KLMonitor(batch_size_kl=16, ref_samples=ref)
    seen = []
    lp = lambda z: (seen.append(z.clone()), t.lp(z.float()).double())[1]
    mon(0, list(_t(m, c)), lp, 77)
    qs, ps = (s.numpy() for s in seen)
    lpq = lambda z: jd.mvn_logpdf(jnp.asarray(z), jnp.asarray(m),
                                  jnp.asarray(np.linalg.cholesky(c)))
    lpp = lambda z: np.asarray(jt.lp(jnp.asarray(z, jnp.float32)),
                               np.float64) * np.ones(len(z)) / len(z)
    # jt.lp sums over the batch; reverse_kl sums lpp over the rows.
    np.testing.assert_allclose(mon.rkl[0], jmon.reverse_kl(qs, lpq, lpp),
                               rtol=1e-5)
    np.testing.assert_allclose(mon.fkl[0], jmon.forward_kl(ps, lpq, lpp),
                               rtol=1e-5)
    assert ps.shape == (16, 6)
    assert any(np.array_equal(ps[0], r) for r in ref)


@pytest.mark.parametrize("fault", ["not_pd", "lp_raises_on_p_samples"])
def test_monitor_failure_appends_one_nan_entry(fault, capsys):
    """NaN on failure, exactly one entry per call in rkl, fkl and nevals,
    as the JAX monitor (which fixes the reference's double append)."""
    t, jt = _targets(4)
    ref = np.random.default_rng(0).standard_normal((10, 4))
    mean, cov = np.zeros(4), np.eye(4)
    if fault == "not_pd":
        cov = -np.eye(4)
    calls = []

    def lp(z, lp0):
        calls.append(1)
        if fault == "lp_raises_on_p_samples" and len(calls) % 2 == 0:
            raise ValueError("no")
        return lp0(z)

    mon = KLMonitor(batch_size_kl=4, ref_samples=ref)
    jm = gsmvi_tpu.KLMonitor(batch_size_kl=4, ref_samples=ref)
    for i in range(2):
        mon(i, list(_t(mean, cov)), lambda z: lp(z, lambda x: t.lp(
            x.float())), 5, nevals=3)
    calls.clear()
    for i in range(2):
        jm(i, [jnp.asarray(mean), jnp.asarray(cov)],
           lambda z: lp(z, lambda x: jt.lp(jnp.asarray(x, jnp.float32))),
           jax.random.PRNGKey(5), nevals=3)
    assert len(mon.rkl) == len(mon.fkl) == len(mon.nevals) == 2
    assert len(jm.rkl) == len(jm.fkl) == len(jm.nevals) == 2
    assert mon.nevals == jm.nevals == [3, 6]
    # A failure after rkl was appended (lp raising on the p-samples) takes
    # that rkl back: the call's whole entry is NaN.
    for m in (mon, jm):
        assert np.isnan(m.fkl).all() and np.isnan(m.rkl).all()
    assert "Appending NaN" in capsys.readouterr().out


def test_monitor_reset():
    mon = KLMonitor(batch_size_kl=4, checkpoint=3)
    mon.rkl.append(1.0)
    mon.reset(batch_size_kl=9, checkpoint=5, offset_evals=7)
    assert (mon.rkl, mon.fkl, mon.nevals) == ([], [], [])
    assert (mon.batch_size_kl, mon.checkpoint, mon.offset_evals) == (9, 5, 7)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _targets64(d, seed):
    """The float64 port target and the JAX target on the same arrays (the
    suite runs JAX with x64 on, so JAX's L-BFGS evaluates in float64)."""
    t32, _ = _targets(d, seed)
    t = gaussian_target_from_arrays(t32.mean.double().numpy(),
                                    t32.cov.double().numpy(), device=DEV)
    return t, _gaussian_target(jnp.asarray(t.mean.numpy()),
                               jnp.asarray(t.cov.numpy()), "dense")


@pytest.mark.parametrize("with_grad", [True, False])
def test_lbfgs_init_matches_jax(with_grad):
    t, jt = _targets64(8, 3)
    mean, cov, res = lbfgs_init(np.ones(8), t.lp,
                                t.lp_g if with_grad else None, device=DEV,
                                dtype=torch.float64)
    jmean, jcov, jres = jinit.lbfgs_init(np.ones(8), jt.lp,
                                         jt.lp_g if with_grad else None)
    assert res.success and jres.success and res.nfev > 0
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mean, t.mean.numpy(), rtol=0, atol=1e-3)
    assert mean.dtype == np.float64 and cov.shape == (8, 8)
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)
    assert np.linalg.eigvalsh(cov).min() > 0


def test_lbfgs_init_on_a_float32_target():
    """The default evaluates in torch's default dtype, the float32 of the
    port's targets: L-BFGS then stops on float32's resolution of -lp, short
    of the float64 MAP, with an SPD inverse-Hessian estimate."""
    t, _ = _targets(8, 3)
    mean, cov, res = lbfgs_init(np.ones(8), t.lp, t.lp_g, device=DEV)
    assert res.success and np.isfinite(cov).all()
    assert np.linalg.eigvalsh(0.5 * (cov + cov.T)).min() > 0
    err = np.abs(mean - t.mean.numpy()).max()
    assert err < 0.1 * np.abs(np.ones(8) - t.mean.numpy()).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_map_init_matches_jax_optax(dtype):
    t, jt = _targets(6, 5)
    x0 = np.full(6, 0.5, dtype)
    td = torch.float64 if dtype == np.float64 else torch.float32
    if dtype == np.float64:
        t = gaussian_target_from_arrays(t.mean.double().numpy(),
                                        t.cov.double().numpy(), device=DEV)
        jt = _gaussian_target(jnp.asarray(t.mean.numpy()),
                              jnp.asarray(t.cov.numpy()), "dense")
    x, cov, n = map_init(0, t.lp, 6, x0=x0, lr=1e-2, niter=300,
                         cov_scale=2.0, device=DEV, dtype=td)
    jx, jcov, jn = jinit.map_init(jax.random.PRNGKey(0), jt.lp, 6,
                                  x0=jnp.asarray(x0), lr=1e-2, niter=300,
                                  cov_scale=2.0)
    assert n == jn == 300 and x.dtype == td
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    assert torch.equal(cov, 2.0 * torch.eye(6, dtype=td))
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _equal(a, b):
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("kind", ["vistate", "factor", "factor_stacked",
                                  "vistate_stacked"])
def test_checkpoint_round_trips(tmp_path, kind):
    rng = np.random.default_rng(0)
    k = 3 if kind.endswith("stacked") else None
    lead = () if k is None else (k,)
    t = lambda *s: torch.from_numpy(rng.standard_normal((*lead, *s))
                                    .astype(np.float32))
    cnt = lambda v: torch.full(lead, v, dtype=torch.int32)
    seed = 2 ** 40 + 3 if k is None else (1, 2 ** 40, 5)
    if kind.startswith("factor"):
        stats = (1.5, float("inf")) if k is None else (
            (1.5, float("inf")), (2.0, 3.0), (float("inf"),) * 2)
        st = FactorVIState(t(4), t(4, 4), seed, 17, cnt(15), cnt(2), stats)
    else:
        st = VIState(t(4), t(4, 4), t(4, 4), seed, 17, cnt(15), cnt(2))
    save_state(str(tmp_path / "sub" / "ckpt"), st)
    back = load_state(str(tmp_path / "sub" / "ckpt"), device=DEV)
    assert type(back) is type(st)
    _equal(back, st)
    back = load_state(str(tmp_path / "sub" / "ckpt.npz"), device=DEV)
    _equal(back, st)
    with np.load(str(tmp_path / "sub" / "ckpt.npz")) as z:
        names = set(z.files)
    jax_fields = (("mean", "factor", "step", "n_accepted", "n_rejected",
                   "ns_stats") if kind.startswith("factor")
                  else ("mean", "cov", "chol", "step", "n_accepted",
                        "n_rejected"))
    assert set(jax_fields) | {"seed"} <= names


def _fit_factor_gsm(**kw):
    t, _ = _targets(8, 7)
    return FactorGSM(8, t.lp, t.lp_g, device=DEV).fit(
        3, batch_size=4, verbose=False, return_state=True, **kw)


def _fit_gsm(**kw):
    t, _ = _targets(8, 7)
    return GSM(8, t.lp, t.lp_g, device=DEV).fit(
        3, batch_size=4, verbose=False, return_state=True, **kw)


def _fit_factor_bam(**kw):
    t, _ = _targets(8, 7)
    return FactorBaM(8, t.lp, t.lp_g, device=DEV).fit(
        3, Regularizers().linear(50.0), batch_size=4, verbose=False,
        return_state=True, **kw)


@pytest.mark.parametrize("fit,kernel", [(_fit_factor_gsm, False),
                                        (_fit_gsm, False),
                                        (_fit_factor_bam, False),
                                        (_fit_factor_bam, True)])
def test_resumed_fit_equals_uninterrupted(tmp_path, monkeypatch, fit,
                                          kernel):
    """A fit saved at step 70 and resumed through ``fit(..., state=...)``
    ends where the uninterrupted 150-step fit ends, bit for bit; with
    ``kernel`` FactorBaM runs K7's plain version with its NS tiers and
    carried statistics (its ``on_gpu`` monkeypatched)."""
    if kernel:
        monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)
    whole = fit(niter=149)
    half = fit(niter=69)
    assert half.step == 70
    save_state(str(tmp_path / "s"), half)
    done = fit(niter=79, state=load_state(str(tmp_path / "s"), device=DEV))
    assert done.step == whole.step == 150
    _equal(done, whole)
    if kernel:
        assert whole.ns_stats != (float("inf"), float("inf"))


# ---------------------------------------------------------------------------
# Profiling helpers
# ---------------------------------------------------------------------------

def test_time_fn_and_fit_throughput():
    calls = []
    assert time_fn(lambda a, b=0: calls.append((a, b)), 1, b=2, warmup=2,
                   iters=3) >= 0.0
    assert calls == [(1, 2)] * 5
    out = fit_throughput(lambda: calls.append(0), niter=9, batch_size=4)
    assert set(out) == {"seconds", "iters_per_s", "score_evals_per_s"}
    assert out["score_evals_per_s"] == pytest.approx(4 * out["iters_per_s"])
    assert len(calls) == 7


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "logs")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "logs" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# The package's names
# ---------------------------------------------------------------------------

def test_exports_cover_the_jax_package():
    assert set(gsmvi_tpu.__all__) <= set(gsmvi_tpu_torch.__all__)
    for name in gsmvi_tpu_torch.__all__:
        assert getattr(gsmvi_tpu_torch, name) is not None, name


def test_stacked_factor_state_keeps_each_replicas_stats():
    zero = torch.zeros(2, dtype=torch.int32)
    st = FactorVIState(torch.zeros(2, 3), torch.zeros(2, 3, 3), (1, 2), 0,
                       zero, zero, ((1.0, 2.0), (3.0, 4.0)))
    assert replica(st, 1).ns_stats == (3.0, 4.0)
    assert replica(st, 0).seed == 1
