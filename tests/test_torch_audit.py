"""The run-time audits of the port (``gsmvi_tpu_torch/utils/audit.py``,
``FactorGSM``/``FactorBaM`` ``audit_every``) and ``FactorGSM`` at
``steps_per_call=1`` on K4, against the JAX package.

The kernel paths run on the CPU by monkeypatching the port's ``on_gpu``
(the wrappers then run their plain versions); the JAX side runs as
``tests/test_audit.py`` runs it (``on_tpu`` monkeypatched, Pallas in
interpret mode).  Ports of every case of ``tests/test_audit.py`` at D=16,
the low end of the kernels' range.  Audit proposals are compared with
JAX's on JAX's own ``_audit_key`` draw within 1e-4 on the mean and
2e-4 * max|S| on S = F F^T (the whole-step bound of
``tests/test_torch_eps_step.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.bam_factor as j_bf
import gsmvi_tpu.gsm_factor as j_gf
import gsmvi_tpu_torch.bam_factor as t_bf
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu import FactorBaM as JFactorBaM
from gsmvi_tpu import FactorGSM as JFactorGSM
from gsmvi_tpu import Regularizers as JRegularizers
from gsmvi_tpu.gsm_factor import FactorVIState as JFactorVIState
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu.ops.bam_eps import bam_eps_update as j_bam_eps_update
from gsmvi_tpu.ops.gsm_eps import apply_eps_step as j_apply_eps_step
from gsmvi_tpu.ops.pallas import fused_step as jfs
from gsmvi_tpu.utils import audit as jaudit
from gsmvi_tpu_torch import FactorBaM, FactorGSM, Regularizers
from gsmvi_tpu_torch.driver import (audit_seed, monitor_seed, retry_seed,
                                    step_seed)
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays
from gsmvi_tpu_torch.ops.fused_step import NS_ITERS_DEFAULT
from gsmvi_tpu_torch.state import factor_state_from_numpy
from gsmvi_tpu_torch.utils.audit import make_bam_audit, make_gsm_audit

DEV = "cpu"
MEAN_TOL, COV_TOL = 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """The port's factor fitters take their kernel paths on the CPU."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)


def _target(d=16):
    return dense_gaussian(7, d, scale=0.3, device=DEV)


def _gsm(t, d, mode, **kw):
    return FactorGSM(d, t.lp, t.lp_g, device=DEV,
                     fused_score=t.fused_score if mode == "step" else None,
                     **kw)


def _audit_warnings(rec):
    return [w for w in rec if "fused-step audit" in str(w.message)]


def test_audit_seed_disjoint_from_the_other_streams():
    """The audit draws share no generator seed with the per-step, monitor
    or retry draws of any seed (the disjointness that keeps an audit from
    perturbing a fit), and differ per iteration and per seed."""
    seeds, idx = range(4), range(512)
    audit = {audit_seed(s, i) for s in seeds for i in idx}
    others = ({step_seed(s, i) for s in seeds for i in idx}
              | {monitor_seed(s, i) for s in seeds for i in idx}
              | {step_seed(retry_seed(s, i), a) for s in seeds for i in idx
                 for a in (1, 2, 3)})
    assert len(audit) == len(seeds) * len(idx)
    assert not audit & others
    assert all(0 <= x < 2 ** 63 for x in audit)


@pytest.mark.parametrize("mode", ["update", "step"])
def test_factorgsm_audit_benign(mode, kernel_paths, recwarn):
    """With the shipped ns_iters the fused update matches the exact eps
    step at every audited state: records land in audit_log, no warning
    fires, and the trajectory equals an unaudited fit's bit for bit."""
    d = 16
    t = _target(d)
    g = _gsm(t, d, mode, steps_per_call=4)
    assert g._fused_mode(8) == mode
    state = g.fit(0, niter=300, batch_size=8, verbose=False,
                  return_state=True, audit_every=100)
    assert [r["i"] for r in g.audit_log] == [100, 200, 300]
    assert all(r["valid"] for r in g.audit_log)
    assert max(max(r["mean_err"], r["cov_err"]) for r in g.audit_log) < 1e-4
    assert not _audit_warnings(recwarn)
    plain = _gsm(t, d, mode, steps_per_call=4).fit(
        0, niter=300, batch_size=8, verbose=False, return_state=True)
    assert torch.equal(state.mean, plain.mean)
    assert torch.equal(state.factor, plain.factor)
    assert int(state.n_accepted) == int(plain.n_accepted)


@pytest.mark.parametrize("mode", ["update", "step"])
def test_factorgsm_audit_catches_truncated_ns(mode, kernel_paths):
    """iters[2] trimmed below the shipped profile — the documented silent
    bias, gates green and moments off — trips the warning, and its audited
    errors sit over 10x those of the shipped profile."""
    d = 16
    t = _target(d)
    good = _gsm(t, d, mode, steps_per_call=4)
    good.fit(0, niter=200, batch_size=8, verbose=False, audit_every=100)
    good_err = max(max(r["mean_err"], r["cov_err"]) for r in good.audit_log)
    bad = _gsm(t, d, mode, steps_per_call=4, ns_iters=(5, 4, 3, 7, 4))
    with pytest.warns(UserWarning, match="fused-step audit"):
        bad.fit(0, niter=200, batch_size=8, verbose=False, audit_every=100)
    bad_err = max(max(r["mean_err"], r["cov_err"]) for r in bad.audit_log
                  if r["valid"])
    assert bad_err > 10 * max(good_err, 1e-8)


def _bam(t, d, **kw):
    return FactorBaM(d, t.lp, t.lp_g, fused_score=t.fused_score, device=DEV,
                     **kw)


def test_factorbam_audit_benign(kernel_paths, recwarn):
    """Fused BaM (NS ladder) audits clean against the thin-SVD step, and
    the audited fit ends where the unaudited one does, bit for bit."""
    d = 16
    t = _target(d)
    regf = Regularizers().linear(20.0)
    g = _bam(t, d, steps_per_call=4)
    assert g._fused_mode(8) == "step"
    st = g.fit(0, regf, niter=300, batch_size=8, verbose=False, retries=0,
               audit_every=100, return_state=True)
    assert [r["i"] for r in g.audit_log] == [100, 200, 300]
    valid = [r for r in g.audit_log if r["valid"]]
    assert valid, "every audited step was stiff: audit vacuous"
    assert max(max(r["mean_err"], r["cov_err"]) for r in valid) < 1e-3
    assert not _audit_warnings(recwarn)
    plain = _bam(t, d, steps_per_call=4).fit(
        0, regf, niter=300, batch_size=8, verbose=False, retries=0,
        return_state=True)
    assert torch.equal(st.mean, plain.mean)
    assert torch.equal(st.factor, plain.factor)
    assert st.ns_stats == plain.ns_stats


def test_factorbam_audit_stiff_steps_vacuous(kernel_paths):
    """Steps the kernel flags stiff are replayed exactly by the fit: the
    audit reports them valid=False with zero errors, not as bias."""
    d = 16
    t = dense_gaussian(3, d, device=DEV)
    g = _bam(t, d, steps_per_call=4, lmax_gate=1e-9, gu_gate=1e-9,
             ns_profile="long")
    g.fit(0, Regularizers().linear(20.0), niter=100, batch_size=8,
          verbose=False, retries=0, audit_every=50)
    assert g.audit_log and all(not r["valid"] for r in g.audit_log)
    assert all(r["mean_err"] == 0.0 and r["cov_err"] == 0.0
               for r in g.audit_log)


def test_audit_warns_when_fused_path_inactive():
    """audit_every on a config that runs no kernel (off the card, or
    use_fused=False) warns and audits nothing."""
    d = 16
    t = _target(d)
    g = FactorGSM(d, t.lp, t.lp_g, use_fused=False, device=DEV)
    with pytest.warns(UserWarning, match="not.*active"):
        g.fit(0, niter=50, batch_size=8, verbose=False, audit_every=25)
    assert g.audit_log == []
    b = FactorBaM(d, t.lp, t.lp_g, use_fused=False, device=DEV)
    with pytest.warns(UserWarning, match="not.*active"):
        b.fit(0, Regularizers().linear(20.0), niter=50, batch_size=8,
              verbose=False, retries=0, audit_every=25)
    assert b.audit_log == []


# --- against the JAX package's audits --------------------------------------

def _arrays(seed, d, near=False):
    """Target (mean, cov) and a state (mu0, f0): random, or ``near`` the
    target (5 % off), where BaM's steps are not stiff."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = 0.5 * rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    if near:
        mu0 = mean + 0.05 * rng.standard_normal(d)
        f0 = np.linalg.cholesky(cov) * (1 + 0.05 * rng.standard_normal((d, d)))
    else:
        mu0 = 0.3 * rng.standard_normal(d)
        f0 = np.eye(d) + 0.2 * rng.standard_normal((d, d))
    return (mean.astype(np.float32), cov.astype(np.float32),
            mu0.astype(np.float32), f0.astype(np.float32))


def _proposals_close(got, want):
    m_t, f_t, g_t = got
    m_j, f_j, g_j = want
    assert bool(g_t) == bool(g_j)
    np.testing.assert_allclose(np.asarray(m_t, np.float64),
                               np.asarray(m_j, np.float64), rtol=0,
                               atol=MEAN_TOL)
    f_t = np.asarray(f_t, np.float64)
    f_j = np.asarray(f_j, np.float64)
    s_j = f_j @ f_j.T
    np.testing.assert_allclose(f_t @ f_t.T, s_j, rtol=0,
                               atol=COV_TOL * max(1.0, np.abs(s_j).max()))


@pytest.mark.parametrize("fused", [False, True])
def test_gsm_audit_matches_jax(fused):
    """The port's audit on JAX's ``_audit_key`` draw from the same state:
    its fused side (K1, or the whole step on K4) and its exact side agree
    with JAX's, and so do ``valid`` and the reported errors."""
    b, d, i = 8, 16, 500
    mean, cov, mu0, f0 = _arrays(4, d)
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov, device=DEV)
    key = jax.random.PRNGKey(3)
    js = JFactorVIState(jnp.asarray(mu0), jnp.asarray(f0),
                        jnp.zeros((0, 0), jnp.float32), key, jnp.int32(i),
                        jnp.int32(0), jnp.int32(0))
    em_j, es_j, valid_j = jaudit.make_gsm_audit(
        tj.lp_g, b, d, jfs.NS_ITERS_DEFAULT, None, interpret=True,
        pallas_score=tj.pallas_score if fused else None)(js, jnp.int32(i))
    eps = jax.random.normal(jaudit._audit_key(key, i), (b, d), jnp.float32)
    jm, jf = jnp.asarray(mu0), jnp.asarray(f0)
    vs = tj.lp_g(jm + eps @ jf.T).astype(jnp.float32)
    if fused:
        score_fn, params = tj.pallas_score
        want_f = jfs.make_fused_eps_step(
            score_fn, len(params), b, d, external_eps=True,
            interpret=True)(eps, jm, jf, *params)
    else:
        want_f = jfs.gsm_eps_update_fused(eps, vs, jm, jf, interpret=True)
    want_x = j_apply_eps_step(jm, jf, eps, vs)

    ts = factor_state_from_numpy(mu0, f0, 0, i, 0, 0, device=DEV)
    audit = make_gsm_audit(tt.lp_g, b, d, NS_ITERS_DEFAULT,
                           fused_score=tt.fused_score if fused else None)
    eps_t = torch.from_numpy(np.array(eps))
    got_f, got_x = audit.proposals(ts, i, eps=eps_t)
    _proposals_close(got_f, want_f)
    _proposals_close(got_x, want_x)
    em_t, es_t, valid_t = audit(ts, i, eps=eps_t)
    assert bool(valid_t) == bool(valid_j) is True
    assert max(float(em_t), float(es_t)) < 1e-4
    assert max(float(em_j), float(es_j)) < 1e-4


@pytest.mark.parametrize("stats", ["cold", "benign"])
def test_bam_audit_matches_jax(stats, monkeypatch):
    """The BaM audit: the fused side on the tier the carried stats pick
    (cold start: tier 0; small stats: the most benign tier) and the SVD
    side agree with JAX's on its draw, ``valid`` equal."""
    b, d, step = 8, 16, 300
    mean, cov, mu0, f0 = _arrays(5, d, near=True)
    ns = ((np.inf, np.inf) if stats == "cold" else (0.5, 0.5))
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov, device=DEV)
    monkeypatch.setattr(j_bf, "on_tpu", lambda: True)
    jb = JFactorBaM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float32,
                    pallas_score=tj.pallas_score)
    jb._interpret = True
    regf_j = JRegularizers().linear(20.0)
    upd_j = jb._make_tiered_update(b)
    key = jax.random.PRNGKey(1)
    js = JFactorVIState(jnp.asarray(mu0), jnp.asarray(f0),
                        jnp.zeros((0, 0), jnp.float32), key,
                        jnp.int32(step), jnp.int32(0), jnp.int32(0),
                        jnp.asarray(ns, jnp.float32))
    em_j, es_j, valid_j = jaudit.make_bam_audit(
        tj.lp_g, b, d, regf_j, upd_j)(js, jnp.int32(step))
    eps = jax.random.normal(jaudit._audit_key(key, step), (b, d),
                            jnp.float32)
    jm, jf = jnp.asarray(mu0), jnp.asarray(f0)
    vs = tj.lp_g(jm + eps @ jf.T).astype(jnp.float32)
    reg = jnp.asarray(regf_j(jnp.int32(step)), jnp.float32)
    m_f, f_f, good_f, stiff_j, _ = upd_j(eps, vs, jm, jf, reg, js.ns_stats)
    want_x = j_bam_eps_update(eps, vs, jm, jf, reg, solver="svd")

    fb = FactorBaM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score,
                   device=DEV)
    audit = make_bam_audit(tt.lp_g, b, d, Regularizers().linear(20.0),
                           fb._make_tiered_update())
    ts = factor_state_from_numpy(mu0, f0, 0, step, 0, 0, device=DEV,
                                 ns_stats=np.asarray(ns, np.float32))
    eps_t = torch.from_numpy(np.array(eps))
    got_f, got_x, stiff_t = audit.proposals(ts, step, eps=eps_t)
    assert bool(stiff_t) == bool(stiff_j) is False
    _proposals_close(got_f, (m_f, f_f, good_f))
    _proposals_close(got_x, want_x)
    em_t, es_t, valid_t = audit(ts, step, eps=eps_t)
    assert bool(valid_t) == bool(valid_j) is True
    assert max(float(em_t), float(es_t)) < 1e-3
    assert max(float(em_j), float(es_j)) < 1e-3


def _counting_k4(monkeypatch):
    """Count the calls of the K4 steps that ``FactorGSM`` and its audits
    build."""
    import gsmvi_tpu_torch.utils.audit as t_audit

    calls = []
    real = t_gf.make_fused_eps_step

    def factory(*args, **kw):
        step = real(*args, **kw)

        def counted(*a):
            calls.append(1)
            return step(*a)

        return counted

    monkeypatch.setattr(t_gf, "make_fused_eps_step", factory)
    monkeypatch.setattr(t_audit, "make_fused_eps_step", factory)
    return calls


def test_spc1_runs_k4_and_equals_spc8(monkeypatch, kernel_paths):
    """``steps_per_call=1`` runs one K4 step per iteration (niter + 1
    calls) and ends where the K2 runner at spc=8 does, bit for bit; an
    audit there (K4 again) leaves the trajectory unchanged."""
    d = 16
    t = _target(d)
    calls = _counting_k4(monkeypatch)
    g1 = _gsm(t, d, "step", steps_per_call=1)
    s1 = g1.fit(0, niter=120, batch_size=8, verbose=False, return_state=True)
    assert len(calls) == 121
    g8 = _gsm(t, d, "step", steps_per_call=8)
    s8 = g8.fit(0, niter=120, batch_size=8, verbose=False, return_state=True)
    assert len(calls) == 121
    s1a = g1.fit(0, niter=120, batch_size=8, verbose=False,
                 return_state=True, audit_every=40)
    assert len(calls) == 2 * 121 + 3
    assert [r["i"] for r in g1.audit_log] == [40, 80, 120]
    for s in (s8, s1a):
        assert torch.equal(s.mean, s1.mean) and torch.equal(s.factor,
                                                            s1.factor)
        assert int(s.n_accepted) == int(s1.n_accepted)


def test_spc1_matches_jax_step_fit(monkeypatch, kernel_paths):
    """100 steps of the port's K4 route, fed JAX's ``normal(fold_in(key,
    s))`` draws, against JAX FactorGSM(steps_per_call=1) (its K4 in
    interpret mode) on the same f32 target: within 1e-4 on the mean and
    1e-4 * max|F| on the factor (tests/test_torch_fit.py's bound)."""
    d, b, niter = 16, 8, 99
    mean, cov, _, _ = _arrays(2, d)
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov, device=DEV)
    monkeypatch.setattr(j_gf, "on_tpu", lambda: True)
    gj = JFactorGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float32,
                    pallas_score=tj.pallas_score, steps_per_call=1)
    gj._interpret = True
    assert gj._pallas_mode(b) == "step"
    key = jax.random.PRNGKey(0)
    sj = gj.fit(key, niter=niter, batch_size=b, verbose=False,
                return_state=True)
    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                     jnp.float32))
        for s in range(niter + 1)])
    calls = _counting_k4(monkeypatch)
    gt = FactorGSM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score,
                   steps_per_call=1, device=DEV)
    gt._eps = lambda seed, step, batch, dd, dtype: torch.from_numpy(
        draws[step])
    st = gt.fit(0, niter=niter, batch_size=b, verbose=False,
                return_state=True)
    assert len(calls) == niter + 1
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=0,
                               atol=1e-4)
    f_j = np.asarray(sj.factor)
    np.testing.assert_allclose(st.factor.numpy(), f_j, rtol=0,
                               atol=1e-4 * float(np.abs(f_j).max()))


def test_audit_hook_reads_once_and_warns_on_accepted_bias():
    """The hook records floats and the flag, and warns only for a valid
    record over the tolerance (a rejected step carries no bias)."""
    from gsmvi_tpu_torch.utils.audit import make_audit_hook

    results = iter([(0.5, 2e-3, True), (0.5, 2e-3, False), (1e-6, 1e-6,
                                                            True)])

    def audit_fn(state, i):
        em, es, ok = next(results)
        return torch.tensor(em), torch.tensor(es), torch.tensor(ok)

    log = []
    hook = make_audit_hook(audit_fn, log, 1e-3, "FactorGSM")
    with pytest.warns(UserWarning, match="iteration 10"):
        hook(10, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hook(20, None)
        hook(30, None)
    assert [r["valid"] for r in log] == [True, False, True]
    assert log[0] == {"i": 10, "mean_err": 0.5,
                      "cov_err": pytest.approx(2e-3), "valid": True}
