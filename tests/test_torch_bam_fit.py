"""The port's BaM fitters as a whole: the K8 step runner and the K7 update
mode against JAX FactorBaM, trajectory invariance and resume, convergence,
routing and the kernel gate on the card.

The kernel paths of ``FactorBaM`` are driven on the CPU by monkeypatching
the port's ``on_gpu``: the kernel wrappers then run their plain versions on
the CPU tensors they are given.  The JAX side is driven as
tests/test_bam_fused.py drives it (``on_tpu`` monkeypatched, Pallas in
interpret mode), and the port is fed JAX's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.bam_factor as j_bf
import gsmvi_tpu_torch.bam as t_bam
import gsmvi_tpu_torch.bam_factor as t_bf
from gsmvi_tpu import Regularizers as JRegularizers
from gsmvi_tpu.gsm_factor import FactorVIState as JFactorVIState
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu_torch import BaM, FactorBaM, Regularizers
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays
from gsmvi_tpu_torch.ops.bam_fused import FEEDBACK_CADENCE
from gsmvi_tpu_torch.state import NS_STATS_INIT, FactorVIState, VIState

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make the port's FactorBaM take its kernel paths on the CPU."""
    monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)


def _target_arrays(seed, d, scale):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = scale * rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return mean.astype(np.float32), cov.astype(np.float32)


def _targets(seed, d, scale, benign=False):
    """The JAX and port targets from one pair of arrays; ``benign`` swaps
    the covariance for a well-conditioned one."""
    mean, cov = _target_arrays(seed, d, scale)
    if benign:
        a = np.random.default_rng(seed).standard_normal((d, d))
        cov = (0.6 * np.eye(d) + 0.1 * a @ a.T / d).astype(np.float32)
    return (_gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g"),
            gaussian_target_from_arrays(mean, cov, device=DEV))


def _jax_fitter(monkeypatch, t, d, **kw):
    monkeypatch.setattr(j_bf, "on_tpu", lambda: True)
    g = j_bf.FactorBaM(D=d, lp=t.lp, lp_g=t.lp_g, dtype=jnp.float32, **kw)
    g._interpret = True
    return g


def _moments_close(mean, cov, t, tol=0.05):
    scale = float(np.abs(np.asarray(t.cov)).max())
    np.testing.assert_allclose(np.asarray(mean), np.asarray(t.mean),
                               atol=tol * max(1.0, scale))
    np.testing.assert_allclose(np.asarray(cov), np.asarray(t.cov),
                               atol=tol * scale)


def test_step_runner_matches_jax_fused_fit(monkeypatch, kernel_paths):
    """150 steps of the port's K8 runner, fed JAX's ``normal(fold_in(key,
    s))`` draws, against JAX FactorBaM on its K8 kernel in interpret mode:
    the run crosses two feedback-cadence boundaries and replays stiff steps
    (a tight lmax gate).  Float32 on both sides with sums in other orders:
    step, accept count and the carried stats agree (stats to float32
    rounding), mean and factor within 1e-4 * max(1, scale)."""
    d, b, niter = 16, 8, 149
    assert niter + 1 > 2 * FEEDBACK_CADENCE
    tj, tt = _targets(2, d, 0.5)
    regf = 20.0
    gj = _jax_fitter(monkeypatch, tj, d, pallas_score=tj.pallas_score,
                     steps_per_call=4, lmax_gate=300.0)
    assert gj._pallas_mode(b) == "step"
    key = jax.random.PRNGKey(0)
    sj = gj.fit(key, JRegularizers().linear(regf), niter=niter, batch_size=b,
                verbose=False, retries=0, return_state=True)

    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                     jnp.float32))
        for s in range(niter + 1 + 4)])
    gt = FactorBaM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score,
                   steps_per_call=4, lmax_gate=300.0, device=DEV)
    assert gt._fused_mode(b) == "step"
    gt._eps = lambda seed, step, batch, dd, dtype: torch.from_numpy(
        draws[step])
    st = gt.fit(0, Regularizers().linear(regf), niter=niter, batch_size=b,
                verbose=False, retries=0, return_state=True)
    assert gt.fit_counts["replays"] >= 1
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.ns_stats, np.asarray(sj.ns_stats),
                               rtol=1e-4)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(
                                   np.asarray(sj.mean)).max())))
    f_j = np.asarray(sj.factor)
    np.testing.assert_allclose(st.factor.numpy(), f_j, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(f_j).max())))


@pytest.mark.parametrize("stiff", [False, True])
def test_update_mode_steps_match_jax(monkeypatch, kernel_paths, stiff):
    """Single steps of the "update" mode (K7, then the SVD replay on a stiff
    flag) against JAX's update-mode step on its state and its draw; the
    first step of a fit carries cold-start stats, so both run the long
    profile, and a stiff step adopts the kernel's stats at once."""
    d, b = 16, 8
    tj, tt = _targets(3, d, 1.0, benign=not stiff)
    reg0 = 50.0 if stiff else 2.0
    gj = _jax_fitter(monkeypatch, tj, d)
    assert gj._pallas_mode(b) == "update"
    jstep = jax.jit(gj._make_step(b, JRegularizers().constant(reg0), 0))
    zero = jnp.zeros((), jnp.int32)
    rng = np.random.default_rng(1)
    f0 = (np.eye(d) + 0.1 * rng.standard_normal((d, d))).astype(np.float32)
    mean0 = rng.standard_normal(d).astype(np.float32)
    sj0 = JFactorVIState(jnp.asarray(mean0), jnp.asarray(f0),
                         jnp.zeros((0, 0), jnp.float32),
                         jax.random.PRNGKey(4), zero, zero, zero)
    sj = jstep(sj0)
    _, ks = jax.random.split(sj0.key)
    eps = np.asarray(jax.random.normal(ks, (b, d), jnp.float32))

    gt = FactorBaM(d, tt.lp, tt.lp_g, device=DEV)
    assert gt._fused_mode(b) == "update"
    gt._eps = lambda seed, step, batch, dd, dtype: torch.tensor(eps)
    tstep = gt._make_step(b, Regularizers().constant(reg0), 0)
    st = tstep(FactorVIState(torch.from_numpy(mean0), torch.from_numpy(f0),
                             0, 0, torch.tensor(0, dtype=torch.int32),
                             torch.tensor(0, dtype=torch.int32)))
    assert gt.fit_counts["replays"] == int(stiff)
    assert gt.fit_counts["report_reads"] == 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.ns_stats, np.asarray(sj.ns_stats),
                               rtol=1e-4)
    assert np.isinf(st.ns_stats).all() == (not stiff)
    # One kernel update: 1e-5 (as for K7).  The stiff step is the f32 thin
    # SVD of an ill-conditioned Y on both sides, whose map error is itself
    # ~1e-5..1e-4 of the result (gsmvi_tpu/ops/bam_eps.py docstring): 1e-4.
    tol = 1e-4 if stiff else 1e-5
    scale = max(1.0, float(np.abs(np.asarray(sj.factor)).max()))
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=0,
                               atol=tol * max(1.0, float(np.abs(
                                   np.asarray(sj.mean)).max())))
    np.testing.assert_allclose(st.factor.numpy() @ st.factor.numpy().T,
                               np.asarray(sj.factor @ sj.factor.T), rtol=0,
                               atol=tol * scale ** 2)


@pytest.mark.parametrize("lmax_gate", [1e4, 300.0])
def test_trajectory_invariant_to_spc_and_cadence(kernel_paths, lmax_gate):
    """steps_per_call 2/4/5 (5 does not divide the cadence, so blocks
    truncate) and a monitor cadence give the bit-identical final state and
    carried stats over 200 steps (three cadence boundaries); the tight gate
    forces stiff stops and their immediate stats adoption."""
    d = 16
    t = dense_gaussian(7, d, scale=0.3 if lmax_gate == 1e4 else 1.0,
                       device=DEV)
    regf = Regularizers().linear(20.0)
    calls = []

    class Monitor:
        checkpoint = 17

        def __call__(self, i, params, lp, seed, nevals=0):
            calls.append(i)

    def run(spc, monitor=None):
        g = FactorBaM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                      steps_per_call=spc, lmax_gate=lmax_gate, device=DEV)
        st = g.fit(0, regf, niter=200, batch_size=8, verbose=False,
                   retries=0, monitor=monitor, return_state=True)
        return st, g.fit_counts

    (s2, c2), (s4, _), (s5, _), (s4m, _) = (run(2), run(4), run(5),
                                            run(4, Monitor()))
    for s in (s4, s5, s4m):
        assert torch.equal(s.mean, s2.mean) and torch.equal(s.factor,
                                                             s2.factor)
        assert s.ns_stats == s2.ns_stats
        assert int(s.n_accepted) == int(s2.n_accepted)
    if lmax_gate < 1e4:
        assert c2["replays"] > 0
    assert s2.step == 201 and calls[:3] == [0, 17, 34]
    assert not np.isinf(s2.ns_stats).any()


def test_resume_is_exact(kernel_paths):
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = FactorBaM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=4, device=DEV)
    regf = Regularizers().linear(20.0)
    full = g.fit(3, regf, niter=160, batch_size=8, verbose=False, retries=0,
                 return_state=True)
    half = g.fit(3, regf, niter=79, batch_size=8, verbose=False, retries=0,
                 return_state=True)
    res = g.fit(99, regf, niter=80, batch_size=8, verbose=False, retries=0,
                return_state=True, state=half)
    assert res.step == full.step == 161
    assert torch.equal(res.mean, full.mean)
    assert torch.equal(res.factor, full.factor)
    assert res.ns_stats == full.ns_stats


@pytest.mark.parametrize("mode", ["dense", "dense_lowrank", "factor",
                                  "update", "step", "bam_factor_route"])
def test_fits_converge_on_cpu(mode, monkeypatch):
    """BaM.fit on both routes and FactorBaM on each of its paths recover a
    small Gaussian target's moments (retries on, as the reference runs)."""
    d = 16
    t = dense_gaussian(5, d, scale=0.3, device=DEV)
    regf = Regularizers().linear(20.0)
    if mode.startswith("dense"):
        g = BaM(d, t.lp, t.lp_g, use_lowrank=mode == "dense_lowrank",
                device=DEV)
        assert not g._factor_route()
    elif mode == "bam_factor_route":
        monkeypatch.setattr(t_bam, "on_gpu", lambda device: True)
        monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)
        g = BaM(d, t.lp, t.lp_g, fused_score=t.fused_score, device=DEV)
        assert g._factor_route()
    else:
        if mode != "factor":
            monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)
        g = FactorBaM(d, t.lp, t.lp_g,
                      fused_score=t.fused_score if mode == "step" else None,
                      steps_per_call=4, device=DEV)
        assert g._fused_mode(8) == {"factor": None, "update": "update",
                                    "step": "step"}[mode]
    mean, cov = g.fit(0, regf, niter=300, batch_size=8, verbose=False,
                      retries=2)
    _moments_close(mean, cov, t)


def test_retries_draw_from_the_retry_stream(monkeypatch):
    """A failed first attempt is redrawn from ``retry_seed`` (not the
    per-step stream) up to ``retries`` times; a schedule whose first steps
    always fail counts every attempt."""
    d = 8
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = FactorBaM(d, t.lp, t.lp_g, solver="eigh", device=DEV)
    bad = lambda x: torch.full_like(x, float("nan"))
    g.lp_g = bad
    st = g.fit(0, Regularizers().constant(1.0), niter=2, batch_size=8,
               verbose=False, retries=3, return_state=True)
    assert g.fit_counts["retries"] == 9 and int(st.n_rejected) == 3
    assert torch.equal(st.factor, torch.eye(d))


def test_routes_state_boundary_and_gates(monkeypatch, kernel_paths):
    """"auto" takes the factor route exactly on CUDA and hands back a
    VIState; on the card the fitters raise outside the kernels' range or
    dtype unless use_fused=False; unported options raise."""
    d = 8
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = BaM(d, t.lp, t.lp_g, device=DEV)
    assert not g._factor_route()
    assert not BaM(d, t.lp, t.lp_g, use_factor=False,
                   device=DEV)._factor_route()
    assert BaM(d, t.lp, t.lp_g, use_factor=True, device=DEV)._factor_route()
    monkeypatch.setattr(t_bam, "on_gpu", lambda device: True)
    assert g._factor_route()
    with pytest.raises(ValueError, match=r"D in \[1, 8192\]"):
        FactorBaM(8193, t.lp, t.lp_g, device=DEV)._fused_mode(8)
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    s = BaM(d, t.lp, t.lp_g, device=DEV).fit(
        0, Regularizers().linear(20.0), niter=100, batch_size=8,
        verbose=False, retries=0, return_state=True)
    assert s.step == 101 and torch.isfinite(s.chol).all()
    with pytest.raises(NotImplementedError, match="float32"):
        FactorBaM(d, t.lp, t.lp_g, dtype=torch.float64,
                  device=DEV)._fused_mode(8)
    with pytest.raises(ValueError, match=r"B in \[1, 128\]"):
        FactorBaM(d, t.lp, t.lp_g, device=DEV)._fused_mode(129)
    assert FactorBaM(d, t.lp, t.lp_g, use_fused=False,
                     dtype=torch.float64, device=DEV)._fused_mode(64) is None
    # audit_every is ported: the K7 path audits at its cadence.
    fb = FactorBaM(d, t.lp, t.lp_g, device=DEV)
    fb.fit(0, Regularizers().linear(1.0), niter=10, batch_size=8,
           verbose=False, retries=0, audit_every=5)
    assert [r["i"] for r in fb.audit_log] == [5, 10]
    # jit_compile=False is ported: the dense eager loop, never the factor
    # route (tests/test_torch_options.py holds it against JAX's).
    eager = BaM(d, t.lp, t.lp_g, jit_compile=False, use_factor=True,
                device=DEV)
    assert not eager._factor_route()
    st = eager.fit(0, Regularizers().linear(1.0), niter=5, batch_size=8,
                   verbose=False, return_state=True)
    assert isinstance(st, VIState) and st.step == 6
    assert FactorVIState(*s[:2], 0, 0, s.n_accepted,
                         s.n_rejected).ns_stats == NS_STATS_INIT
