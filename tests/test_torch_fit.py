"""The port's fitters as a whole: the slice against the JAX package, the
eps-stream properties, routing, and the import boundary.

The kernel paths ("update" and "step" modes of ``FactorGSM``) are driven on
the CPU by monkeypatching the port's ``on_gpu``: the kernel wrappers then
run their plain versions on the CPU tensors they are given.  The JAX side is
driven as ``tests/test_gsm_fused_foldin.py`` drives it (``on_tpu``
monkeypatched, Pallas in interpret mode).
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.gsm_factor as j_gf
import gsmvi_tpu_torch.gsm as t_gsm
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu import FactorGSM as JFactorGSM
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu_torch import ADVI, GSM, BaM, FactorBaM, FactorGSM
from gsmvi_tpu_torch.advi import advi_state_from_numpy
from gsmvi_tpu_torch.driver import step_seed
from gsmvi_tpu_torch.models import (dense_gaussian,
                                    gaussian_target_from_arrays,
                                    ill_conditioned_gaussian)
from gsmvi_tpu_torch.state import factor_state_from_numpy, init_state

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
    """Make the port's FactorGSM take its kernel paths on the CPU."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)


def _target_arrays(seed, d, scale):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(size=d)
    l = scale * rng.standard_normal((d, d))
    cov = l @ l.T + 1e-3 * np.eye(d)
    return mean.astype(np.float32), cov.astype(np.float32)


def _moments_close(mean, cov, t):
    """The converged-moment bound of tests/test_gsm_fused_foldin.py."""
    np.testing.assert_allclose(np.asarray(mean), np.asarray(t.mean),
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(cov), np.asarray(t.cov),
                               atol=0.05 * float(np.abs(np.asarray(t.cov)).max()))


def test_step_runner_matches_jax_fused_fit(monkeypatch, kernel_paths):
    """100 steps of the port's whole-step runner, fed JAX's own
    ``normal(fold_in(key, s))`` draws, against JAX FactorGSM on its fused
    multistep kernel in interpret mode, on the same f32 target.  Float32 on
    both sides with sums in different orders: the trajectories stay within
    1e-4 (mean) and 1e-4 * max|F| (factor) over the 100 steps."""
    d, b, niter = 16, 8, 99
    mean, cov = _target_arrays(2, d, 0.5)
    tj = _gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean, cov, device=DEV)

    monkeypatch.setattr(j_gf, "on_tpu", lambda: True)
    gj = JFactorGSM(D=d, lp=tj.lp, lp_g=tj.lp_g, dtype=jnp.float32,
                    pallas_score=tj.pallas_score)
    gj._interpret = True
    assert gj._pallas_mode(b) == "step"
    key = jax.random.PRNGKey(0)
    sj = gj.fit(key, niter=niter, batch_size=b, verbose=False,
                return_state=True)

    spc = gj.steps_per_call
    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                     jnp.float32))
        for s in range(niter + 1 + spc)])
    gt = FactorGSM(d, tt.lp, tt.lp_g, fused_score=tt.fused_score, device=DEV)
    assert gt._fused_mode(b) == "step" and gt.steps_per_call == spc
    gt._eps = lambda seed, step, batch, dd, dtype: torch.from_numpy(
        draws[step])
    st = gt.fit(0, niter=niter, batch_size=b, verbose=False,
                return_state=True)
    assert st.step == int(sj.step) == niter + 1
    assert int(st.n_accepted) == int(sj.n_accepted)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=0,
                               atol=1e-4)
    f_j = np.asarray(sj.factor)
    np.testing.assert_allclose(st.factor.numpy(), f_j, rtol=0,
                               atol=1e-4 * float(np.abs(f_j).max()))


@pytest.mark.parametrize("mode", ["dense", "factor", "update", "step"])
def test_fits_converge_on_cpu(mode, monkeypatch):
    """GSM.fit (the dense route off the card) and FactorGSM on each of its
    paths recover the target's moments."""
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    if mode == "dense":
        g = GSM(d, t.lp, t.lp_g, device=DEV)
        assert not g._factor_route(8)
    else:
        if mode != "factor":
            monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
        g = FactorGSM(d, t.lp, t.lp_g,
                      fused_score=t.fused_score if mode == "step" else None,
                      steps_per_call=8, device=DEV)
        assert g._fused_mode(8) == {"factor": None, "update": "update",
                                    "step": "step"}[mode]
    mean, cov = g.fit(0, niter=600, batch_size=8, verbose=False)
    _moments_close(mean, cov, t)


def test_trajectory_invariant_to_spc_and_cadence(kernel_paths):
    """steps_per_call 1/4/5 (5 leaves remainders) and a monitor cadence
    give the bit-identical final state: eps depends only on (seed, step)."""
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    calls = []

    class Monitor:
        checkpoint = 17

        def __call__(self, i, params, lp, seed, nevals=0):
            calls.append(i)

    def run(spc, monitor=None):
        g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                      steps_per_call=spc, device=DEV)
        assert g._fused_mode(8) == "step"
        return g.fit(0, niter=101, batch_size=8, verbose=False,
                     monitor=monitor, return_state=True)

    s1, s4, s5, s4m = run(1), run(4), run(5), run(4, Monitor())
    for s in (s4, s5, s4m):
        assert torch.equal(s.mean, s1.mean) and torch.equal(s.factor, s1.factor)
        assert int(s.n_accepted) == int(s1.n_accepted)
    assert s4.step == 102 and calls[:3] == [0, 17, 34] and calls[-1] == 101


def test_resume_is_exact(kernel_paths):
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=4, device=DEV)
    assert g._fused_mode(8) == "step"
    full = g.fit(3, niter=160, batch_size=8, verbose=False, return_state=True)
    half = g.fit(3, niter=79, batch_size=8, verbose=False, return_state=True)
    res = g.fit(99, niter=80, batch_size=8, verbose=False, return_state=True,
                state=half)
    assert res.step == full.step == 161
    assert torch.equal(res.mean, full.mean)
    assert torch.equal(res.factor, full.factor)
    assert int(res.n_accepted) == int(full.n_accepted)


def test_kernel_gate_raises_on_the_card(monkeypatch, kernel_paths):
    """On a CUDA device a dtype or shape the kernels do not take raises;
    use_fused=False is the one plain route there, and GSM's "auto" factor
    route hands such shapes on to the same gate."""
    d = 16
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    with pytest.raises(NotImplementedError, match="float32"):
        FactorGSM(d, t.lp, t.lp_g, dtype=torch.float64,
                  device=DEV)._fused_mode(8)
    with pytest.raises(ValueError, match=r"B in \[8, 64\]"):
        FactorGSM(d, t.lp, t.lp_g, device=DEV)._fused_mode(96)
    with pytest.raises(ValueError, match=r"D in \[16, 1024\]"):
        FactorGSM(8, t.lp, t.lp_g, device=DEV)._fused_mode(8)
    assert FactorGSM(d, t.lp, t.lp_g, use_fused=False,
                     dtype=torch.float64, device=DEV)._fused_mode(96) is None
    monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)
    with pytest.raises(ValueError, match="use_fused=False"):
        GSM(d, t.lp, t.lp_g, device=DEV).fit(0, niter=2, batch_size=4,
                                             verbose=False)


def test_eps_stream_seeding():
    seeds = {step_seed(s, k) for s in range(4) for k in range(64)}
    assert len(seeds) == 256 and all(0 <= x < 2 ** 63 for x in seeds)
    assert step_seed(1, 2) == step_seed(1, 2) != step_seed(2, 1)


def test_gsm_routes_and_state_boundary(monkeypatch):
    """"auto" takes the factor route exactly on CUDA, the huge-batch guard
    keeps B >= 128 with 2B > D dense, and the factor route hands back a
    VIState."""
    d = 8
    t = dense_gaussian(7, d, scale=0.3, device=DEV)
    g = GSM(d, t.lp, t.lp_g, device=DEV)
    assert not g._factor_route(8)
    monkeypatch.setattr(t_gsm, "on_gpu", lambda device: True)
    assert g._factor_route(8)
    assert not g._factor_route(128)
    assert not GSM(d, t.lp, t.lp_g, use_factor=False,
                   device=DEV)._factor_route(8)
    with pytest.warns(UserWarning, match="2\\*batch_size > D"):
        assert not GSM(d, t.lp, t.lp_g, use_factor=True,
                       device=DEV)._factor_route(128)
    s = g.fit(0, niter=200, batch_size=8, verbose=False, return_state=True)
    assert s.step == 201 and torch.isfinite(s.chol).all()
    _moments_close(s.mean, s.cov, t)


def test_dense_resume_and_unported_options():
    d = 6
    t = dense_gaussian(1, d, scale=0.3, device=DEV)
    g = GSM(d, t.lp, t.lp_g, fused_score=t.fused_score, device=DEV)
    with pytest.warns(UserWarning, match="fused_score is set"):
        full = g.fit(0, niter=50, batch_size=4, verbose=False,
                     return_state=True)
        half = g.fit(0, niter=24, batch_size=4, verbose=False,
                     return_state=True)
        res = g.fit(0, niter=25, batch_size=4, verbose=False,
                    return_state=True, state=half)
    assert torch.equal(res.cov, full.cov) and res.step == full.step
    with pytest.raises(NotImplementedError):
        FactorGSM(d, t.lp, t.lp_g, pallas_precision="bf16", device=DEV)
    with pytest.raises(NotImplementedError):
        FactorGSM(d, t.lp, t.lp_g, method="qr", device=DEV)


DEFAULT_DEVICE_CALLS = {
    "GSM": lambda t: GSM(4, t.lp, t.lp_g),
    "FactorGSM": lambda t: FactorGSM(4, t.lp, t.lp_g),
    "BaM": lambda t: BaM(4, t.lp, t.lp_g),
    "FactorBaM": lambda t: FactorBaM(4, t.lp, t.lp_g),
    "ADVI": lambda t: ADVI(4, t.lp),
    "dense_gaussian": lambda t: dense_gaussian(0, 4),
    "ill_conditioned_gaussian": lambda t: ill_conditioned_gaussian(0, 4),
    "gaussian_target_from_arrays": lambda t: gaussian_target_from_arrays(
        np.zeros(4, np.float32), np.eye(4, dtype=np.float32)),
    "init_state": lambda t: init_state(0, 4),
    "factor_state_from_numpy": lambda t: factor_state_from_numpy(
        np.zeros(4), np.eye(4), 0, 0, 0, 0),
    "advi_state_from_numpy": lambda t: advi_state_from_numpy(
        np.zeros(4), np.eye(4), 0, 0),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(name, monkeypatch):
    """Every fitter, target constructor and state helper defaults to the
    CUDA card; with no card the default raises at construction instead of
    running on the CPU."""
    t = dense_gaussian(0, 4, device=DEV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CALLS[name](t)


def test_import_loads_neither_jax_nor_triton():
    code = ("import sys, gsmvi_tpu_torch, gsmvi_tpu_torch.gsm_factor, "
            "gsmvi_tpu_torch.ops.fused_step, gsmvi_tpu_torch.ops.cuda._build, "
            "gsmvi_tpu_torch.bam, gsmvi_tpu_torch.bam_factor, "
            "gsmvi_tpu_torch.ops.bam, gsmvi_tpu_torch.ops.bam_eps, "
            "gsmvi_tpu_torch.ops.bam_fused, gsmvi_tpu_torch.ops.sqrtm, "
            "gsmvi_tpu_torch.ops.gsm_step, gsmvi_tpu_torch.ops.batch_fused, "
            "gsmvi_tpu_torch.utils.audit; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'gsmvi_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
