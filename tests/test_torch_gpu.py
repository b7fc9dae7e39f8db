"""The port's CUDA kernels against their plain torch versions, on the card.

Skipped unless ``TESTS_ON_GPU=1`` (and then a missing CUDA device fails):

    TESTS_ON_GPU=1 python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need on a GPU machine.)  Tolerances as in ``chip_smoke.py``:
1e-5 on the mean and 1e-5 * max|F| on the factor for one update (float32,
sums in other orders), 1e-4 for eight chained sub-steps; for the BaM
kernels 1e-5 / 1e-4 of max(1, scale), and their gate statistics within
1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch

from gsmvi_tpu_torch import GSM, FactorGSM
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if os.environ.get("TESTS_ON_GPU", "") in ("", "0", "false", "False"):
        pytest.skip("needs an NVIDIA GPU: run with TESTS_ON_GPU=1")
    if not torch.cuda.is_available():
        pytest.fail("TESTS_ON_GPU=1 but torch sees no CUDA device")
    from gsmvi_tpu_torch.config import pin_fp32

    pin_fp32()
    return torch.device("cuda")


def _inputs(dev, b, d, seed=0, decades=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    f = np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    ladder = np.logspace(0.0, decades, b)[:, None]
    eps = (ladder * rng.standard_normal((b, d))).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (eps, v, mu, f)]


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("b,d", [(8, 16), (8, 200), (32, 256), (64, 1024)])
def test_update_kernel_matches_plain(cuda, b, d, with_ef):
    eps, v, mu, f = _inputs(cuda, b, d, seed=b + d)
    ef = eps @ f.T if with_ef else None
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f, ef=ef)
    m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f, ef_t=ef)
    assert bool(g_k) and bool(g_p)
    assert float((m_k - m_p).abs().max()) <= 1e-5
    assert float((f_k - f_p).abs().max()) <= 1e-5 * float(f.abs().max())


def test_update_kernel_rejects_and_keeps_state(cuda):
    eps, v, mu, f = _inputs(cuda, 32, 256, decades=3.0)
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    _, _, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f)
    assert not bool(g_k) and not bool(g_p)
    assert torch.equal(m_k, mu) and torch.equal(f_k, f)


@pytest.mark.parametrize("b,d", [(8, 200), (32, 256)])
def test_multistep_kernel_matches_plain(cuda, b, d):
    t = dense_gaussian(0, d, device=cuda)
    score_fn, params = t.fused_score
    spc = 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    block = torch.randn((spc * b, d), generator=gen, device=cuda)
    step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    mean0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    # Eight chained steps from (0, I) amplify rounding: at (8, 200) the
    # plain version in float32 sits farther from itself in float64 than the
    # kernel does, so the kernel is held to 1e-4 of the plain version run in
    # float64.
    p64 = tuple(x.double() for x in params)
    for nmax in (spc, 3):
        m_k, f_k, n_k = step(nmax, block, mean0, f0, *params)
        m_p, f_p, n_p = fs.eps_multistep_reference(
            fs.gaussian_score_reference, p64, nmax, block.double(),
            mean0.double(), f0.double(), batch=b)
        assert int(n_k) == int(n_p) == nmax
        assert float((m_k.double() - m_p).abs().max()) <= 1e-4
        assert float((f_k.double() - f_p).abs().max()) <= 1e-4 * float(
            f_p.abs().max())


def test_gaussian_score_kernel_matches_plain(cuda):
    t = dense_gaussian(0, 200, device=cuda)
    x = torch.randn((8, 200), device=cuda)
    v_k = fs.gaussian_score(x, *t.fused_score[1])
    v_p = fs.gaussian_score_reference(x, *t.fused_score[1])
    assert float((v_k - v_p).abs().max()) <= 1e-5 * max(
        1.0, float(v_p.abs().max()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    eps, v, mu, f = _inputs(cuda, 8, 64)
    with pytest.raises(TypeError, match="float32"):
        fs.gsm_eps_update_fused(eps.double(), v.double(), mu.double(),
                                f.double())
    with pytest.raises(ValueError, match="contiguous"):
        fs.gsm_eps_update_fused(eps, v, mu, f.T)
    e65, v65, _, _ = _inputs(cuda, 65, 64)
    with pytest.raises(ValueError, match=r"CUDA kernels \(chol\) take"):
        fs.gsm_eps_update_fused(e65, v65, mu, f, method="chol")
    with pytest.raises(ValueError, match="several devices"):
        fs.gsm_eps_update_fused(eps, v, mu.cpu(), f)


def test_fitters_raise_outside_the_kernel_range(cuda):
    """On the card the fitters run the kernels or raise; only
    use_fused=False runs the plain step there."""
    d = 64
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    with pytest.raises(ValueError, match="CUDA kernels take B"):
        FactorGSM(d, t.lp, t.lp_g, device="cuda").fit(
            0, batch_size=1024, niter=2, verbose=False)
    with pytest.raises(NotImplementedError, match="float32"):
        FactorGSM(d, t.lp, t.lp_g, device="cuda", dtype=torch.float64).fit(
            0, batch_size=16, niter=2, verbose=False)
    fs.reset_launch_counts()
    mean, _ = FactorGSM(d, t.lp, t.lp_g, device="cuda", use_fused=False).fit(
        0, batch_size=1024, niter=2, verbose=False)
    assert mean.is_cuda and sum(fs.launch_counts().values()) == 0


def test_fits_run_through_the_kernels(cuda):
    """GSM.fit on CUDA takes the factor route and K1 once per step; the
    whole-step path launches K2 and K3 and is invariant to spc."""
    d, b, niter = 64, 16, 40
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    fs.reset_launch_counts()
    GSM(d, t.lp, t.lp_g, device="cuda").fit(0, batch_size=b, niter=niter,
                                            verbose=False)
    assert fs.launch_counts()["gsm_eps_update_fused"] == niter + 1
    states = []
    for spc in (1, 8):
        g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                      steps_per_call=spc, device="cuda")
        assert g._fused_mode(b) == "step"
        states.append(g.fit(0, batch_size=b, niter=niter, verbose=False,
                            return_state=True))
    counts = fs.launch_counts()
    assert counts["make_fused_eps_multistep"] > 0
    assert counts["gaussian_score"] == 2 * (niter + 1)
    assert torch.equal(states[0].mean, states[1].mean)
    assert torch.equal(states[0].factor, states[1].factor)


# ---------------------------------------------------------------------------
# BaM: K7 bam_eps_update_fused and K8 make_fused_bam_multistep
# ---------------------------------------------------------------------------

def _bam_inputs(dev, b, d, seed=0, score_scale=1.0, v_scale=None):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    v = score_scale * -(mu + e @ f.T - rng.standard_normal(d))
    if v_scale is not None:
        v = v_scale * rng.standard_normal((b, d))
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in (e, v, mu, f)]


def _within(got, want, tol):
    return float((got - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


OPEN_GATES = {"lmax_gate": float("inf"), "gu_gate": float("inf")}
BAM_K7_CASES = {
    "benign": ({"v_scale": 0.05}, 0.5, {}, (True, False)),
    "stiff_lmax": ({"score_scale": 300.0}, 20.0, {}, (False, True)),
    "stiff_gu": ({"v_scale": 0.02}, 1e4, {"lmax_gate": float("inf")},
                 (False, True)),
    "reject": ({}, 3e5, OPEN_GATES, (False, False)),
}


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("case", sorted(BAM_K7_CASES))
@pytest.mark.parametrize("b,d", [(8, 16), (12, 200), (32, 256), (56, 1024)])
def test_bam_update_kernel_matches_plain(cuda, b, d, case, with_ef):
    from gsmvi_tpu_torch.ops import bam_fused as bf

    kw, reg, gates, flags = BAM_K7_CASES[case]
    e, v, mu, f = _bam_inputs(cuda, b, d, seed=b + d, **kw)
    ef = e @ f.T if with_ef else None
    k = bf.bam_eps_update_fused(e, v, mu, f, reg, ef=ef, **gates)
    p = bf.bam_eps_update_ns_reference(e, v, mu, f, reg, ef=ef, **gates)
    assert (bool(k[2]), bool(k[3])) == (bool(p[2]), bool(p[3])) == flags
    assert np.allclose(k[4].tolist(), p[4].tolist(), rtol=1e-3, atol=0)
    assert _within(k[0], p[0], 1e-5) and _within(k[1], p[1], 1e-5)
    if not flags[0]:
        assert torch.equal(k[0], mu) and torch.equal(k[1], f)


BAM_K8_CASES = {
    "full": (None, 8, 0, None, (8, 8, 0)),
    "nmax_lt_spc": (None, 3, 0, None, (3, 3, 0)),
    "stiff_stop": ({3: 1e9}, 8, 0, None, (3, 3, 1)),
    "reject_consumed": ({2: 2.0}, 8, 0, (2, 2, 2, 2, 2), (8, 7, 0)),
    "stop_on_reject": ({2: 2.0}, 8, 1, (2, 2, 2, 2, 2), (2, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(BAM_K8_CASES))
def test_bam_multistep_kernel_matches_plain(cuda, case):
    """K8 at spc=8 on a benign target (identity covariance)."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    changes, nmax, sor, iters, counts = BAM_K8_CASES[case]
    b, d, spc = 32, 256, 8
    base = 1e-4 if iters is not None else 0.05
    regs = [base] * spc
    for j, r in (changes or {}).items():
        regs[j] = r
    mean_t = torch.linspace(-1.0, 1.0, d, device=cuda).reshape(1, d)
    params = (mean_t, torch.eye(d, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(2)
    block = torch.randn((spc * b, d), generator=gen, device=cuda)
    mean0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    kw = {} if iters is None else {"iters": iters}
    step = bf.make_fused_bam_multistep(fs.gaussian_score, 2, b, d, spc, **kw)
    k = step(regs, nmax, sor, block, mean0, f0, *params)
    p = bf.bam_multistep_reference(fs.gaussian_score_reference, params, regs,
                                   nmax, sor, block, mean0, f0, batch=b, **kw)
    assert tuple(int(x) for x in k[2:5]) == tuple(int(x) for x in p[2:5]) \
        == counts
    assert np.allclose(k[5].tolist(), p[5].tolist(), rtol=1e-3, atol=0)
    assert _within(k[0], p[0], 1e-4) and _within(k[1], p[1], 1e-4)


def test_bam_fitters_raise_outside_the_kernel_range(cuda):
    from gsmvi_tpu_torch import BaM, FactorBaM, Regularizers

    d = 64
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    regf = Regularizers().linear(20.0)
    with pytest.raises(ValueError, match="BaM CUDA kernels take B"):
        BaM(d, t.lp, t.lp_g, device="cuda").fit(0, regf, batch_size=129,
                                                niter=2, verbose=False)
    with pytest.raises(NotImplementedError, match="float32"):
        FactorBaM(d, t.lp, t.lp_g, device="cuda", dtype=torch.float64).fit(
            0, regf, batch_size=16, niter=2, verbose=False)
    fs.reset_launch_counts()
    mean, _ = FactorBaM(d, t.lp, t.lp_g, device="cuda", use_fused=False).fit(
        0, regf, batch_size=129, niter=2, verbose=False, retries=0)
    assert mean.is_cuda and sum(fs.launch_counts().values()) == 0


def test_bam_fits_run_through_the_kernels(cuda):
    """BaM.fit on CUDA takes K7 once per step; the whole-step path launches
    K8 and K3 and its trajectory does not depend on spc."""
    from gsmvi_tpu_torch import BaM, FactorBaM, Regularizers

    d, b, niter = 64, 16, 40
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    regf = Regularizers().linear(20.0)
    fs.reset_launch_counts()
    g = BaM(d, t.lp, t.lp_g, device="cuda")
    g.fit(0, regf, batch_size=b, niter=niter, verbose=False, retries=0)
    assert fs.launch_counts()["bam_eps_update_fused"] == niter + 1
    states = []
    for spc in (1, 8):
        fb = FactorBaM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                       steps_per_call=spc, device="cuda")
        assert fb._fused_mode(b) == "step"
        states.append(fb.fit(0, regf, batch_size=b, niter=niter,
                             verbose=False, retries=0, return_state=True))
    counts = fs.launch_counts()
    assert counts["make_fused_bam_multistep"] > 0
    assert counts["gaussian_score"] > 0
    assert torch.equal(states[0].mean, states[1].mean)
    assert torch.equal(states[0].factor, states[1].factor)
    assert states[0].ns_stats == states[1].ns_stats


# ---------------------------------------------------------------------------
# ADVI: K9 make_fused_advi_multistep and K10 make_fused_advi_stl_multistep
# ---------------------------------------------------------------------------

def _advi_inputs(dev, b, d, spc, seed=0):
    """A benign target's score params, a state near the identity with its
    exact inverse, zero moments and an eps block, on ``dev``."""
    rng = np.random.default_rng(seed)
    l = np.tril(np.eye(d) + 0.02 * rng.standard_normal((d, d)))
    arrays = [np.linspace(-1.0, 1.0, d)[None], np.eye(d),
              0.1 * rng.standard_normal(d), l, np.tril(np.linalg.inv(l)),
              rng.standard_normal((spc * b, d))]
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in arrays]


def _advi_state_close(got, want, lrs, rtol=1e-5):
    """The chip_smoke.py bound: each tensor within rtol * max(1, |x|) on
    >= 99.99 % of its entries; loc and L within 2 * sum(lr) everywhere."""
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        assert bool(torch.isfinite(g).all())
        ok = diff <= rtol * w.abs().clamp(min=1.0)
        assert float(ok.double().mean()) >= 0.9999, i
        if i < 2:
            assert float(diff.max()) <= 2.0 * sum(lrs)


ADVI_K10_CASES = {
    # name: (nmax, lr at sub-step 2, poisoned sub-step, (n_done, stiff))
    "full": (8, 1e-3, None, (8, 0)),
    "nmax_lt_spc": (3, 1e-3, None, (3, 0)),
    "gate_trip_at_3": (8, 0.05, None, (3, 1)),
    "nonfinite_gradient": (8, 1e-3, 2, (2, 1)),
}


@pytest.mark.parametrize("b,d", [(8, 16), (8, 200), (32, 256), (64, 1024)])
def test_advi_k9_matches_plain(cuda, b, d):
    from gsmvi_tpu_torch.ops import advi_fused as af

    spc = 8
    mean_t, prec, loc, l, _, block = _advi_inputs(cuda, b, d, spc, seed=d)
    z, zz = torch.zeros(d, device=cuda), torch.zeros((d, d), device=cuda)
    lrs = [1e-3] * spc
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    k9 = af.make_fused_advi_multistep(fs.gaussian_score, 2, b, d, spc)
    for nmax in (1, 3, spc):
        args = (lrs, bc1s, bc2s, nmax, block, loc, l, z, z, zz, zz, mean_t,
                prec)
        got = k9(*args)
        want = af.advi_multistep_reference(fs.gaussian_score_reference,
                                           (mean_t, prec), *args[:-2],
                                           batch=b)
        _advi_state_close(got, want, lrs[:nmax])
        if nmax == 1:       # m = 0.1 g: the first gradient within 1e-5
            for i in (2, 4):
                assert _within(got[i], want[i], 1e-5)


@pytest.mark.parametrize("case", sorted(ADVI_K10_CASES))
@pytest.mark.parametrize("b,d", [(8, 200), (32, 256), (16, 1024)])
def test_advi_k10_matches_plain(cuda, b, d, case):
    from gsmvi_tpu_torch.ops import advi_fused as af

    nmax, lr2, poison, counts = ADVI_K10_CASES[case]
    if d == 1024 and case == "full":
        lr2 = 1e-4                         # D * lr stays under the gate
    spc = 8
    mean_t, prec, loc, l, ainv, block = _advi_inputs(cuda, b, d, spc,
                                                     seed=d + 1)
    if poison is not None:
        block[poison * b:(poison + 1) * b] = 1e30
    z, zz = torch.zeros(d, device=cuda), torch.zeros((d, d), device=cuda)
    lrs = [1e-4 if d == 1024 else 1e-3] * spc
    lrs[2] = lr2
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    args = (lrs, bc1s, bc2s, nmax, block, loc, l, ainv, z, z, zz, zz,
            mean_t, prec)
    k10 = af.make_fused_advi_stl_multistep(fs.gaussian_score, 2, b, d, spc)
    *got, nd_k, st_k = k10(*args)
    *want, nd_p, st_p = af.advi_stl_multistep_reference(
        fs.gaussian_score_reference, (mean_t, prec), *args[:-2], batch=b)
    assert (int(nd_k), int(st_k)) == (int(nd_p), int(st_p)) == counts
    _advi_state_close(got, want, lrs[:counts[0]])


@pytest.mark.parametrize("b,d", [(1, 1), (512, 256)])
def test_advi_blocks_match_plain_at_the_range_edges(cuda, b, d):
    """K9 and K10 at B=1, D=1 and at B=512 (a 16-slab dL): a full block and
    a remainder against the plain versions, K10's counts equal; above B=32
    the tolerance grows as sqrt(B/32), chip_smoke.py's rule for the B-row
    sums behind the gradient."""
    from gsmvi_tpu_torch.ops import advi_fused as af

    spc = 8
    rtol = 1e-5 * max(1.0, (b / 32) ** 0.5)
    mean_t, prec, loc, l, ainv, block = _advi_inputs(cuda, b, d, spc,
                                                     seed=d + 7)
    z, zz = torch.zeros(d, device=cuda), torch.zeros((d, d), device=cuda)
    lrs = [1e-3] * spc
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    k9 = af.make_fused_advi_multistep(fs.gaussian_score, 2, b, d, spc)
    k10 = af.make_fused_advi_stl_multistep(fs.gaussian_score, 2, b, d, spc)
    for nmax in (spc, 3):
        args = (lrs, bc1s, bc2s, nmax, block, loc, l, z, z, zz, zz)
        got = k9(*args, mean_t, prec)
        want = af.advi_multistep_reference(fs.gaussian_score_reference,
                                           (mean_t, prec), *args, batch=b)
        _advi_state_close(got, want, lrs[:nmax], rtol)
        args = (lrs, bc1s, bc2s, nmax, block, loc, l, ainv, z, z, zz, zz)
        *got, nd_k, st_k = k10(*args, mean_t, prec)
        *want, nd_p, st_p = af.advi_stl_multistep_reference(
            fs.gaussian_score_reference, (mean_t, prec), *args, batch=b)
        assert (int(nd_k), int(st_k)) == (int(nd_p), int(st_p))
        _advi_state_close(got, want, lrs[:int(nd_p)], rtol)


@pytest.mark.parametrize("stl", [False, True])
def test_advi_graph_blocks_equal_eager_blocks(cuda, stl):
    """A full block replayed from its graph, a remainder and (K10) a block
    that stops at a tripped gate or a nonfinite gradient give the eager
    route's state and report bit for bit; the graph is captured once."""
    from gsmvi_tpu_torch.ops import advi_fused as af

    b, d, spc = 32, 256, 8
    mean_t, prec, loc, l, ainv, block = _advi_inputs(cuda, b, d, spc, seed=4)
    z, zz = torch.zeros(d, device=cuda), torch.zeros((d, d), device=cuda)
    _, bc1s, bc2s = (a.tolist() for a in af.lr_bias_arrays(
        lambda s: 0.0, 0.9, 0.999, torch.arange(spc, dtype=torch.int32)))
    state = [loc, l] + ([ainv] if stl else []) + [z, z, zz, zz]
    make = (af.make_fused_advi_stl_multistep if stl
            else af.make_fused_advi_multistep)
    step = make(fs.gaussian_score, 2, b, d, spc)
    trip = [1e-3] * spc
    trip[2] = 0.05
    poisoned = block.clone()
    poisoned[2 * b:3 * b] = 1e30
    cases = [([1e-3] * spc, spc, block), ([1e-3] * spc, 5, block)]
    if stl:
        cases += [(trip, spc, block), ([1e-3] * spc, spc, poisoned)]
    for lrs, nmax, blk in cases:
        args = (lrs, bc1s, bc2s, nmax, blk, *state, mean_t, prec)
        eager = step.packed(*args, graph=False)
        for _ in range(2):
            got = step.packed(*args)
            assert all(torch.equal(x, y) for x, y in zip(got, eager))
    assert len(step.captures) == 1
    if stl:
        rep = step.packed(trip, bc1s, bc2s, spc, block, *state, mean_t,
                          prec)[-1]
        assert (int(rep[af.REP_NDONE]), int(rep[af.REP_STIFF])) == (3, 1)


@pytest.mark.parametrize("stl", [False, True])
def test_advi_replayed_blocks_allocate_nothing(cuda, stl):
    """On the runner's chained route a replayed full block makes no device
    allocation, and a tensor a caller holds is never written by a later
    block or fit."""
    from gsmvi_tpu_torch import ADVI
    from gsmvi_tpu_torch.ops import advi_fused as af

    b, d, spc = 32, 256, 8
    mean_t, prec, loc, l, ainv, block = _advi_inputs(cuda, b, d, spc, seed=5)
    z, zz = torch.zeros(d, device=cuda), torch.zeros((d, d), device=cuda)
    lrs, bc1s, bc2s = af.lr_bias_arrays(lambda s: 1e-3, 0.9, 0.999,
                                        torch.arange(spc, dtype=torch.int32))
    make = (af.make_fused_advi_stl_multistep if stl
            else af.make_fused_advi_multistep)
    step = make(fs.gaussian_score, 2, b, d, spc)
    step.load(loc, l, *([ainv] if stl else []), z, z, zz, zz)
    step.eps_block(cuda).copy_(block)
    step.run(lrs, bc1s, bc2s, spc, mean_t, prec)          # captures
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(10):
        step.run(lrs, bc1s, bc2s, spc, mean_t, prec)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
    if stl:
        assert int(step.report()[af.REP_NDONE]) == spc
    t = dense_gaussian(3, 64, scale=0.5, device=cuda)
    g = ADVI(64, t.lp, fused_score=t.fused_score, steps_per_call=8,
             device="cuda")
    est = "stl" if stl else "analytic"
    s1, _ = g.fit_fused(0, learning_rate=1e-3, niter=23, batch_size=16,
                        verbose=False, return_state=True, estimator=est)
    held = [x.clone() for x in s1[:-2]]
    s2, _ = g.fit_fused(0, learning_rate=1e-3, niter=23, batch_size=16,
                        verbose=False, return_state=True, state=s1,
                        estimator=est)
    g.fit_fused(1, learning_rate=1e-3, niter=40, batch_size=16,
                verbose=False, estimator=est)
    torch.cuda.synchronize()
    assert all(torch.equal(x, h) for x, h in zip(s1[:-2], held))
    assert not torch.equal(s2.l, s1.l)


@pytest.mark.parametrize("name", ["funnel", "banana", "student_t",
                                  "mixture", "logreg"])
def test_advi_zoo_scores_are_captured_in_the_k9_graph(cuda, name):
    """fit_fused on each zoo target's score: its K9 blocks are captured
    (the score inside the graph) and the fit equals the eager fit bit for
    bit."""
    from gsmvi_tpu_torch import ADVI, models

    d = 64
    t = {"funnel": lambda: models.funnel(d, device=cuda),
         "banana": lambda: models.banana(d, device=cuda),
         "student_t": lambda: models.student_t(0, d, df=6.0, device=cuda),
         "mixture": lambda: models.gaussian_mixture(0, d, device=cuda),
         "logreg": lambda: models.logistic_regression(0, d, device=cuda)}[
        name]()
    states = []
    for graph in (True, False):
        g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=8,
                 device="cuda", cuda_graph=graph)
        states.append(g.fit_fused(0, learning_rate=1e-2, niter=40,
                                  batch_size=16, verbose=False,
                                  return_state=True)[0])
        if graph:
            runner = g._fused_runner(16, 1e-2, 0.9, 0.999, 1e-8, "analytic")
            assert len(runner.blocks.captures) == 1
    for x, y in zip(states[0][:-2], states[1][:-2]):
        assert bool(torch.isfinite(x).all()) and torch.equal(x, y)


def test_advi_fit_fused_raises_outside_the_kernel_range(cuda):
    """On the card fit_fused runs K9/K10 or raises; fit is plain torch."""
    from gsmvi_tpu_torch import ADVI, Adam

    d = 64
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = ADVI(d, t.lp, fused_score=t.fused_score, device="cuda")
    with pytest.raises(ValueError, match="ADVI CUDA kernels take B"):
        g.fit_fused(0, batch_size=65537, niter=2, verbose=False)
    with pytest.raises(NotImplementedError, match="float32"):
        ADVI(d, t.lp, fused_score=t.fused_score, device="cuda",
             dtype=torch.float64).fit_fused(0, batch_size=16, niter=2,
                                            verbose=False)
    fs.reset_launch_counts()
    mean, cov, losses = g.fit(0, Adam(1e-2), batch_size=96, niter=2,
                              verbose=False)
    assert mean.is_cuda and len(losses) == 3
    assert sum(fs.launch_counts().values()) == 0


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_advi_fit_fused_runs_through_the_kernels(cuda, estimator):
    """fit_fused on CUDA launches K9 (analytic) or K10 (STL) and K3, and
    its trajectory does not depend on spc."""
    from gsmvi_tpu_torch import ADVI

    d, b, niter = 64, 16, 40
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    fs.reset_launch_counts()
    states = []
    for spc in (1, 8):
        g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=spc,
                 device="cuda")
        states.append(g.fit_fused(0, learning_rate=1e-3, batch_size=b,
                                  niter=niter, verbose=False,
                                  return_state=True, estimator=estimator)[0])
    counts = fs.launch_counts()
    k9, k10 = (counts["make_fused_advi_multistep"],
               counts["make_fused_advi_stl_multistep"])
    assert (k9 > 0 and k10 == 0) if estimator == "analytic" else (k10 > 0)
    assert counts["gaussian_score"] >= 2 * (niter + 1)
    for a, c in zip(states[0][:-2], states[1][:-2]):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# K5 gsm_update_fused (the dense route) and K6 make_fused_eps_batch_multistep
# ---------------------------------------------------------------------------

def _dense_inputs(dev, b, d, seed=0, k=None):
    """(samples, vs, mu0, S0) of a dense GSM step, S0 exactly symmetric; a
    leading replica axis with ``k``."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    a = rng.standard_normal((*lead, d, d))
    s0 = (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)
    s0 = 0.5 * (s0 + np.swapaxes(s0, -1, -2))
    mu = rng.standard_normal((*lead, d))
    x = mu[..., None, :] + rng.standard_normal((*lead, b, d))
    v = -(x - rng.standard_normal((*lead, 1, d)))
    return [torch.from_numpy(np.ascontiguousarray(z, np.float32)).to(dev)
            for z in (x, v, mu, s0)]


DENSE_CASES = sorted({(b, d) for b in (1, 2, 31, 32, 33, 129, 512, 2048)
                      for d in (1, 7, 33, 200, 256, 1024)}
                     | {(2, 16), (8, 200), (96, 1024)})


@pytest.mark.parametrize("b,d", DENSE_CASES)
def test_dense_kernel_matches_plain(cuda, b, d):
    """K5 against gsm_update on the same tensors, within 1e-5 * max(1, |S|)
    (float32, sums in other orders), with S symmetric bit for bit."""
    from gsmvi_tpu_torch.ops import gsm_step

    x, v, mu, s0 = _dense_inputs(cuda, b, d, seed=b + d)
    m_k, s_k = gsm_step.gsm_update_fused(x, v, mu, s0)
    m_p, s_p = gsm_step.gsm_update_replicas_reference(x, v, mu, s0)
    assert _within(m_k, m_p, 1e-5) and _within(s_k, s_p, 1e-5)
    assert torch.equal(s_k, s_k.T)


@pytest.mark.parametrize("k,b,d", [(4, 32, 200), (1, 32, 256), (3, 32, 256),
                                   (8, 32, 256), (1, 512, 256),
                                   (3, 512, 256), (8, 512, 256), (3, 33, 7)])
def test_dense_kernel_batched_equals_single_calls(cuda, k, b, d):
    from gsmvi_tpu_torch.ops import gsm_step

    x, v, mu, s0 = _dense_inputs(cuda, b, d, seed=5 + k, k=k)
    m_k, s_k = gsm_step.gsm_update_fused(x, v, mu, s0)
    for i in range(k):
        m_i, s_i = gsm_step.gsm_update_fused(x[i], v[i], mu[i], s0[i])
        assert torch.equal(m_k[i], m_i) and torch.equal(s_k[i], s_i)
        assert torch.equal(s_k[i], s_k[i].T)


@pytest.mark.parametrize("b,d", [(32, 256), (512, 256), (33, 7)])
def test_dense_kernel_propagates_a_nonfinite_row(cuda, b, d):
    """An inf in one row of v: K5's mu and S are non-finite exactly where
    the plain version's are (nothing clamped), so accept_or_revert
    reverts the step."""
    from gsmvi_tpu_torch.ops import gsm_step
    from gsmvi_tpu_torch.state import accept_or_revert, init_state

    x, v, mu, s0 = _dense_inputs(cuda, b, d, seed=11)
    v[b // 2, d // 3] = float("inf")
    m_k, s_k = gsm_step.gsm_update_fused(x, v, mu, s0)
    m_p, s_p = gsm_step.gsm_update_replicas_reference(x, v, mu, s0)
    assert not bool(torch.isfinite(s_p).all())
    assert torch.equal(torch.isfinite(m_k), torch.isfinite(m_p))
    assert torch.equal(torch.isfinite(s_k), torch.isfinite(s_p))
    st = init_state(0, d, mean=mu, cov=s0, device=cuda)
    new = accept_or_revert(st, m_k, s_k)
    assert int(new.n_rejected) == 1 and torch.equal(new.cov, st.cov)


@pytest.mark.parametrize("b,k", [(32, None), (512, None), (32, 8)])
def test_dense_kernel_is_two_launches_without_scratch(cuda, b, k):
    """Per call on the card: two kernels (the thin product with the row
    dot products, the Gram) and two allocations (the outputs mu and S)."""
    from gsmvi_tpu_torch.ops import gsm_step
    from tools.profile_gpu import profile_calls

    x, v, mu, s0 = _dense_inputs(cuda, b, 256, seed=3, k=k)
    rec = profile_calls("K5", lambda: gsm_step.gsm_update_fused(x, v, mu, s0),
                        10, torch, quiet=True)
    assert rec["allocations_per_call"] == 2
    assert rec["host_launches_per_call"] == 2
    # Two kernels a call; the profiler may drop a device record, never add
    # one.
    per = rec["launches_by_kernel"]
    assert len(per) == 2
    for kernel in ("thin_kernel", "gram_kernel"):
        assert 9 <= sum(c for n, c in per.items() if kernel in n) <= 10


def test_dense_fit_batch_replicas_equal_single_fits(cuda):
    """The dense fit_batch at K=8 (batched K5): replica i against
    fit(seed_i).  K5 gives each replica the bits of its single call; the
    step's other operations (the draws' and the score's products, the
    batched Cholesky of accept_or_revert) are the library's, which does
    not promise a batch the bits of its single calls, so the moments are
    held to 1e-4 * max(1, |x|) and the accept counts to equality."""
    d, b, niter = 256, 32, 30
    t = dense_gaussian(0, d, device=cuda)
    g = GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False)
    fs.reset_launch_counts()
    st = g.fit_batch(range(8), batch_size=b, niter=niter, return_state=True)
    assert fs.launch_counts()["gsm_update_fused"] == niter + 1
    for i in range(8):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert _within(st.mean[i], si.mean, 1e-4)
        assert _within(st.cov[i], si.cov, 1e-4)
        assert int(st.n_accepted[i]) == int(si.n_accepted)


def _batch_problem(dev, k, b, d, spc, seed=0):
    t = dense_gaussian(0, d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((k, spc * b, d), generator=gen, device=dev)
    means = torch.zeros((k, d), device=dev)
    factors = torch.eye(d, device=dev).repeat(k, 1, 1)
    return t, blocks, means, factors


@pytest.mark.parametrize("case", ["full", "nmax_lt_spc", "one_rejected"])
def test_batch_kernel_matches_plain(cuda, case):
    """K6 against its plain version at K=4: equal accepted counts; a
    replica whose draws the gates reject at one sub-step leaves the others
    untouched (each equals its own single K2 call bit for bit)."""
    from gsmvi_tpu_torch.ops import batch_fused as bfm

    k, b, d, spc = 4, 32, 256, 8
    t, blocks, means, factors = _batch_problem(cuda, k, b, d, spc)
    score_fn, params = t.fused_score
    nmax = 3 if case == "nmax_lt_spc" else spc
    if case == "one_rejected":
        ladder = torch.logspace(0.0, 3.0, b, device=cuda)[:, None]
        blocks[2, 4 * b:5 * b] *= ladder
    step = bfm.make_fused_eps_batch_multistep(score_fn, len(params), b, d, k,
                                              spc)
    m_k, f_k, n_k = step(nmax, blocks, means, factors, *params)
    m_p, f_p, n_p = bfm.eps_batch_multistep_reference(
        fs.gaussian_score_reference, params, nmax, blocks, means, factors,
        batch=b)
    want = [nmax] * k
    if case == "one_rejected":
        want[2] = nmax - 1
    assert n_k.tolist() == n_p.tolist() == want
    assert float((m_k - m_p).abs().max()) <= 1e-4
    assert float((f_k - f_p).abs().max()) <= 1e-4 * float(f_p.abs().max())
    single = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    for i in range(k):
        m_i, f_i, n_i = single(nmax, blocks[i], means[i], factors[i],
                               *params)
        assert torch.equal(m_k[i], m_i) and torch.equal(f_k[i], f_i)
        assert int(n_i) == want[i]


def test_batched_update_kernel_equals_single_calls(cuda):
    """Batched K1 (the fit_batch "auto" route): replica i equals a call on
    replica i alone, bit for bit, including a rejected replica."""
    ins = [_inputs(cuda, 32, 256, seed=i, decades=3.0 if i == 1 else 0.0)
           for i in range(3)]
    eps, v, mu, f = (torch.stack(z) for z in zip(*ins))
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    assert g_k.tolist() == [True, False, True]
    for i in range(3):
        m_i, f_i, g_i = fs.gsm_eps_update_fused(*ins[i])
        assert torch.equal(m_k[i], m_i) and torch.equal(f_k[i], f_i)
        assert bool(g_i) == bool(g_k[i])


def test_fit_batch_replica_equals_single_fit(cuda):
    """FactorGSM.fit_batch(small_solver="fused") on K6: every replica is the
    same-seed single fit on K2, bit for bit; the "auto" route (batched K1)
    and the dense route (batched K5) launch their kernels."""
    from gsmvi_tpu_torch.ops import batch_fused as bfm  # noqa: F401
    from gsmvi_tpu_torch.ops import gsm_step  # noqa: F401

    d, b, niter = 64, 16, 45
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device="cuda")
    fs.reset_launch_counts()
    st = g.fit_batch(range(3), batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    counts = fs.launch_counts()
    assert counts["make_fused_eps_batch_multistep"] == 6
    assert counts["make_fused_eps_multistep"] == 0
    for i in range(3):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(st.mean[i], si.mean)
        assert torch.equal(st.factor[i], si.factor)
        assert int(st.n_accepted[i]) == int(si.n_accepted)
    fs.reset_launch_counts()
    GSM(d, t.lp, t.lp_g, device="cuda").fit_batch(range(3), batch_size=b,
                                                  niter=niter)
    GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False).fit_batch(
        range(3), batch_size=b, niter=niter)
    counts = fs.launch_counts()
    assert counts["gsm_eps_update_fused"] == niter + 1
    assert counts["gsm_update_fused"] == niter + 1


def test_dense_and_batch_fitters_raise_outside_the_kernel_range(cuda):
    """On the card the dense route runs K5 or raises (dtype), fit_batch
    "fused" raises without fused_score or outside K6's range; the plain
    routes stay available (use_fused=False, small_solver="chol")."""
    from gsmvi_tpu_torch.ops import gsm_step  # noqa: F401

    d = 64
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False,
            dtype=torch.float64).fit(0, batch_size=8, niter=2, verbose=False)
    with pytest.raises(ValueError, match=r"D in \[1, 8192\]"):
        GSM(8193, t.lp, t.lp_g, device="cuda", use_factor=False).fit(
            0, batch_size=8, niter=2, verbose=False)
    with pytest.raises(ValueError, match="fused_score"):
        FactorGSM(d, t.lp, t.lp_g, device="cuda").fit_batch(
            range(2), batch_size=16, niter=2, small_solver="fused")
    with pytest.raises(ValueError, match="CUDA kernels take B"):
        FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  device="cuda").fit_batch(range(2), batch_size=513, niter=2,
                                           small_solver="fused")
    fs.reset_launch_counts()
    mean, _ = GSM(d, t.lp, t.lp_g, device="cuda", use_factor=False,
                  use_fused=False).fit(0, batch_size=8, niter=2,
                                       verbose=False)
    means, _ = FactorGSM(d, t.lp, t.lp_g, device="cuda").fit_batch(
        range(2), batch_size=96, niter=2, small_solver="chol")
    assert mean.is_cuda and means.is_cuda
    assert sum(fs.launch_counts().values()) == 0
    huge = GSM(d, t.lp, t.lp_g, device="cuda")
    assert not huge._factor_route(128) and huge._dense_fused(128)


# ---------------------------------------------------------------------------
# K4 make_fused_eps_step, K4a gsm_eps_update_fused(method="chol"), Philox,
# and the audits.  A whole ns step within 1e-4 (the score's rounding enters
# the update).  The chol variant factors a jittered, nearly singular Gram on
# the dense target from (0, I), so as in chip_smoke.py it is held to the
# larger of 1e-4 on the mean and 2e-4 * max|S| on S = F F^T (the JAX
# package's chol-kernel bound, tests/test_pallas.py) and 4x the plain
# float32 version's own distance from float64 on the same input.
# ---------------------------------------------------------------------------

def _chol_within(k, p, p64):
    cov = lambda f: f.double() @ f.double().T
    s_p = cov(p[1])
    mean_tol = max(1e-4, 4 * float((p[0].double() - p64[0]).abs().max()))
    cov_tol = max(2e-4 * max(1.0, float(s_p.abs().max())),
                  4 * float((s_p - cov(p64[1])).abs().max()))
    return (float((k[0] - p[0]).abs().max()) <= mean_tol
            and float((cov(k[1]) - s_p).abs().max()) <= cov_tol)


@pytest.mark.parametrize("method", ["ns", "chol"])
@pytest.mark.parametrize("b,d", [(8, 200), (32, 256), (33, 256), (64, 256)])
def test_eps_step_kernel_matches_plain(cuda, b, d, method):
    t = dense_gaussian(0, d, device=cuda)
    score_fn, params = t.fused_score
    gen = torch.Generator(device=cuda).manual_seed(b + d)
    e = torch.randn((b, d), generator=gen, device=cuda)
    mean0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    step = fs.make_fused_eps_step(score_fn, len(params), b, d,
                                  external_eps=True, method=method)
    fs.reset_launch_counts()
    m_k, f_k, g_k = step(e, mean0, f0, *params)
    assert fs.launch_counts()["make_fused_eps_step"] == 1
    m_p, f_p, g_p = fs.eps_step_reference(fs.gaussian_score_reference,
                                          params, e, mean0, f0,
                                          method=method)
    assert bool(g_k) and bool(g_p)
    if method == "ns":
        assert float((m_k - m_p).abs().max()) <= 1e-4
        assert float((f_k - f_p).abs().max()) <= 1e-4 * float(
            f_p.abs().max())
    else:
        p64 = fs.eps_step_reference(
            fs.gaussian_score_reference, [x.double() for x in params],
            e.double(), mean0.double(), f0.double(), method=method)
        assert _chol_within((m_k, f_k), (m_p, f_p), p64)


@pytest.mark.parametrize("b,d", [(8, 16), (8, 200), (12, 200), (32, 256),
                                 (33, 256), (64, 1024)])
def test_chol_update_kernel_matches_plain(cuda, b, d):
    """Odd B included: at B=33 each substitution column's lane group (8
    lanes) leaves part of a warp idle, which must still join the shuffles."""
    eps, v, mu, f = _inputs(cuda, b, d, seed=7 * b + d)
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f, method="chol")
    m_p, f_p, g_p = fs.gsm_eps_update_chol_reference(eps, v, mu, f)
    assert bool(g_k) and bool(g_p)
    p64 = fs.gsm_eps_update_chol_reference(
        *[x.double() for x in (eps, v, mu, f)])
    assert _chol_within((m_k, f_k), (m_p, f_p), p64)


@pytest.mark.parametrize("b", [1, 8, 32, 33, 64])
def test_chol_update_kernel_over_the_batch_range(cuda, b):
    """K4a at each tile of its one cluster launch (T = 4 up to B = 32, 8
    above) and its ends: one ``gsmvi_eps_chol`` after the three thin
    products (ef, vf, t), within the chol tolerance of the plain version."""
    d = 256
    eps, v, mu, f = _inputs(cuda, b, d, seed=11 * b)
    fs.reset_launch_counts()
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f, method="chol")
    counts = fs.launch_counts()
    assert counts["gsm_eps_update_fused"] == 1 and counts["thin_product"] == 3
    m_p, f_p, g_p = fs.gsm_eps_update_chol_reference(eps, v, mu, f)
    assert bool(g_k) and bool(g_p)
    p64 = fs.gsm_eps_update_chol_reference(
        *[x.double() for x in (eps, v, mu, f)])
    assert _chol_within((m_k, f_k), (m_p, f_p), p64)


@pytest.mark.parametrize("case", ["indefinite", "nan_score"])
@pytest.mark.parametrize("b", [8, 32, 64])
def test_chol_kernel_rejects_like_plain(cuda, b, case):
    """K indefinite in float32 (draws at 1e4 with v = e) and a NaN score:
    good = 0 on the kernel and the plain version, the old state kept."""
    d = 256
    eps, v, mu, f = _inputs(cuda, b, d, seed=b)
    if case == "indefinite":
        eps = 1e4 * eps
        v, mu, f = eps.clone(), torch.zeros_like(mu), torch.eye(d,
                                                                device=cuda)
    else:
        v[b // 2, 7] = float("nan")
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f, method="chol")
    _, _, g_p = fs.gsm_eps_update_chol_reference(eps, v, mu, f)
    assert not bool(g_k) and not bool(g_p)
    assert torch.equal(m_k, mu) and torch.equal(f_k, f)
    if case == "nan_score":
        m_n, f_n, g_n = fs.gsm_eps_update_fused(eps, v, mu, f)
        assert not bool(g_n) and torch.equal(f_n, f)


def test_philox_kernel_matches_plain(cuda):
    """Words bit for bit (the known answer at counter 0, key 0 included),
    normals within 4 ulp, and the on-card-draw step on the same draw."""
    assert fs.philox4x32(1, 0, 0, device=cuda)[0].tolist() == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    n_blocks = 3 * 4096 + 5
    words = fs.philox4x32(n_blocks, 99, fs.PHILOX_KEY1, device=cuda)
    assert torch.equal(words, fs.philox4x32_reference(
        fs._philox_counters(n_blocks, cuda), 99, fs.PHILOX_KEY1))
    z = fs.philox_normal(99, 37, 201, device=cuda)
    z_p = fs.philox_normal_reference(99, 37, 201, device=cuda)
    bits = lambda x: x.view(torch.int32).to(torch.int64)
    assert torch.equal(torch.sign(z), torch.sign(z_p))
    assert int((bits(z) - bits(z_p)).abs().max()) <= 4


def test_spc1_route_runs_k4_once_per_step(cuda):
    d, b, niter = 64, 16, 40
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=1, device="cuda")
    fs.reset_launch_counts()
    g.fit(0, batch_size=b, niter=niter, verbose=False)
    counts = fs.launch_counts()
    assert counts["make_fused_eps_step"] == niter + 1
    assert counts["make_fused_eps_multistep"] == 0


def test_audited_fits_equal_unaudited(cuda):
    """FactorGSM (K2, K4 audits) and FactorBaM (K8, K7 audits): the audited
    fit ends in the unaudited fit's state bit for bit, with one kernel call
    per audit and no warning."""
    import warnings

    from gsmvi_tpu_torch import FactorBaM, Regularizers

    d, b, niter, every = 64, 16, 200, 50
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    regf = Regularizers().linear(20.0)
    fits = {
        "gsm": (lambda: FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                                  device="cuda"),
                lambda g, **kw: g.fit(0, batch_size=b, niter=niter,
                                      verbose=False, return_state=True,
                                      **kw),
                "make_fused_eps_step"),
        "bam": (lambda: FactorBaM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                                  device="cuda"),
                lambda g, **kw: g.fit(0, regf, batch_size=b, niter=niter,
                                      verbose=False, retries=0,
                                      return_state=True, **kw),
                "bam_eps_update_fused"),
    }
    for name, (make, run, kernel) in fits.items():
        plain = run(make())
        g = make()
        fs.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*audit")
            audited = run(g, audit_every=every)
        assert fs.launch_counts()[kernel] == niter // every, name
        assert [r["i"] for r in g.audit_log] == [50, 100, 150, 200], name
        assert torch.equal(audited.mean, plain.mean), name
        assert torch.equal(audited.factor, plain.factor), name


# ---------------------------------------------------------------------------
# The kernels' shape ranges: B from 1 (the reference examples) to 512 on the
# eps kernels (the row-panel small space at B 65-128, the grid one above)
# and 128 on BaM (the row-panel small space above B=56).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d", [(1, 1), (2, 10), (3, 5), (7, 16),
                                 (65, 64), (128, 256), (129, 33), (200, 1),
                                 (256, 256), (512, 256), (512, 1024)])
def test_update_and_multistep_kernels_match_plain_over_the_range(cuda, b, d):
    from gsmvi_tpu_torch.models import ill_conditioned_gaussian

    eps, v, mu, f = _inputs(cuda, b, d, seed=b + d)
    fs.reset_launch_counts()
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    counts = fs.launch_counts()
    assert counts["eps_smallspace_panel"] == int(64 < b <= 128)
    assert counts["eps_smallspace_large"] == int(b > 128)
    m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f)
    assert bool(g_k) == bool(g_p)
    assert float((m_k - m_p).abs().max()) <= 1e-5
    assert float((f_k - f_p).abs().max()) <= 1e-5 * float(f.abs().max())
    t = ill_conditioned_gaussian(0, d, 10.0, device=cuda)
    score_fn, params = t.fused_score
    spc = 8
    block = torch.randn((spc * b, d), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(b))
    step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    m0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    m_k, f_k, n_k = step(spc, block, m0, f0, *params)
    m_p, f_p, n_p = fs.eps_multistep_reference(
        fs.gaussian_score_reference, params, spc, block, m0, f0, batch=b)
    assert int(n_k) == int(n_p)
    assert float((m_k - m_p).abs().max()) <= 1e-4
    assert float((f_k - f_p).abs().max()) <= 1e-4 * float(f_p.abs().max())


def test_large_batch_replicas_equal_single_calls(cuda):
    """The row-panel small space takes K1's replica axis: batched K1 at
    B=96 equals its single calls bit for bit, and fit_batch "fused" (K6)
    at B=96 equals the single K2 fits."""
    ins = [_inputs(cuda, 96, 128, seed=i) for i in range(2)]
    eps, v, mu, f = (torch.stack(z) for z in zip(*ins))
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    for i in range(2):
        m_i, f_i, g_i = fs.gsm_eps_update_fused(*ins[i])
        assert torch.equal(m_k[i], m_i) and torch.equal(f_k[i], f_i)
        assert bool(g_i) == bool(g_k[i])
    d, b, niter = 64, 96, 20
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device="cuda")
    st = g.fit_batch(range(2), batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    for i in range(2):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(st.mean[i], si.mean)
        assert torch.equal(st.factor[i], si.factor)


@pytest.mark.parametrize("b,d", [(1, 16), (2, 256), (60, 100), (128, 256)])
def test_bam_update_kernel_matches_plain_over_the_range(cuda, b, d):
    from gsmvi_tpu_torch.ops import bam_fused as bf

    e, v, mu, f = _bam_inputs(cuda, b, d, seed=b + d, v_scale=0.05)
    fs.reset_launch_counts()
    k = bf.bam_eps_update_fused(e, v, mu, f, 0.5)
    assert fs.launch_counts()["bam_smallspace_panel"] == int(b > 56)
    p = bf.bam_eps_update_ns_reference(e, v, mu, f, 0.5)
    assert (bool(k[2]), bool(k[3])) == (bool(p[2]), bool(p[3]))
    assert np.allclose(k[4].tolist(), p[4].tolist(), rtol=1e-3, atol=0)
    assert _within(k[0], p[0], 1e-5) and _within(k[1], p[1], 1e-5)


def test_example_configurations_run_on_the_kernels(cuda):
    """The reference examples' shapes with the fitters' defaults: GSM(10)
    (B=2) runs K1 once per step, BaM(5, use_lowrank=True) at B=2 runs K7,
    GSM(16) at B=1 runs K1; the moments come out finite (chip_smoke.py
    phase 18 bounds them)."""
    from gsmvi_tpu_torch import BaM, Regularizers

    for d, seed, b in ((10, 3, 2), (16, 11, 1)):
        t = dense_gaussian(seed, d, device=cuda)
        fs.reset_launch_counts()
        kw = {} if b == 2 else {"batch_size": b}
        mean, cov = GSM(d, t.lp, t.lp_g, device="cuda").fit(
            0, niter=500, verbose=False, **kw)
        assert fs.launch_counts()["gsm_eps_update_fused"] == 501
        assert bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())
    t = dense_gaussian(5, 5, device=cuda)
    fs.reset_launch_counts()
    mean, cov = BaM(5, t.lp, t.lp_g, use_lowrank=True, device="cuda").fit(
        0, Regularizers().custom(lambda i: 100 / (1 + i)), niter=100,
        batch_size=2, verbose=False)
    assert fs.launch_counts()["bam_eps_update_fused"] >= 101
    assert bool(torch.isfinite(mean).all() and torch.isfinite(cov).all())


def _score_tol(plain, x, params, rel):
    """rel * max(1, max|v|) of the plain version's v; for the mixture at
    least 8x the plain float32 version's distance from float64 (its logits
    cancel terms ~1e3, chip_smoke.py's ZOO_FLOOR)."""
    v_p = plain(x, *params)
    tol = rel * max(1.0, float(v_p.abs().max()))
    if plain is fs.mixture_score_reference:
        v64 = plain(x.double(), *(p.double() for p in params))
        tol = max(tol, 8.0 * float((v_p.double() - v64).abs().max()))
    return v_p, tol


@pytest.mark.parametrize("name", ["funnel", "banana", "student_t",
                                  "mixture", "logreg"])
@pytest.mark.parametrize("b,d", [(32, 256), (3, 10)])
def test_zoo_score_kernels_match_plain(cuda, name, b, d):
    from gsmvi_tpu_torch import models

    make = {"student_t": lambda: models.student_t(0, d, df=6.0, device=cuda),
            "mixture": lambda: models.gaussian_mixture(0, d, device=cuda),
            "logreg": lambda: models.logistic_regression(0, d, device=cuda)}
    t = make.get(name, lambda: getattr(models, name)(d, device=cuda))()
    score_fn, params = t.fused_score
    rng = np.random.default_rng(b + d)
    x = rng.standard_normal((b, d)).astype(np.float32)
    x[:, 0] = rng.uniform(-3.0, 3.0, b)
    x = torch.from_numpy(x).to(cuda)
    fs.reset_launch_counts()
    v_k = score_fn(x, *params)
    assert fs.launch_counts()[f"{name}_score"] == 1
    v_p, tol = _score_tol(getattr(fs, f"{name}_score_reference"), x, params,
                          1e-4 if name == "student_t" else 1e-5)
    assert float((v_k - v_p).abs().max()) <= tol


@pytest.mark.parametrize("b,d", [(512, 1024), (256, 256), (1, 2), (5, 3),
                                 (7, 1027), (3, 8192)])
def test_banana_kernel_over_its_row_mappings(cuda, b, d):
    """Banana at the large shapes (the two-phase bulk's (512, 1024), K6's
    (256, 256)), at D < 4 and at a ragged D (scalar loads and stores), and
    where a row's threads walk several chunks (D = 8192): one launch,
    within 1e-5 * max(1, max|v|) of the plain version."""
    from gsmvi_tpu_torch import models

    score_fn, params = models.banana(d, device=cuda).fused_score
    x = torch.from_numpy(np.random.default_rng(b + d).standard_normal(
        (b, d)).astype(np.float32)).to(cuda)
    fs.reset_launch_counts()
    v_k = score_fn(x, *params)
    assert fs.launch_counts()["banana_score"] == 1
    v_p, tol = _score_tol(fs.banana_score_reference, x, params, 1e-5)
    assert float((v_k - v_p).abs().max()) <= tol


@pytest.mark.parametrize("case", ["padded K=8", "K=1024", "N=1", "N=4096",
                                  "saturated"])
def test_k11b_kernels_at_their_edges(cuda, case):
    """The mixture on the JAX target's padded K=8 (five -1e30 rows) and at
    K=1024, logreg at N=1, N=4096 and on rows with |z| > 100: finite and
    equal to the plain version; K=1025 raises."""
    from gsmvi_tpu_torch import models

    rng = np.random.default_rng(1)
    d = 10 if case in ("K=1024", "N=4096") else 256
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    x = x.to(cuda)
    if case == "padded K=8":
        means = models.gaussian_mixture(0, d, device="cpu").fused_score[1][0]
        pad = torch.cat([means, means[:1].expand(5, d)]).to(cuda)
        mask = torch.tensor([[0.0] * 3 + [-1e30] * 5], device=cuda)
        fn, params = fs.mixture_score, (pad, mask)
    elif case == "K=1024":
        fn, params = models.gaussian_mixture(
            0, d, n_components=1024, device=cuda).fused_score
    else:
        n = {"N=1": 1, "N=4096": 4096, "saturated": 200}[case]
        fn, params = models.logistic_regression(0, d, n_data=n,
                                                device=cuda).fused_score
        if case == "saturated":
            x = 400.0 * x
            assert bool(((x @ params[0].T).abs() > 100).any())
    v_k = fn(x, *params)
    v_p, tol = _score_tol(getattr(fs, f"{fn.__name__}_reference"), x, params,
                          1e-5)
    assert bool(torch.isfinite(v_k).all())
    assert float((v_k - v_p).abs().max()) <= tol
    if case == "K=1024":
        means = torch.zeros((1025, d), device=cuda)
        with pytest.raises(ValueError, match="K in"):
            fs.mixture_score(x, means, torch.zeros((1, 1025), device=cuda))


# ---------------------------------------------------------------------------
# The product scores' one-launch kernels (zoo_student_t.cu, zoo_logreg.cu):
# a row's score does not depend on the row count M (also the funnel's and the
# mixture's), K6's replicas equal the single fits, one kernel and one
# allocation a call with the scratch held, logreg's two routes (resid in
# shared memory or in L2) give the same bits, and a captured call replays
# the eager bits.
# ---------------------------------------------------------------------------

def _product_score(name, d, dev, n_data=200):
    from gsmvi_tpu_torch import models

    if name == "student_t":
        return models.student_t(0, d, df=6.0, device=dev).fused_score
    if name == "funnel":
        return models.funnel(d, device=dev).fused_score
    if name == "mixture":
        return models.gaussian_mixture(0, d, device=dev).fused_score
    return models.logistic_regression(0, d, n_data=n_data,
                                      device=dev).fused_score


@pytest.mark.parametrize("name", ["student_t", "logreg", "funnel",
                                  "mixture"])
@pytest.mark.parametrize("k,b,d", [(4, 32, 256), (8, 3, 10), (3, 33, 257)])
def test_product_scores_rows_do_not_depend_on_m(cuda, name, k, b, d):
    """A (K B)-row call equals K separate B-row calls bit for bit, as K6's
    stacked replicas need."""
    fn, params = _product_score(name, d, cuda)
    gen = torch.Generator(device=cuda).manual_seed(k * b + d)
    x = torch.randn((k * b, d), generator=gen, device=cuda)
    whole = fn(x, *params)
    parts = torch.cat([fn(x[i * b:(i + 1) * b], *params) for i in range(k)])
    assert bool(torch.isfinite(whole).all()) and torch.equal(whole, parts)


@pytest.mark.parametrize("name,k", [("student_t", 3), ("logreg", 3),
                                    ("funnel", 8), ("mixture", 8)])
def test_zoo_fit_batch_replicas_equal_single_fits(cuda, name, k):
    """FactorGSM.fit_batch(small_solver="fused") on a zoo score: K6 calls
    the score on the K replicas' B rows stacked, and every replica is the
    same-seed single fit, bit for bit."""
    from gsmvi_tpu_torch import models

    d, b, niter = 64, 16, 45
    t = {"student_t": lambda: models.student_t(0, d, df=6.0, device=cuda),
         "logreg": lambda: models.logistic_regression(0, d, device=cuda),
         "funnel": lambda: models.funnel(d, device=cuda),
         "mixture": lambda: models.gaussian_mixture(0, d, device=cuda)}[name]()
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device="cuda")
    fs.reset_launch_counts()
    st = g.fit_batch(range(k), batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    assert fs.launch_counts()[f"{name}_score"] == niter + 1
    for i in range(k):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(st.mean[i], si.mean)
        assert torch.equal(st.factor[i], si.factor)
        assert int(st.n_accepted[i]) == int(si.n_accepted)


@pytest.mark.parametrize("name", ["student_t", "logreg"])
def test_product_scores_are_one_kernel_and_hold_their_scratch(cuda, name):
    """One kernel a call on the device, one allocation (v), the scratch
    held from call to call and the Student-t tickets back to 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, params = _product_score(name, 256, cuda)
    x = torch.randn((32, 256), device=cuda)
    fn(x, *params)
    torch.cuda.synchronize()
    held = dict(fs._ZOO_SCRATCH)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(4):
        fn(x, *params)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 4
    assert fs._ZOO_SCRATCH == held
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fn(x, *params)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel = {"student_t": "student_t_kernel", "logreg": "logreg_kernel"}[name]
    assert 1 <= len(names) <= 4 and all(kernel in n for n in names)
    if name == "student_t":
        _, ticket = fs._ZOO_SCRATCH[("student_t", x.device, 32, 256)]
        assert int(ticket.abs().sum()) == 0


@pytest.mark.parametrize("n,d", [(1, 256), (200, 256), (4096, 10)])
def test_logreg_routes_give_the_same_bits(cuda, monkeypatch, n, d):
    fn, params = _product_score("logreg", d, cuda, n_data=n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = 3.0 * torch.randn((37, d), generator=gen, device=cuda)
    assert fs.logreg_plan(n, d)[2]
    shared = fn(x, *params)
    monkeypatch.setattr(fs, "LOGREG_SHARED_BYTES", 0)
    assert not fs.logreg_plan(n, d)[2]
    l2 = fn(x, *params)
    assert ("logreg", x.device, 37, n) in fs._ZOO_SCRATCH
    assert bool(torch.isfinite(shared).all()) and torch.equal(shared, l2)


def test_logreg_beyond_the_shared_route_matches_plain(cuda):
    """N=16384 at D=10: resid no longer fits the cluster's shared memory,
    so it goes through the L2 scratch, in one launch."""
    n, d = 16384, 10
    assert not fs.logreg_plan(n, d)[2]
    fn, params = _product_score("logreg", d, cuda, n_data=n)
    x = torch.randn((5, d), generator=torch.Generator(device=cuda)
                    .manual_seed(3), device=cuda)
    fs.reset_launch_counts()
    v_k = fn(x, *params)
    assert fs.launch_counts()["logreg_score"] == 1
    v_p, tol = _score_tol(fs.logreg_score_reference, x, params, 1e-5)
    assert bool(torch.isfinite(v_k).all())
    assert float((v_k - v_p).abs().max()) <= tol


@pytest.mark.parametrize("name", ["student_t", "logreg"])
@pytest.mark.parametrize("m", [64, 48])
def test_product_scores_replay_in_a_graph(cuda, name, m):
    """A captured call replays the eager bits, again and again: at M=64
    after an eager call (the scratch held, as the fit paths capture), at
    M=48 captured first (its scratch the capture's own)."""
    fn, params = _product_score(name, 256, cuda)
    x = torch.randn((m, 256), generator=torch.Generator(device=cuda)
                    .manual_seed(m), device=cuda)
    eager = fn(x, *params) if m == 64 else None
    out = {}
    graph, _, _ = fs._capture_graph(lambda: out.setdefault("v",
                                                           fn(x, *params)))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if eager is None:
            eager = fn(x, *params)
        assert torch.equal(out["v"], eager)


# ---------------------------------------------------------------------------
# The mixture's and funnel's one-launch kernels, spread over D
# (zoo_score_b.cu, zoo_score.cu: a row over the thin_split(D) warps of a
# block): against their plain versions
# over D 1-8192 x M 1-512 (the mixture at K 1, 3, 8 padded with -1e30 and
# 1024, the funnel also with x0 < -88), one kernel and one allocation a call
# with no scratch, and a K2 graph block equal to the eager block replay after
# replay.  Their rows' independence of M and K6's replicas: with the product
# scores' tests above.
# ---------------------------------------------------------------------------

SPLIT_DIMS = [1, 10, 256, 1024, 8192]
SPLIT_ROWS = [1, 3, 32, 512]
SPLIT_CASES = ["funnel", "funnel x0<-88", "mixture K=1", "mixture K=3",
               "mixture K=8 padded", "mixture K=1024"]
SPLIT_KERNELS = {"funnel": "funnel_score_kernel",
                 "mixture": "mixture_score_kernel"}


def _split_score(case, d, dev):
    """(score, params) of a funnel or mixture case at dimension ``d``."""
    from gsmvi_tpu_torch import models

    if case.startswith("funnel"):
        return models.funnel(d, device=dev).fused_score
    rng = np.random.default_rng(d)
    k = {"mixture K=1": 1, "mixture K=1024": 1024}.get(case, 3)
    means = (3.0 * rng.standard_normal((k, d))).astype(np.float32)
    logmask = None
    if case == "mixture K=8 padded":
        means = np.concatenate([means, np.repeat(means[:1], 5, axis=0)])
        logmask = np.array([[0.0] * 3 + [-1e30] * 5], np.float32)
    return models.gaussian_mixture_from_arrays(means, logmask,
                                               device=dev).fused_score


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("m", SPLIT_ROWS)
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_split_scores_match_plain(cuda, case, m, d):
    """Finite entries within chip_smoke.py's tolerances (the mixture's at
    least 8x the plain float32 version's distance from float64); with x0 <
    -88 (every third row) the kernel's infinities and NaNs stand where the
    plain version's do."""
    fn, params = _split_score(case, d, cuda)
    rng = np.random.default_rng(100 * d + m)
    x = rng.standard_normal((m, d)).astype(np.float32)
    x[:, 0] = rng.uniform(-3.0, 3.0, m)
    if case == "funnel x0<-88":
        x[::3, 0] = -90.0
    x = torch.from_numpy(x).to(cuda)
    fs.reset_launch_counts()
    v_k = fn(x, *params)
    assert sum(fs.launch_counts().values()) == 1
    v_p = getattr(fs, f"{fn.__name__}_reference")(x, *params)
    wild = ~torch.isfinite(v_p)
    assert bool(wild.any()) == (case == "funnel x0<-88")
    assert torch.equal(~torch.isfinite(v_k), wild)
    assert torch.equal(v_k[wild].nan_to_num(), v_p[wild].nan_to_num())
    ok = ~wild.any(1)
    if bool(ok.any()):
        plain = getattr(fs, f"{fn.__name__}_reference")
        v_p, tol = _score_tol(plain, x[ok], params, 1e-5)
        assert float((v_k[ok] - v_p).abs().max()) <= tol


@pytest.mark.parametrize("name", ["funnel", "mixture"])
def test_split_scores_are_one_kernel_without_scratch(cuda, name):
    """One kernel and one allocation (v) a call on the device; no scratch
    held.  (The profiler now and then returns a window with no device
    record at all; ``profile_window`` runs such a window again.)"""
    from tools.profile_gpu import profile_window

    fn, params = _split_score(name if name == "funnel" else "mixture K=3",
                              256, cuda)
    x = torch.randn((32, 256), device=cuda)
    fn(x, *params)
    torch.cuda.synchronize()
    held = dict(fs._ZOO_SCRATCH)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(4):
        fn(x, *params)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 4
    assert fs._ZOO_SCRATCH == held
    def window():
        for _ in range(4):
            fn(x, *params)
        torch.cuda.synchronize()

    names = [e.name for e in profile_window(window)[1]]
    assert 1 <= len(names) <= 4
    assert all(SPLIT_KERNELS[name] in n for n in names)


@pytest.mark.parametrize("name", ["funnel", "mixture"])
def test_split_score_k2_graph_block_equals_eager_block(cuda, name):
    """A K2 block on funnel(256) or gaussian_mixture(0, 256) replays its
    captured score launches with the eager block's bits, replay after
    replay."""
    from gsmvi_tpu_torch import models

    d, b, spc = 256, 32, 8
    t = (models.funnel(d, device=cuda) if name == "funnel"
         else models.gaussian_mixture(0, d, device=cuda))
    score_fn, params = t.fused_score
    step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    block = torch.randn((spc * b, d), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
    m0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    eager = step(spc, block, m0, f0, *params, graph=False)
    for _ in range(3):
        got = step(spc, block, m0, f0, *params)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, eager))
    assert len(step.captures) == 1
    assert bool(torch.isfinite(eager[0]).all())


# ---------------------------------------------------------------------------
# K1's cluster small space (eps_smallspace_cluster.cu) and the split-k thin
# product (thin_gemm.cu) over B 1-64, M 1-512 and D 1-8192: against their
# plain versions (1e-5 on the mean and 1e-5 * max|F| on F + su^T sw; the
# product within 1e-5 * max(1, |out|)), replica z of a K-replica launch and a
# second launch equal to the first bit for bit.
# ---------------------------------------------------------------------------

CLUSTER_B = [1, 2, 3, 31, 32, 33, 63, 64]
CLUSTER_D = [1, 10, 31, 32, 33, 256, 257, 1024, 8192]
THIN_M = [1, 2, 32, 33, 256, 512]


def _smallspace_inputs(dev, b, d, seed, decades=0.0, k=None):
    """Draws, scores and a well-conditioned factor made on the card, and the
    rows the small space reads: (e, v, vf, t, ef, mean, f)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = () if k is None else (k,)
    rnd = lambda *s: torch.randn((*lead, *s), generator=gen, device=dev)
    f = torch.eye(d, device=dev) + 0.3 * rnd(d, d) / d ** 0.5
    ladder = torch.logspace(0.0, decades, b, device=dev)[:, None]
    e = ladder * rnd(b, d)
    v = 0.3 * rnd(b, d)
    mean = rnd(d)
    vf = v @ f
    return e, v, vf, vf @ f.transpose(-1, -2), e @ f.transpose(-1, -2), \
        mean, f


@pytest.mark.parametrize("d", CLUSTER_D)
@pytest.mark.parametrize("b", CLUSTER_B)
def test_cluster_smallspace_matches_plain(cuda, b, d):
    """Benign draws, then draw rows over three decades (phase 1's
    update_reject ladder).  Where B * D is too small for the ladder to break
    the chains (D = 1, B = 2-3 at D <= 32) the update is accepted on
    near-singular Grams: there the kernel is held to the larger of 1e-5 and 8x
    the plain float32 version's own distance from the plain version in
    float64 (the rule of chip_smoke.py's mixture and chol checks)."""
    for case, decades in (("update", 0.0), ("update_reject", 3.0)):
        e, v, vf, t, ef, mean, f = _smallspace_inputs(cuda, b, d, b * d,
                                                      decades)
        fs.reset_launch_counts()
        m_k, su_k, sw_k, g_k = fs.eps_smallspace(e, v, vf, t, ef, mean)
        assert fs.launch_counts()["eps_smallspace"] == 1
        m_p, su_p, sw_p, g_p = fs.eps_smallspace_stacks_reference(
            e, v, vf, t, ef, mean[None], batch=b)
        assert bool(g_k) == bool(g_p), case
        if not bool(g_p):
            assert torch.equal(m_k, mean), case
            continue
        f_k, f_p = f + su_k.T @ sw_k, f + su_p.T @ sw_p
        mean_tol, f_tol = 1e-5, 1e-5 * float(f.abs().max())
        if case == "update_reject":
            m_d, su_d, sw_d, _ = fs.eps_smallspace_stacks_reference(
                *(x.double() for x in (e, v, vf, t, ef, mean[None])),
                batch=b)
            f_d = f.double() + su_d.T @ sw_d
            mean_tol = max(mean_tol, 8 * float((m_p - m_d).abs().max()))
            f_tol = max(f_tol, 8 * float((f_p - f_d).abs().max()))
        assert float((m_k - m_p[0]).abs().max()) <= mean_tol, case
        assert float((f_k - f_p).abs().max()) <= f_tol, case


@pytest.mark.parametrize("b,d", [(32, 256), (8, 200), (64, 1024)])
def test_cluster_smallspace_rejects_the_ladder(cuda, b, d):
    """Draw rows over three decades: the gates reject (as chip_smoke.py's
    update_reject), and K1 returns the old state exactly."""
    e, v, _, _, _, mean, f = _smallspace_inputs(cuda, b, d, 3, 3.0)
    m_k, f_k, g_k = fs.gsm_eps_update_fused(e, v, mean, f)
    _, _, g_p = fs.gsm_eps_update_ns_reference(e, v, mean, f)
    assert not bool(g_k) and not bool(g_p)
    assert torch.equal(m_k, mean) and torch.equal(f_k, f)


@pytest.mark.parametrize("d", CLUSTER_D)
@pytest.mark.parametrize("m", THIN_M)
def test_thin_product_matches_plain(cuda, m, d):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    rows = torch.randn((m, d), generator=gen, device=cuda)
    f = torch.randn((d, d), generator=gen, device=cuda) / d ** 0.5
    mu = torch.randn(d, generator=gen, device=cuda)
    close = lambda got, want: float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert close(fs.thin_product(rows, f, trans=False), rows @ f)
    out, x = fs.thin_product(rows, f, trans=True, mu=mu)
    assert close(out, rows @ f.T) and torch.equal(x, mu + out)
    assert close(fs.gaussian_score(rows, mu[None], f),
                 fs.gaussian_score_reference(rows, mu[None], f))
    # A replica axis: three (m, d) row blocks with their own factors.
    if m * d <= 512 * 1024:
        rows3 = torch.randn((3, m, d), generator=gen, device=cuda)
        f3 = torch.randn((3, d, d), generator=gen, device=cuda) / d ** 0.5
        out3 = fs.thin_product(rows3, f3, trans=True)
        assert close(out3, rows3 @ f3.transpose(-1, -2))


@pytest.mark.parametrize("k", [3, 8])
def test_cluster_kernels_replicas_equal_single_launches(cuda, k):
    """Replica z of a K-replica launch equals a launch on replica z alone,
    bit for bit: the small space (K clusters), the thin product (blockIdx.z)
    and K3 on the K*B stacked rows."""
    b, d = 32, 256
    e, v, vf, t, ef, mean, f = _smallspace_inputs(cuda, b, d, 11, k=k)
    e[1] *= torch.logspace(0.0, 3.0, b, device=cuda)[:, None]   # rejected
    stacked = fs.eps_smallspace(e, v, vf, t, ef, mean)
    assert not bool(stacked[3][1]) and bool(stacked[3][0])
    rows_k = fs.thin_product(v, f, trans=False)
    x_k = fs.thin_product(e, f, trans=True, mu=mean)
    prec = f[0] @ f[0].T
    score_k = fs.gaussian_score(e.reshape(k * b, d), mean[:1], prec)
    for z in range(k):
        one = fs.eps_smallspace(e[z], v[z], vf[z], t[z], ef[z], mean[z])
        for got, want in zip(stacked, one):
            assert torch.equal(got[z].nan_to_num(), want.nan_to_num())
        assert torch.equal(rows_k[z], fs.thin_product(v[z], f[z],
                                                      trans=False))
        ox, xx = fs.thin_product(e[z], f[z], trans=True, mu=mean[z])
        assert torch.equal(x_k[0][z], ox) and torch.equal(x_k[1][z], xx)
        assert torch.equal(score_k[z * b:(z + 1) * b],
                           fs.gaussian_score(e[z], mean[:1], prec))


def test_cluster_kernels_repeat_bit_for_bit(cuda):
    """Two launches on the same inputs give the same bits (no atomics)."""
    for b, d in ((32, 256), (64, 8192), (3, 257)):
        e, v, vf, t, ef, mean, f = _smallspace_inputs(cuda, b, d, 5)
        a1 = fs.eps_smallspace(e, v, vf, t, ef, mean)
        a2 = fs.eps_smallspace(e, v, vf, t, ef, mean)
        for x, y in zip(a1, a2):
            assert torch.equal(x, y)
        k1 = fs.gsm_eps_update_fused(e, v, mean, f)
        k2 = fs.gsm_eps_update_fused(e, v, mean, f)
        assert torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])
        assert torch.equal(fs.thin_product(v, f, trans=True),
                           fs.thin_product(v, f, trans=True))
        assert torch.equal(fs.gaussian_score(e, mean[None], f),
                           fs.gaussian_score(e, mean[None], f))


# ---------------------------------------------------------------------------
# BaM's cluster small space (bam_smallspace_cluster.cu) and thin row
# products over B 1-56 and D 1-8192: the small space alone and K7 against
# their plain versions on the four designed inputs (flags equal; stacks,
# mean and factor within 1e-5 of max(1, scale), or within 8x the float32
# rounding floor of the input where that is larger, the rule of
# chip_smoke.py's mixture and chol checks); K8's counts
# at B 2, 32 and 56; repeat launches equal bit for bit; a stopped K8 block's
# later launches are no-ops.
# ---------------------------------------------------------------------------

BAM_CLUSTER_B = [1, 2, 3, 7, 31, 32, 33, 55, 56]


def _bam_rows(e, v, f):
    vf = v @ f
    return e, v, vf, vf @ f.T, e @ f.T


def _bam_stacks_update(bf, rows, mu, f, reg, **gates):
    """(mean, F') of an update assembled from the small space's plain
    version, as the fat apply and the finalize assemble them."""
    su, sw, vec, _ = bf.bam_smallspace_stacks_reference(
        *rows, mu, reg, batch=rows[0].shape[0], **gates)
    f_new = f + su.T @ sw
    r1 = reg / (1.0 + reg)
    return mu / (1.0 + reg) + r1 * ((vec[0] @ f_new) @ f_new.T + vec[1]), \
        f_new


def _bam_floor(bf, e, v, mu, f, reg, p, **gates):
    """The float32 rounding floor of an accepted update: the larger distance
    from the plain version in float64 of the two plain float32 formulations,
    K7's (q_t = fu_t F) and the kernel's (q_t, qf, fom_t from the rows vf, t
    and ef), on the mean and on the factor.  The stiff_gu inputs at D <= 10
    are accepted 1-3x under the gu gate, cond(I + Gu) ~ 1e4, where the two
    formulations already part at the 1e-2 level of the mean."""
    x64 = [x.double() for x in (e, v, mu, f)]
    p64 = bf.bam_eps_update_ns_reference(*x64, reg, ef=x64[0] @ x64[3].T,
                                         **gates)
    s32 = _bam_stacks_update(bf, _bam_rows(e, v, f), mu, f, reg, **gates)
    return tuple(max(float((a - c).abs().max()), float((b - c).abs().max()))
                 for a, b, c in zip(p[:2], s32, p64[:2]))


@pytest.mark.parametrize("d", CLUSTER_D)
@pytest.mark.parametrize("b", BAM_CLUSTER_B)
def test_bam_cluster_smallspace_and_k7_match_plain(cuda, b, d):
    from gsmvi_tpu_torch.ops import bam_fused as bf

    for case in sorted(BAM_K7_CASES):
        kw, reg, gates, _ = BAM_K7_CASES[case]
        e, v, mu, f = _bam_inputs(cuda, b, d, seed=b * 10000 + d, **kw)
        rows = _bam_rows(e, v, f)
        fs.reset_launch_counts()
        su_k, sw_k, vec_k, ss_k = bf.bam_smallspace(*rows, mu, reg, **gates)
        assert fs.launch_counts()["bam_smallspace"] == 1
        su_p, sw_p, vec_p, ss_p = bf.bam_smallspace_stacks_reference(
            *rows, mu, reg, batch=b, **gates)
        assert ss_k[2:4].tolist() == ss_p[2:4].tolist(), case
        assert np.allclose(ss_k[:2].tolist(), ss_p[:2].tolist(), rtol=1e-3,
                           atol=0), case
        k = bf.bam_eps_update_fused(e, v, mu, f, reg, ef=rows[4], **gates)
        p = bf.bam_eps_update_ns_reference(e, v, mu, f, reg, ef=rows[4],
                                           **gates)
        assert (bool(k[2]), bool(k[3])) == (bool(p[2]), bool(p[3])), case
        assert np.allclose(k[4].tolist(), p[4].tolist(), rtol=1e-3, atol=0)
        if not bool(p[2]):
            assert torch.equal(k[0], mu) and torch.equal(k[1], f), case
            continue
        assert _within(vec_k, vec_p, 1e-5), case
        floor = _bam_floor(bf, e, v, mu, f, reg, p, **gates)
        mean_tol = max(1e-5 * max(1.0, float(p[0].abs().max())),
                       8 * floor[0])
        f_tol = max(1e-5 * max(1.0, float(p[1].abs().max())), 8 * floor[1])
        assert float((k[0] - p[0]).abs().max()) <= mean_tol, case
        assert float((k[1] - p[1]).abs().max()) <= f_tol, case
        f_k, f_p = f + su_k.T @ sw_k, f + su_p.T @ sw_p
        assert float((f_k - f_p).abs().max()) <= f_tol, case


# K8's counts at B=2: the reg-2.0 sub-step of the two reject cases trips the
# stiffness gate there (the plain version's counts), not the residual gates.
BAM_K8_COUNTS_B2 = {"reject_consumed": (2, 2, 1), "stop_on_reject": (2, 2, 1)}


@pytest.mark.parametrize("b", [2, 32, 56])
@pytest.mark.parametrize("case", sorted(BAM_K8_CASES))
def test_bam_multistep_counts_over_the_cluster_range(cuda, case, b):
    from gsmvi_tpu_torch.ops import bam_fused as bf

    changes, nmax, sor, iters, counts = BAM_K8_CASES[case]
    if b == 2:
        counts = BAM_K8_COUNTS_B2.get(case, counts)
    d, spc = 256, 8
    regs = [1e-4 if iters is not None else 0.05] * spc
    for j, r in (changes or {}).items():
        regs[j] = r
    params = (torch.linspace(-1.0, 1.0, d, device=cuda).reshape(1, d),
              torch.eye(d, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(2)
    block = torch.randn((spc * b, d), generator=gen, device=cuda)
    mean0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    kw = {} if iters is None else {"iters": iters}
    step = bf.make_fused_bam_multistep(fs.gaussian_score, 2, b, d, spc, **kw)
    k = step(regs, nmax, sor, block, mean0, f0, *params)
    p = bf.bam_multistep_reference(fs.gaussian_score_reference, params, regs,
                                   nmax, sor, block, mean0, f0, batch=b, **kw)
    assert tuple(int(x) for x in k[2:5]) == tuple(int(x) for x in p[2:5]) \
        == counts
    assert np.allclose(k[5].tolist(), p[5].tolist(), rtol=1e-3, atol=0)
    assert _within(k[0], p[0], 1e-4) and _within(k[1], p[1], 1e-4)


def test_bam_cluster_kernels_repeat_bit_for_bit(cuda):
    """Two launches on the same inputs give the same bits (no atomics):
    the small space, K7 and K8."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    for b, d in ((32, 256), (56, 8192), (3, 257)):
        e, v, mu, f = _bam_inputs(cuda, b, d, seed=7, v_scale=0.05)
        rows = _bam_rows(e, v, f)
        for a, c in zip(bf.bam_smallspace(*rows, mu, 0.5),
                        bf.bam_smallspace(*rows, mu, 0.5)):
            assert torch.equal(a, c)
        k1 = bf.bam_eps_update_fused(e, v, mu, f, 0.5)
        k2 = bf.bam_eps_update_fused(e, v, mu, f, 0.5)
        assert all(torch.equal(a, c) for a, c in zip(k1, k2))
    d, b, spc = 256, 32, 8
    params = (torch.zeros(1, d, device=cuda), torch.eye(d, device=cuda))
    block = torch.randn((spc * b, d), device=cuda)
    step = bf.make_fused_bam_multistep(fs.gaussian_score, 2, b, d, spc)
    run = lambda: step.packed([0.05] * spc, spc, 0, block,
                              torch.zeros(d, device=cuda),
                              torch.eye(d, device=cuda), *params)
    assert all(torch.equal(a, c) for a, c in zip(run(), run()))


def test_bam_stopped_block_leaves_later_launches_no_ops(cuda):
    """A halt word that is set makes the thin product and the cluster small
    space write nothing; a K8 block that stops at sub-step 3 ends in the
    bits of a block that ran sub-steps 0-2 only."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    b, d, spc = 32, 256, 8
    e, v, mu, f = _bam_inputs(cuda, b, d, seed=3, v_scale=0.05)
    halt = torch.ones(1, device=cuda)
    lib, stream = fs._library(), fs._stream(cuda)
    out = torch.full((b, d), 7.0, device=cuda)
    fs._thin(lib, stream, e, f, out, trans=True, halt=halt)
    fs._thin(lib, stream, e, f, out, trans=False, halt=halt)
    buf = bf._BamBuffers(b, d, cuda)
    for x in (buf.su, buf.sw, buf.vec, buf.ss, buf.rows):
        x.fill_(7.0)
    buf.vf, buf.t = _bam_rows(e, v, f)[2:4]
    bf._launch_bam_smallspace(lib, stream, e, v, e @ f.T, mu, buf, 0.5,
                              bf.BAM_NS_ITERS_DEFAULT, bf.LMAX_GATE_DEFAULT,
                              bf.GU_GATE_DEFAULT, halt=halt)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert all(bool((x == 7.0).all())
               for x in (buf.su, buf.sw, buf.vec, buf.ss, buf.rows))
    params = (torch.linspace(-1.0, 1.0, d, device=cuda).reshape(1, d),
              torch.eye(d, device=cuda))
    block = torch.randn((spc * b, d), device=cuda)
    regs = [0.05] * spc
    regs[3] = 1e9
    step = bf.make_fused_bam_multistep(fs.gaussian_score, 2, b, d, spc)
    mean0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    stopped = step.packed(regs, spc, 0, block, mean0, f0, *params)
    three = step.packed(regs, 3, 0, block, mean0, f0, *params)
    assert stopped[2][bf.REP_STOPPED].item() == 1.0
    assert torch.equal(stopped[0], three[0])
    assert torch.equal(stopped[1], three[1])


# ---------------------------------------------------------------------------
# K2 and K6 blocks as CUDA graphs on persistent buffers (``FusedBlocks``)
# ---------------------------------------------------------------------------

def _block_problem(dev, b, d, spc, k=None, seed=0, reject_at=None):
    """(params, score_fn, eps block, mean0, f0) from (0, I) on
    ``dense_gaussian(0, d)``; with ``reject_at`` sub-step's rows (of
    replica 0 when K is given) scaled over three decades so that the
    residual gates reject it."""
    t = dense_gaussian(0, d, device=dev)
    score_fn, params = t.fused_score
    lead = () if k is None else (k,)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = torch.randn((*lead, spc * b, d), generator=gen, device=dev)
    if reject_at is not None:
        rows = block if k is None else block[0]
        rows[reject_at * b:(reject_at + 1) * b] *= torch.logspace(
            0.0, 3.0, b, device=dev)[:, None]
    mean0 = torch.zeros((*lead, d), device=dev)
    f0 = torch.eye(d, device=dev).expand(*lead, d, d).contiguous()
    return score_fn, params, block, mean0, f0


def _make_blocks(score_fn, params, b, d, spc, k=None):
    from gsmvi_tpu_torch.ops import batch_fused as bfm

    if k is None:
        return fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    return bfm.make_fused_eps_batch_multistep(score_fn, len(params), b, d,
                                              k, spc)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("b,d,k,reject_at", [
    (32, 256, None, None), (8, 200, None, None), (1, 1, None, None),
    (128, 256, None, None), (32, 256, 4, None), (32, 256, None, 4),
    (32, 256, 4, 4)])
def test_graph_block_equals_eager_block(cuda, b, d, k, reject_at):
    """A full block replayed from its CUDA graph equals the same block
    enqueued eagerly, bit for bit, at the main shape, a ragged one, the
    smallest, on the row-panel small space (B=128) and for K6 at K=4;
    also with a sub-step the gates reject.  The first full block runs
    eagerly and captures; the second replays."""
    spc = 8
    score_fn, params, block, mean0, f0 = _block_problem(
        cuda, b, d, spc, k, seed=b + d, reject_at=reject_at)
    step = _make_blocks(score_fn, params, b, d, spc, k)
    eager = step(spc, block, mean0, f0, *params, graph=False)
    first = step(spc, block, mean0, f0, *params)
    assert len(step.captures) == 1
    replayed = step(spc, block, mean0, f0, *params)
    assert len(step.captures) == 1
    torch.cuda.synchronize()
    assert _same(eager, first) and _same(eager, replayed)
    want = spc if reject_at is None else spc - 1
    n_acc = eager[2] if k is None else eager[2][0]
    assert int(n_acc) == want


@pytest.mark.parametrize("k", [None, 4])
def test_remainder_blocks_run_eagerly_and_equal_the_graph(cuda, k):
    """nmax < spc runs eagerly on the same buffers and captures nothing;
    a fit whose chunks end in remainder blocks equals the fit on eager
    blocks (``cuda_graph=False``) and on spc=1 (K4), bit for bit."""
    b, d, spc = 32, 256, 8
    score_fn, params, block, mean0, f0 = _block_problem(cuda, b, d, spc, k)
    step = _make_blocks(score_fn, params, b, d, spc, k)
    for nmax in (1, 3, 7):
        got = step(nmax, block, mean0, f0, *params)
        want = step(nmax, block, mean0, f0, *params, graph=False)
        assert _same(got, want)
    assert step.captures == []
    t = dense_gaussian(3, 64, scale=0.5, device=cuda)
    fits = []
    for spc_, graph in ((8, True), (8, False), (1, True)):
        g = FactorGSM(64, t.lp, t.lp_g, fused_score=t.fused_score,
                      steps_per_call=spc_, cuda_graph=graph, device="cuda")
        # niter=44: one chunk of 45 = 5 x 8 + 5, a remainder of 5.
        fits.append(g.fit(0, batch_size=16, niter=44, verbose=False,
                          return_state=True))
    for other in fits[1:]:
        assert torch.equal(fits[0].mean, other.mean)
        assert torch.equal(fits[0].factor, other.factor)
        assert int(fits[0].n_accepted) == int(other.n_accepted)


def test_new_params_recapture_and_new_contents_do_not(cuda):
    """A graph is keyed on where the params lie: new params tensors
    capture a new graph; new contents at the same address replay the old
    one and read the new values."""
    b, d, spc = 32, 256, 8
    score_fn, params, block, mean0, f0 = _block_problem(cuda, b, d, spc)
    step = _make_blocks(score_fn, params, b, d, spc)
    step(spc, block, mean0, f0, *params)
    other = tuple(p.clone() for p in params)
    other[0].add_(0.25)
    got = step(spc, block, mean0, f0, *other)
    assert len(step.captures) == 2
    got = step(spc, block, mean0, f0, *other)
    assert _same(got, step(spc, block, mean0, f0, *other, graph=False))
    params[0].add_(0.5)
    got = step(spc, block, mean0, f0, *params)
    assert len(step.captures) == 2
    assert _same(got, step(spc, block, mean0, f0, *params, graph=False))


@pytest.mark.parametrize("k", [None, 4])
def test_held_state_survives_the_next_replay(cuda, k):
    """What a block returns is the caller's: the next replay (from other
    inputs) writes the persistent buffers, never a returned tensor."""
    b, d, spc = 32, 256, 8
    score_fn, params, block, mean0, f0 = _block_problem(cuda, b, d, spc, k)
    step = _make_blocks(score_fn, params, b, d, spc, k)
    step(spc, block, mean0, f0, *params)
    held = step(spc, block, mean0, f0, *params)
    copies = tuple(x.clone() for x in held)
    step(spc, block * 0.5, held[0], held[1], *params)
    torch.cuda.synchronize()
    assert _same(held, copies)
    t = dense_gaussian(3, 64, scale=0.5, device=cuda)
    g = FactorGSM(64, t.lp, t.lp_g, fused_score=t.fused_score,
                  device="cuda")
    st = g.fit(0, batch_size=16, niter=40, verbose=False, return_state=True)
    mean, factor = st.mean.clone(), st.factor.clone()
    g.fit(1, batch_size=16, niter=40, verbose=False, state=st)
    assert torch.equal(st.mean, mean) and torch.equal(st.factor, factor)


@pytest.mark.parametrize("k", [None, 4])
def test_graph_launch_counts_equal_the_eager_path(cuda, k):
    """Each replay adds the counters' increases recorded at capture: three
    graph blocks (one capture, two replays) count what three eager blocks
    count, and a fit counts what the same fit on eager blocks counts."""
    b, d, spc = 32, 256, 8
    score_fn, params, block, mean0, f0 = _block_problem(cuda, b, d, spc, k)
    counts = []
    for graph in (True, False):
        step = _make_blocks(score_fn, params, b, d, spc, k)
        fs.reset_launch_counts()
        for _ in range(3):
            step(spc, block, mean0, f0, *params, graph=graph)
        counts.append(fs.launch_counts())
    assert counts[0] == counts[1]
    name = "make_fused_eps_multistep" if k is None else \
        "make_fused_eps_batch_multistep"
    assert counts[0][name] == 3
    assert counts[0]["gaussian_score"] == 3 * spc
    assert counts[0]["thin_product"] == 3 * spc * 3
    assert counts[0]["eps_smallspace"] == 3 * spc
    t = dense_gaussian(3, 64, scale=0.5, device=cuda)
    fit_counts = []
    for graph in (True, False):
        g = FactorGSM(64, t.lp, t.lp_g, fused_score=t.fused_score,
                      cuda_graph=graph, device="cuda")
        fs.reset_launch_counts()
        g.fit(0, batch_size=16, niter=60, verbose=False)
        fit_counts.append(fs.launch_counts())
    assert fit_counts[0] == fit_counts[1]
    assert fit_counts[0]["gaussian_score"] == 61


def test_a_score_that_synchronises_raises(cuda):
    """A fused score must be capturable: one that reads the device from the
    host fails the capture, and the block raises naming the score."""
    b, d, spc = 8, 64, 8
    _, params, block, mean0, f0 = _block_problem(cuda, b, d, spc)

    def syncing_score(x, mu_t, prec):
        if float(x.abs().max()) > 1e30:
            raise AssertionError("unreachable")
        return fs.gaussian_score(x, mu_t, prec)

    step = _make_blocks(syncing_score, params, b, d, spc)
    with pytest.raises(RuntimeError, match="syncing_score.*could not be "
                                           "captured"):
        step(spc, block, mean0, f0, *params)
    assert step.captures == []
    # The card is usable afterwards, and a capturable score still captures.
    step = _make_blocks(fs.gaussian_score, params, b, d, spc)
    step(spc, block, mean0, f0, *params)
    assert len(step.captures) == 1


def _one_launch_capture(fn):
    """fn() eagerly, then captured and replayed into the eager outputs'
    twins: (eager outputs, replayed outputs)."""
    eager = fn()
    out = []
    # fs._capture_graph holds Python's cycle collector off during capture.
    graph = fs._capture_graph(lambda: out.append(fn()))[0]
    captured = out[0]
    for x in captured:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


@pytest.mark.parametrize("b", [32, 128])
def test_cluster_small_space_captures_in_one_launch(cuda, b):
    """The small space's cluster launch (``cudaLaunchKernelEx`` with a
    cluster dimension; at B=128 the row-panel kernel's 16-block cluster)
    captures into a CUDA graph and replays bit for bit."""
    eps, v, mu, f = _inputs(cuda, b, 256, seed=b)
    vf, ef = v @ f, eps @ f.T
    t = vf @ f.T
    eager, replayed = _one_launch_capture(
        lambda: fs.eps_smallspace(eps, v, vf, t, ef, mu))
    assert _same(eager, replayed)


def test_thin_product_captures_in_one_launch(cuda):
    """The split-k thin product's cluster launch captures and replays bit
    for bit (rows @ F^T with x = mu + out)."""
    eps, _, mu, f = _inputs(cuda, 32, 256, seed=3)
    eager, replayed = _one_launch_capture(
        lambda: fs.thin_product(eps, f, trans=True, mu=mu))
    assert _same(eager, replayed)


# ---------------------------------------------------------------------------
# The row-panel small spaces (eps B 65-128, BaM B 57-128)
# ---------------------------------------------------------------------------

PANEL_B = [65, 96, 127, 128]
PANEL_D = [1, 33, 256]


@pytest.mark.parametrize("d", PANEL_D)
@pytest.mark.parametrize("b", PANEL_B)
def test_panel_smallspace_matches_plain(cuda, b, d):
    """K1 on the row-panel small space against its plain version, one
    panel launch per update; the small space alone returns the plain
    version's mean, stacked rows (through F') and gate."""
    eps, v, mu, f = _inputs(cuda, b, d, seed=b * 7 + d)
    fs.reset_launch_counts()
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    counts = fs.launch_counts()
    assert counts["eps_smallspace_panel"] == 1
    assert counts["eps_smallspace"] == counts["eps_smallspace_large"] == 0
    m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f)
    assert bool(g_k) == bool(g_p)
    assert float((m_k - m_p).abs().max()) <= 1e-5
    assert float((f_k - f_p).abs().max()) <= 1e-5 * float(f.abs().max())
    vf, ef = v @ f, eps @ f.T
    t = vf @ f.T
    ss_k = fs.eps_smallspace(eps, v, vf, t, ef, mu)
    ss_p = fs.eps_smallspace(*(x.cpu() for x in (eps, v, vf, t, ef, mu)))
    assert bool(ss_k[3]) == bool(ss_p[3])
    assert float((ss_k[0].cpu() - ss_p[0]).abs().max()) <= 1e-5
    fk = f.cpu() + ss_k[1].cpu().T @ ss_k[2].cpu()
    fp = f.cpu() + ss_p[1].T @ ss_p[2]
    assert float((fk - fp).abs().max()) <= 1e-5 * float(f.abs().max())


@pytest.mark.parametrize("d", PANEL_D)
@pytest.mark.parametrize("b", [57, 100, 121, 128])
@pytest.mark.parametrize("case", sorted(BAM_K7_CASES))
def test_bam_panel_smallspace_matches_plain(cuda, b, d, case):
    """BaM's row-panel small space and K7 on it against their plain
    versions on the four designed inputs: equal flags and reject verdicts,
    statistics within 1e-3 relative; a rejected update leaves (mean, F) as
    they were, bit for bit; an accepted one is held to 1e-5 of max(1,
    scale), and stiff_gu's (accepted just under the gu gate at small D,
    cond(I + Gu) ~ 1e4) to the larger of that and 8x the input's float32
    floor (``_bam_floor``), as on the cluster range.  The readings:
    ``tools/bam_panel_floor.py``."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    kw, reg, gates, _ = BAM_K7_CASES[case]
    e, v, mu, f = _bam_inputs(cuda, b, d, seed=b + 3 * d, **kw)
    rows = _bam_rows(e, v, f)
    fs.reset_launch_counts()
    su_k, sw_k, vec_k, ss_k = bf.bam_smallspace(*rows, mu, reg, **gates)
    assert fs.launch_counts()["bam_smallspace_panel"] == 1
    su_p, sw_p, vec_p, ss_p = bf.bam_smallspace_stacks_reference(
        *rows, mu, reg, batch=b, **gates)
    assert ss_k[2:4].tolist() == ss_p[2:4].tolist()
    assert np.allclose(ss_k[:2].tolist(), ss_p[:2].tolist(), rtol=1e-3,
                       atol=0)
    fs.reset_launch_counts()
    k = bf.bam_eps_update_fused(e, v, mu, f, reg, ef=rows[4], **gates)
    assert fs.launch_counts()["bam_smallspace_panel"] == 1
    p = bf.bam_eps_update_ns_reference(e, v, mu, f, reg, ef=rows[4], **gates)
    assert (bool(k[2]), bool(k[3])) == (bool(p[2]), bool(p[3]))
    assert np.allclose(k[4].tolist(), p[4].tolist(), rtol=1e-3, atol=0)
    if not bool(p[2]):
        assert torch.equal(k[0], mu) and torch.equal(k[1], f)
        return
    assert _within(vec_k, vec_p, 1e-5)
    mean_tol = 1e-5 * max(1.0, float(p[0].abs().max()))
    f_tol = 1e-5 * max(1.0, float(p[1].abs().max()))
    if case == "stiff_gu":
        floor = _bam_floor(bf, e, v, mu, f, reg, p, **gates)
        mean_tol, f_tol = max(mean_tol, 8 * floor[0]), max(f_tol, 8 * floor[1])
    assert float((k[0] - p[0]).abs().max()) <= mean_tol
    assert float((k[1] - p[1]).abs().max()) <= f_tol
    f_k, f_p = f + su_k.T @ sw_k, f + su_p.T @ sw_p
    assert float((f_k - f_p).abs().max()) <= f_tol


def test_panel_k6_replicas_equal_single_fits_at_b128(cuda):
    """fit_batch "fused" (K6, K=4) at B=128 runs the row-panel small space
    with a replica axis and equals the four single K2 fits bit for bit."""
    d, b, niter, k = 64, 128, 16, 4
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device="cuda")
    fs.reset_launch_counts()
    st = g.fit_batch(range(k), batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    assert fs.launch_counts()["eps_smallspace_panel"] > 0
    for i in range(k):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(st.mean[i], si.mean)
        assert torch.equal(st.factor[i], si.factor)


@pytest.mark.parametrize("kind", ["eps", "bam"])
def test_panel_launch_raises_when_no_cluster_fits(cuda, kind, monkeypatch):
    """The placement seam: when cudaOccupancyMaxActiveClusters reads 0 the
    wrapper raises, naming the shape, and launches nothing."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    real = fs._library()

    class NoRoom:
        def __getattr__(self, name):
            return getattr(real, name)

        def size(self, name, *args):
            if name.endswith("_panel_clusters"):
                return 0
            return real.size(name, *args)

    monkeypatch.setattr(fs, "_library", lambda: NoRoom())
    monkeypatch.setattr(bf, "_library", lambda: NoRoom())
    monkeypatch.setattr(fs, "_PLACEMENT", {})
    fs.reset_launch_counts()
    b, d = 128, 64
    with pytest.raises(RuntimeError, match="B=128 on a cluster of 16"):
        if kind == "eps":
            fs.gsm_eps_update_fused(*_inputs(cuda, b, d))
        else:
            bf.bam_eps_update_fused(*_bam_inputs(cuda, b, d, v_scale=0.05),
                                    0.5)
    assert fs.launch_counts()[f"{kind}_smallspace_panel"] == 0


# ---------------------------------------------------------------------------
# The grid small space of B 129-512 (eps_smallspace_grid.cu): one
# cooperative launch per update.
# ---------------------------------------------------------------------------

GRID_B = [129, 200, 256, 512]
GRID_D = [1, 33, 256, 1024]


@pytest.mark.parametrize("d", GRID_D)
@pytest.mark.parametrize("b", GRID_B)
def test_grid_smallspace_matches_plain(cuda, b, d):
    """K1 on the grid small space against its plain version, one grid
    launch per update; the small space alone returns the plain version's
    mean, stacked rows (through F') and gate."""
    eps, v, mu, f = _inputs(cuda, b, d, seed=b * 3 + d)
    fs.reset_launch_counts()
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    counts = fs.launch_counts()
    assert counts["eps_smallspace_large"] == 1
    assert counts["eps_smallspace"] == counts["eps_smallspace_panel"] == 0
    m_p, f_p, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f)
    assert bool(g_k) == bool(g_p)
    assert float((m_k - m_p).abs().max()) <= 1e-5
    assert float((f_k - f_p).abs().max()) <= 1e-5 * float(f.abs().max())
    vf, ef = v @ f, eps @ f.T
    t = vf @ f.T
    ss_k = fs.eps_smallspace(eps, v, vf, t, ef, mu)
    ss_p = fs.eps_smallspace(*(x.cpu() for x in (eps, v, vf, t, ef, mu)))
    assert bool(ss_k[3]) == bool(ss_p[3])
    assert float((ss_k[0].cpu() - ss_p[0]).abs().max()) <= 1e-5
    fk = f.cpu() + ss_k[1].cpu().T @ ss_k[2].cpu()
    fp = f.cpu() + ss_p[1].T @ ss_p[2]
    assert float((fk - fp).abs().max()) <= 1e-5 * float(f.abs().max())


@pytest.mark.parametrize("b", [200, 512])
def test_grid_smallspace_rejects_and_keeps_state(cuda, b):
    eps, v, mu, f = _inputs(cuda, b, 64, decades=3.0)
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    _, _, g_p = fs.gsm_eps_update_ns_reference(eps, v, mu, f)
    assert not bool(g_k) and not bool(g_p)
    assert torch.equal(m_k, mu) and torch.equal(f_k, f)


@pytest.mark.parametrize("b", [129, 256, 512])
def test_grid_smallspace_gives_the_same_bits_twice(cuda, b):
    eps, v, mu, f = _inputs(cuda, b, 256, seed=b)
    one = fs.gsm_eps_update_fused(eps, v, mu, f)
    two = fs.gsm_eps_update_fused(eps, v, mu, f)
    assert all(torch.equal(x, y) for x, y in zip(one, two))


def test_grid_k6_replicas_equal_single_calls_at_b256(cuda):
    """Batched K1 at B=256, K=3 equals its single calls bit for bit, and
    fit_batch "fused" (K6) at B=256 equals the single K2 fits."""
    ins = [_inputs(cuda, 256, 128, seed=40 + i) for i in range(3)]
    eps, v, mu, f = (torch.stack(z) for z in zip(*ins))
    fs.reset_launch_counts()
    m_k, f_k, g_k = fs.gsm_eps_update_fused(eps, v, mu, f)
    assert fs.launch_counts()["eps_smallspace_large"] == 1
    for i in range(3):
        m_i, f_i, g_i = fs.gsm_eps_update_fused(*ins[i])
        assert torch.equal(m_k[i], m_i) and torch.equal(f_k[i], f_i)
        assert bool(g_i) == bool(g_k[i])
    d, b, niter = 64, 256, 20
    t = dense_gaussian(3, d, scale=0.5, device=cuda)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device="cuda")
    st = g.fit_batch(range(3), batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    for i in range(3):
        si = g.fit(i, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(st.mean[i], si.mean)
        assert torch.equal(st.factor[i], si.factor)


def test_grid_k2_graph_block_equals_eager_block_at_b256(cuda):
    """A K2 block at B=256 replays its captured cooperative launches with
    the eager block's bits, replay after replay, the sync words back to 0."""
    d, b, spc = 256, 256, 8
    t = dense_gaussian(0, d, device=cuda)
    score_fn, params = t.fused_score
    step = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc)
    block = torch.randn((spc * b, d), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(5))
    m0, f0 = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    eager = step(spc, block, m0, f0, *params, graph=False)
    for _ in range(3):
        got = step(spc, block, m0, f0, *params)
        assert all(torch.equal(x, y) for x, y in zip(got, eager))
    assert len(step.captures) == 1 and int(eager[2]) == spc
    (bufs,) = step._bufs.values()
    assert int(bufs.buf.sync.abs().sum()) == 0


def test_grid_smallspace_is_one_kernel_a_call(cuda):
    """Under the profiler the small space at B=512 is one device kernel a
    call, and no GEMM-template or elementwise chain kernel runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, d = 512, 256
    eps, v, mu, f = _inputs(cuda, b, d, seed=11)
    vf, ef = v @ f, eps @ f.T
    rows = (eps, v, vf, vf @ f.T, ef, mu)
    fs.eps_smallspace(*rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fs.eps_smallspace(*rows)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    grid = [n for n in names if "eps_grid_kernel" in n]
    assert 1 <= len(grid) <= 4
    assert not any("gemm_kernel" in n or "gl_" in n for n in names)


def test_grid_launch_raises_when_refused_or_unplaceable(cuda, monkeypatch):
    """A cooperative launch of more blocks than the card holds is refused
    and raises, naming the shape; so does an occupancy reading of 0."""
    b, d = 256, 64
    eps, v, mu, f = _inputs(cuda, b, d)
    fs.gsm_eps_update_fused(eps, v, mu, f)
    monkeypatch.setitem(fs._PLACEMENT, ("grid", b),
                        8 * fs._PLACEMENT[("grid", b)])
    with pytest.raises(RuntimeError, match=r"B=256, D=64, K=1 \("):
        fs.gsm_eps_update_fused(eps, v, mu, f)
    torch.cuda.synchronize()
    real = fs._library()

    class NoRoom:
        def __getattr__(self, name):
            return getattr(real, name)

        def size(self, name, *args):
            return 0 if name == "gsmvi_eps_grid_blocks" else real.size(name,
                                                                       *args)

    monkeypatch.setattr(fs, "_library", lambda: NoRoom())
    monkeypatch.setattr(fs, "_PLACEMENT", {})
    fs.reset_launch_counts()
    with pytest.raises(RuntimeError, match=r"B=256 \(tile 16\) cannot be "):
        fs.gsm_eps_update_fused(eps, v, mu, f)
    assert fs.launch_counts()["eps_smallspace_large"] == 0


# ---------------------------------------------------------------------------
# K7 over stacked replicas (FactorBaM.fit_batch)
# ---------------------------------------------------------------------------

def _bam_replica_inputs(dev, b, d, k):
    """``chip_smoke.bam_replica_cases``: K replicas' (eps, v, mu, f) on the
    card and their NS tiers, replica 5 on a two-sweep tier with open gates
    (a residual reject), replica 6 on a tier whose lmax gate it passes
    (stiff)."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    rng = np.random.default_rng(7000 + 31 * b + d + k)
    arrays, tiers = [], []
    for i in range(k):
        e = rng.standard_normal((b, d)).astype(np.float32)
        f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))
             ).astype(np.float32)
        mu = rng.standard_normal(d).astype(np.float32)
        v = (0.05 * rng.standard_normal((b, d))).astype(np.float32)
        arrays.append((e, v, mu, f))
        tier = bf.BAM_NS_TIERS[i % len(bf.BAM_NS_TIERS)]
        if k > 1 and i == 5:
            tier = ((2, 2, 2, 2, 2), float("inf"), float("inf"))
        if k > 1 and i == 6:
            tier = (bf.BAM_NS_ITERS_DEFAULT, bf.GU_GATE_DEFAULT, 1e-3)
        tiers.append(tier)
    return ([torch.from_numpy(np.stack(x)).to(dev) for x in zip(*arrays)],
            tiers)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("b,d", [(2, 10), (32, 256), (56, 256), (128, 256)])
def test_bam_replica_k7_matches_plain_and_single_k7(cuda, b, d, k):
    """Replica i of one K7 launch sequence equals K7 on replica i alone at
    its tier, bit for bit, and its plain version within 1e-5 of max(1,
    scale); flags equal, a rejecting and a stiff replica keep their old
    state beside replicas that accept (the row-panel small space at
    B=128)."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    (e, v, mu, f), tiers = _bam_replica_inputs(cuda, b, d, k)
    got = bf.bam_eps_update_replicas(e, v, mu, f, 0.5, tiers)
    want = bf.bam_eps_update_replicas_reference(e, v, mu, f, 0.5, tiers)
    assert got[2].tolist() == want[2].tolist()
    assert got[3].tolist() == want[3].tolist()
    for x, y in zip(got[:2], want[:2]):
        assert float((x - y).abs().max()) <= 1e-5 * max(
            1.0, float(y.abs().max()))
    np.testing.assert_allclose(got[4].cpu().numpy(), want[4].cpu().numpy(),
                               rtol=1e-3, atol=0)
    for i, (it, gg, lm) in enumerate(tiers):
        one = bf.bam_eps_update_fused(e[i], v[i], mu[i], f[i], 0.5, iters=it,
                                      gu_gate=gg, lmax_gate=lm)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y), i
        if not bool(got[2][i]):
            assert torch.equal(got[0][i], mu[i])
            assert torch.equal(got[1][i], f[i])
    if k > 1:
        keep, stiff = got[2].tolist(), got[3].tolist()
        assert keep[0] and keep[1] and not keep[5] and not stiff[5]
        assert stiff[6]


@pytest.mark.parametrize("b", [8, 64])
def test_factor_bam_fit_batch_replicas_equal_single_fits(cuda, b):
    """FactorBaM.fit_batch on K7's replica axis: replica i equals
    ``fit(seeds[i])`` bit for bit, one replica launch a step; B=64 runs
    the row-panel small space."""
    from gsmvi_tpu_torch import FactorBaM, Regularizers
    from gsmvi_tpu_torch.state import replica

    d, niter, seeds = 64, 150, (3, 1, 4, 5)
    t = dense_gaussian(0, d, device=cuda)
    fb = FactorBaM(d, t.lp, t.lp_g, device=cuda)
    regf = Regularizers().linear(100.0)
    fs.reset_launch_counts()
    st = fb.fit_batch(seeds, regf, batch_size=b, niter=niter, retries=0,
                      return_state=True)
    counts = fs.launch_counts()
    assert counts["bam_eps_update_replicas"] == niter + 1
    assert counts["bam_eps_update_fused"] == 0
    for i, seed in enumerate(seeds[:2]):
        s = fb.fit(seed, regf, batch_size=b, niter=niter, retries=0,
                   verbose=False, return_state=True)
        r = replica(st, i)
        assert torch.equal(r.mean, s.mean) and torch.equal(r.factor, s.factor)
        assert r.ns_stats == s.ns_stats
        assert int(r.n_accepted) == int(s.n_accepted)


# ---------------------------------------------------------------------------
# The bf16 and bf16x3 tensor-core products ("bf16"/"high" precision)
# ---------------------------------------------------------------------------
# Kernel and plain version (``fs.mm_prec``) round the same float32 operands
# to the same bfloat16 values, so they differ only in float32 sums of K
# terms (3K at bf16x3): within 4 K 2^-24 (|a| @ |b|) elementwise (a
# recursive sum rounded to nearest, K u, plus the tensor cores' truncating
# adds, 2 K u).  Against float64: 2^-8 (1 + 2^-8) |a| @ |b| at bf16, 2^-16 at
# bf16x3, plus that (as chip_smoke.py phase 24).

PREC_PASSES = {"bf16": 1, "high": 3}
PREC_REL = {"bf16": 2.0 ** -8 * (1 + 2.0 ** -8), "high": 2.0 ** -16}


def _check_product(got, want, a, b, k, precision):
    absprod = a.abs().double() @ b.abs().double()
    sum_tol = 4.0 * PREC_PASSES[precision] * k * 2.0 ** -24
    assert bool(((got.double() - want.double()).abs()
                 <= sum_tol * absprod + 1e-30).all())
    exact = a.double() @ b.double()
    assert bool(((got.double() - exact).abs()
                 <= (PREC_REL[precision] + sum_tol) * absprod + 1e-30).all())


@pytest.mark.parametrize("precision", ["bf16", "high"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m,d", [(32, 256), (8, 200), (128, 256), (512, 1024),
                                 (1, 1), (3, 17)])
def test_tensor_core_thin_product_matches_plain(cuda, precision, trans, m,
                                                d):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    rows = torch.randn((m, d), generator=gen, device=cuda)
    f = torch.randn((d, d), generator=gen, device=cuda) / d ** 0.5
    mu = torch.randn(d, generator=gen, device=cuda)
    fs.reset_launch_counts()
    if trans:
        out, x = fs.thin_product(rows, f, trans=True, mu=mu,
                                 precision=precision)
        assert torch.equal(x, mu + out)
    else:
        out = fs.thin_product(rows, f, trans=False, precision=precision)
    tag = fs.MMA_TAG[precision]
    assert fs.launch_counts()[f"thin_product_{tag}"] == 1
    fb = f.T if trans else f
    _check_product(out, fs.mm_prec(rows, fb, precision), rows, fb, d,
                   precision)


@pytest.mark.parametrize("precision", ["bf16", "high"])
@pytest.mark.parametrize("b,d", [(32, 256), (8, 200), (128, 256),
                                 (512, 1024), (1, 1), (32, 1), (32, 33),
                                 (32, 768)])
def test_tensor_core_apply_matches_plain(cuda, precision, b, d):
    gen = torch.Generator(device=cuda).manual_seed(3 * b + d)
    su = torch.randn((2 * b, d), generator=gen, device=cuda)
    sw = 0.1 * torch.randn((2 * b, d), generator=gen, device=cuda)
    f = torch.randn((d, d), generator=gen, device=cuda)
    yes, no = (torch.tensor(x, device=cuda) for x in (True, False))
    assert torch.equal(fs.factor_apply(su, sw, f, no, precision=precision), f)
    zero = torch.zeros_like(f)
    got = fs.factor_apply(su, sw, zero, yes, precision=precision)
    want = fs.factor_apply_reference(su, sw, zero, yes, precision)
    _check_product(got, want, su.T, sw, 2 * b, precision)


@pytest.mark.parametrize("precision", ["bf16", "high"])
def test_tensor_core_replicas_equal_single_launches(cuda, precision):
    gen = torch.Generator(device=cuda).manual_seed(5)
    k, b, d = 3, 32, 256
    rows = torch.randn((k, b, d), generator=gen, device=cuda)
    f = torch.randn((k, d, d), generator=gen, device=cuda) / 16
    su = torch.randn((k, 2 * b, d), generator=gen, device=cuda)
    good = torch.tensor([True, False, True], device=cuda)
    out = fs.thin_product(rows, f, trans=False, precision=precision)
    app = fs.factor_apply(su, su, f, good, precision=precision)
    for i in range(k):
        assert torch.equal(out[i], fs.thin_product(rows[i], f[i], trans=False,
                                                   precision=precision))
        assert torch.equal(app[i], fs.factor_apply(su[i], su[i], f[i],
                                                   good[i],
                                                   precision=precision))


@pytest.mark.parametrize("precision", ["bf16", "high"])
@pytest.mark.parametrize("b,d", [(8, 200), (32, 256)])
def test_eps_kernels_at_precision_match_plain(cuda, precision, b, d):
    """K1, K4 and K2 at "high" within 2^-14 (one update) and 8 x that (an
    8-step block) of max(1, |F|) of their plain versions; at "bf16" one
    update within half the plain version's own distance from float32 on
    the same input (a sum-order difference can move an operand across a
    bfloat16 rounding boundary), a block within twice it (such flips
    compound over chained sub-steps), and no less than "high"'s
    (chip_smoke.py phase 24)."""
    eps, v, mu, f = _inputs(cuda, b, d, seed=7 * b + d)
    t = dense_gaussian(0, d, device=cuda)
    score_fn, params = t.fused_score
    spc = 8
    gen = torch.Generator(device=cuda).manual_seed(2)
    block = torch.randn((spc * b, d), generator=gen, device=cuda)
    zero, eye = torch.zeros(d, device=cuda), torch.eye(d, device=cuda)
    ref = fs.gaussian_score_reference

    def cases(p):
        k4 = fs.make_fused_eps_step(score_fn, len(params), b, d,
                                    external_eps=True, precision=p)
        k2 = fs.make_fused_eps_multistep(score_fn, len(params), b, d, spc,
                                         precision=p)
        return {
            "k1": (lambda: fs.gsm_eps_update_fused(eps, v, mu, f,
                                                   precision=p),
                   lambda: fs.gsm_eps_update_ns_reference(eps, v, mu, f,
                                                          precision=p), 1),
            "k4": (lambda: k4(eps, mu, f, *params),
                   lambda: fs.eps_step_reference(ref, params, eps, mu, f,
                                                 precision=p), 1),
            "k2": (lambda: k2(spc, block, zero, eye, *params),
                   lambda: fs.eps_multistep_reference(
                       ref, params, spc, block, zero, eye, batch=b,
                       precision=p), 8)}

    plain32 = {k: pl() for k, (_, pl, _) in cases("highest").items()}
    for name, (kern, plain, steps) in cases(precision).items():
        got, want = kern(), plain()
        fscale = max(1.0, float(want[1].abs().max()))
        base = steps * 2.0 ** -14
        own = max(float((want[0] - plain32[name][0]).abs().max()),
                  float((want[1] - plain32[name][1]).abs().max()) / fscale)
        share = 2.0 if steps > 1 else 0.5
        tol = base if precision == "high" else max(base, share * own)
        assert int(got[2]) == int(want[2]), name
        assert float((got[0] - want[0]).abs().max()) <= tol, name
        assert float((got[1] - want[1]).abs().max()) <= tol * fscale, name


@pytest.mark.parametrize("precision", ["bf16", "high"])
def test_factor_gsm_fits_at_precision(cuda, precision):
    """FactorGSM(fused_score, pallas_precision=p) on the card: every
    sub-step's three row products and fat apply on the tensor cores, a
    finite, PD fit; the K6 replica equals the K2 fit bit for bit."""
    d, b, niter = 256, 32, 200
    t = dense_gaussian(0, d, device=cuda)
    fg = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                   pallas_precision=precision, device=cuda)
    fs.reset_launch_counts()
    st = fg.fit(0, batch_size=b, niter=niter, verbose=False,
                return_state=True)
    c = fs.launch_counts()
    tag = fs.MMA_TAG[precision]
    assert c[f"thin_product_{tag}"] == 3 * (niter + 1)
    assert c[f"factor_apply_{tag}"] == niter + 1 and c["thin_product"] == 0
    cov = st.cov
    assert bool(torch.isfinite(cov).all())
    assert float(torch.linalg.eigvalsh(cov.double()).min()) > 0.0
    batch = fg.fit_batch((0, 1), batch_size=b, niter=niter,
                         return_state=True, small_solver="fused")
    assert torch.equal(batch.mean[0], st.mean)
    assert torch.equal(batch.factor[0], st.factor)


def test_methods_small_eigh_is_orthogonal_on_the_card(cuda):
    """The twophase/qr steps' small eigh on the card (float64 inside, see
    ``ops/gsm_factor._small_eigh``) gives eigenvectors orthogonal to the
    CPU's LAPACK level at k=64, where torch's float32 eigh there reaches
    only ~1.4e-5."""
    from gsmvi_tpu_torch.ops.gsm_factor import _small_eigh

    rng = np.random.default_rng(0)
    a = 0.3 * rng.standard_normal((64, 64))
    m = torch.tensor(np.eye(64) + 0.5 * (a + a.T) / 8, dtype=torch.float32,
                     device=cuda)
    w, q = _small_eigh(m)
    assert w.dtype == q.dtype == torch.float32
    eye = torch.eye(64, dtype=torch.float64, device=cuda)
    assert float((q.T.double() @ q.double() - eye).abs().max()) < 2e-6


# ---------------------------------------------------------------------------
# The float32 fat apply (apply_f32.cu) against the 32x32 template it replaced
# ---------------------------------------------------------------------------

def _apply_oracle(su, sw, f, good, out):
    """The template's select apply (``gsmvi_factor_apply_oracle``, gemm.cu):
    the float32 apply's bit-for-bit yardstick."""
    k, d = su.shape[-2:]
    fs._library().call("gsmvi_factor_apply_oracle", fs._ptr(su), fs._ptr(sw),
                       fs._ptr(f), fs._ptr(out), fs._ptr(good), k, d,
                       f.shape[0] if f.dim() == 3 else 1,
                       fs._stream(f.device))
    return out


@pytest.mark.parametrize("reps", [1, 8])
@pytest.mark.parametrize("k2,d", [(2, 1), (4, 33), (64, 256), (128, 200),
                                  (256, 767), (64, 768), (1024, 1031)])
def test_f32_apply_equals_the_template_bit_for_bit(cuda, k2, d, reps):
    """Every output keeps the template's chain (fmaf in k order from 0, a
    ragged k's zero FMAs as acc + 0, then F + acc), out of place, in place,
    and each replica of a K-replica launch as a launch on it alone."""
    gen = torch.Generator(device=cuda).manual_seed(k2 + d + reps)
    lead = (reps,) if reps > 1 else ()
    su = torch.randn((*lead, k2, d), generator=gen, device=cuda)
    sw = 0.1 * torch.randn((*lead, k2, d), generator=gen, device=cuda)
    f = torch.randn((*lead, d, d), generator=gen, device=cuda)
    flags = (1, 0, 1, 1, 0, 1, 1, 1)[:reps] if reps > 1 else (1,)
    for gv in (flags, (0,) * reps):
        good = torch.tensor(gv, dtype=torch.int32, device=cuda)
        want = _apply_oracle(su, sw, f, good, torch.empty_like(f))
        fs.reset_launch_counts()
        assert torch.equal(fs.factor_apply(su, sw, f, good).view(torch.int32),
                           want.view(torch.int32))
        assert fs.launch_counts()["factor_apply"] == 1
        inplace = f.clone()
        fs._apply(fs._library(), fs._stream(cuda), su, sw, inplace, inplace,
                  good, precision="highest", reps=reps)
        assert torch.equal(inplace, want)
        for z in range(reps if reps > 1 else 0):
            assert torch.equal(fs.factor_apply(su[z], sw[z], f[z],
                                               good[z:z + 1]), want[z])


def test_f32_apply_keeps_the_templates_signed_zeros(cuda):
    """A k chain that ends at -0 (the last product underflows) on F = -0:
    the template's zero FMAs to its 32-deep slab make the sum +0, and so
    does the kernel's acc + 0; bit for bit, not only by value."""
    su = torch.zeros((2, 64), device=cuda)
    sw = torch.zeros((2, 64), device=cuda)
    su[1], sw[1] = -2.0 ** -80, 2.0 ** -80
    f = torch.full((64, 64), -0.0, device=cuda)
    good = torch.ones(1, dtype=torch.int32, device=cuda)
    want = _apply_oracle(su, sw, f, good, torch.empty_like(f))
    got = fs.factor_apply(su, sw, f, good)
    assert not bool(torch.signbit(want).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("k2,d", [(64, 256), (16, 200), (64, 33),
                                  (256, 1024)])
def test_f32_apply_matches_plain(cuda, k2, d):
    """On F = 0 the kernel and torch's float32 mm (TF32 off) differ in sum
    order alone: within 4 (2B) 2^-24 |su|^T |sw| (chip_smoke.py
    PREC_SUM, one pass); the select keeps F where ``good`` is 0."""
    gen = torch.Generator(device=cuda).manual_seed(k2 * d)
    su = torch.randn((k2, d), generator=gen, device=cuda)
    sw = 0.1 * torch.randn((k2, d), generator=gen, device=cuda)
    zero = torch.zeros((d, d), device=cuda)
    got = fs.factor_apply(su, sw, zero)
    want = fs.factor_apply_reference(su, sw, zero)
    absprod = su.T.abs().double() @ sw.abs().double()
    assert bool(((got.double() - want.double()).abs()
                 <= 4.0 * k2 * 2.0 ** -24 * absprod + 1e-30).all())
    f = torch.randn((d, d), generator=gen, device=cuda)
    no = torch.tensor(False, device=cuda)
    assert torch.equal(fs.factor_apply(su, sw, f, no), f)


def test_eps_paths_launch_the_f32_apply(cuda):
    """K1 and a K2 block run ``apply_f32_kernel`` for the fat apply, one
    launch an update (the wrappers' counts), and never the template (the
    profiler's kernel names; it may drop a record of a short window, so
    it is asked only which kernels ran)."""
    from tools.profile_gpu import profile_window

    eps, v, mu, f = _inputs(cuda, 32, 256)
    t = dense_gaussian(0, 256, device=cuda)
    score_fn, params = t.fused_score
    spc = 8
    block = torch.randn((spc * 32, 256), device=cuda)
    step = fs.make_fused_eps_multistep(score_fn, len(params), 32, 256, spc)

    def run():
        fs.gsm_eps_update_fused(eps, v, mu, f)
        step(spc, block, mu, f, *params, graph=False)
        torch.cuda.synchronize()

    run()
    fs.reset_launch_counts()
    _, kernels, _ = profile_window(run)
    names = {k.name for k in kernels}
    assert any("apply_f32_kernel" in n for n in names)
    assert not any("gemm_kernel" in n for n in names)
    assert fs.launch_counts()["factor_apply"] == 1 + spc


# ---------------------------------------------------------------------------
# The tensor-core thin product's plans (thin_mma.cu): both tiles, ragged M
# and D, and replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["bf16", "high"])
@pytest.mark.parametrize("m,d", [(17, 767), (33, 768), (5, 1031), (64, 63),
                                 (2, 8192)])
def test_tensor_core_thin_plans_match_plain(cuda, precision, m, d):
    """Both plans of ``thin_mma_tile`` (16 x 16 below 768, 32 x 32 from it)
    at ragged M and D (D % 4 != 0 takes the masked 4-byte loads): within
    phase 24's bounds of ``mm_prec`` for rows @ F and rows @ F^T with x."""
    gen = torch.Generator(device=cuda).manual_seed(11 * m + d)
    rows = torch.randn((m, d), generator=gen, device=cuda)
    f = torch.randn((d, d), generator=gen, device=cuda) / d ** 0.5
    mu = torch.randn(d, generator=gen, device=cuda)
    out, x = fs.thin_product(rows, f, trans=True, mu=mu, precision=precision)
    assert torch.equal(x, mu + out)
    _check_product(out, fs.mm_prec(rows, f.T, precision), rows, f.T, d,
                   precision)
    out = fs.thin_product(rows, f, trans=False, precision=precision)
    _check_product(out, fs.mm_prec(rows, f, precision), rows, f, d,
                   precision)


@pytest.mark.parametrize("precision", ["bf16", "high"])
@pytest.mark.parametrize("b,d", [(32, 256), (8, 200), (12, 1024)])
def test_tensor_core_thin_replicas_equal_single_launches(cuda, precision, b,
                                                         d):
    """K=3 replicas in one launch (rows a strided view, as K6's) equal a
    launch on each alone, bit for bit, for all three products; and a
    replica's rows do not depend on M: the first rows of a taller launch
    equal a launch on them alone."""
    gen = torch.Generator(device=cuda).manual_seed(b + d)
    k = 3
    block = torch.randn((k, 2 * b, d), generator=gen, device=cuda)
    rows = block[:, :b]
    f = torch.randn((k, d, d), generator=gen, device=cuda) / d ** 0.5
    mu = torch.randn((k, d), generator=gen, device=cuda)
    lib, stream = fs._library(), fs._stream(cuda)
    vf, t, ef, x = (torch.empty((k, b, d), device=cuda) for _ in range(4))
    fs._thin(lib, stream, rows, f, vf, trans=False, precision=precision)
    fs._thin(lib, stream, rows, f, t, trans=True, precision=precision)
    fs._thin(lib, stream, rows, f, ef, trans=True, mu=mu, x_out=x,
             precision=precision)
    for i in range(k):
        r = rows[i].contiguous()
        assert torch.equal(vf[i], fs.thin_product(r, f[i], trans=False,
                                                  precision=precision))
        assert torch.equal(t[i], fs.thin_product(r, f[i], trans=True,
                                                 precision=precision))
        one = fs.thin_product(r, f[i], trans=True, mu=mu[i],
                              precision=precision)
        assert torch.equal(ef[i], one[0]) and torch.equal(x[i], one[1])
    tall = fs.thin_product(block[0], f[0], trans=True, precision=precision)
    assert torch.equal(tall[:b], t[0])


# ---------------------------------------------------------------------------
# BaM's fat apply (apply_f32.cu, gsmvi_bam_apply) against the 32x32 template
# it replaced (gsmvi_bam_apply_oracle)
# ---------------------------------------------------------------------------

def _bam_apply_oracle(su, sw, f):
    """The template's BaM apply: (f + su^T sw, its 32x32 tiles' (sum f'^2,
    sum f^2) pairs)."""
    k2, d = su.shape[-2:]
    out = torch.empty_like(f)
    part = out.new_empty((*f.shape[:-2], (-(-d // 32)) ** 2, 2))
    fs._library().call("gsmvi_bam_apply_oracle", fs._ptr(su), fs._ptr(sw),
                       fs._ptr(f), fs._ptr(out), fs._ptr(part), None, k2,
                       d, f.shape[0] if f.dim() == 3 else 1,
                       fs._stream(f.device))
    return out, part


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("b,d", [(1, 1), (2, 33), (32, 256), (56, 200),
                                 (63, 767), (64, 768), (128, 1031)])
def test_bam_apply_equals_the_template(cuda, b, d, reps):
    """F' bit for bit with the template (its FMA chain), each replica of a
    K=3 launch as a launch on it alone; each tile's (sum F'^2, sum F^2)
    within (n - 1) 2^-24 of the exact sums over its n elements, and the
    totals within (n + 32^2) 2^-24 of the exact ones against the
    template's (chip_smoke.py phase 27)."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    gen = torch.Generator(device=cuda).manual_seed(b + d + reps)
    lead = (reps,) if reps > 1 else ()
    k2 = 2 * (b + 1)
    su = torch.randn((*lead, k2, d), generator=gen, device=cuda)
    sw = 0.1 * torch.randn((*lead, k2, d), generator=gen, device=cuda)
    f = torch.randn((*lead, d, d), generator=gen, device=cuda)
    fs.reset_launch_counts()
    got, part = bf.bam_apply(su, sw, f)
    assert fs.launch_counts()["bam_apply"] == 1
    want, opart = _bam_apply_oracle(su, sw, f)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert part.shape == (*lead, bf.bam_apply_tiles(d), 2)
    bm, bn = fs.apply_tile(d)
    n, u = bm * bn, 2.0 ** -24
    for i, x in enumerate((got, f)):
        exact = bf._tile_sums_of_squares(x.double())
        assert bool(((part[..., i].double() - exact).abs()
                     <= (n - 1) * u * exact).all())
        gap = (part[..., i].double().sum(-1)
               - opart[..., i].double().sum(-1)).abs()
        assert bool((gap <= (n + 32 * 32) * u * exact.sum(-1)).all())
    for z in range(reps if reps > 1 else 0):
        one, opart1 = bf.bam_apply(su[z], sw[z], f[z])
        assert torch.equal(one, got[z]) and torch.equal(opart1, part[z])


def test_bam_apply_keeps_the_templates_signed_zeros(cuda):
    """A k chain that ends at -0 on F = -0: +0 after the template's zero
    FMAs to its 32-deep slab, and so after the kernel's acc + 0."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    su = torch.zeros((2, 64), device=cuda)
    sw = torch.zeros((2, 64), device=cuda)
    su[1], sw[1] = -2.0 ** -80, 2.0 ** -80
    f = torch.full((64, 64), -0.0, device=cuda)
    want, _ = _bam_apply_oracle(su, sw, f)
    got, _ = bf.bam_apply(su, sw, f)
    assert not bool(torch.signbit(want).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_bam_apply_honours_its_halt_word(cuda):
    """A set halt word leaves F' and the partials as they were; a cleared
    one computes what ``bam_apply`` computes."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    gen = torch.Generator(device=cuda).manual_seed(9)
    d, k2 = 256, 66
    su = torch.randn((k2, d), generator=gen, device=cuda)
    sw = torch.randn((k2, d), generator=gen, device=cuda)
    f = torch.randn((d, d), generator=gen, device=cuda)
    halt = torch.ones(1, device=cuda)
    out = torch.full_like(f, 7.0)
    part = torch.full((bf.bam_apply_tiles(d), 2), 7.0, device=cuda)
    lib, stream = fs._library(), fs._stream(cuda)
    bf._launch_bam_apply(lib, stream, su, sw, f, out, part, halt, 1)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all() and (part == 7.0).all())
    halt.zero_()
    bf._launch_bam_apply(lib, stream, su, sw, f, out, part, halt, 1)
    got, want_part = bf.bam_apply(su, sw, f)
    assert torch.equal(out, got) and torch.equal(part, want_part)


@pytest.mark.parametrize("b,d", [(32, 256), (12, 200), (32, 33),
                                 (128, 1024)])
def test_bam_apply_matches_plain(cuda, b, d):
    """On F = 0 the kernel and torch's float32 mm (TF32 off) differ in sum
    order alone: within 4 (2(B+1)) 2^-24 |su|^T |sw|."""
    from gsmvi_tpu_torch.ops import bam_fused as bf

    gen = torch.Generator(device=cuda).manual_seed(b * d)
    k2 = 2 * (b + 1)
    su = torch.randn((k2, d), generator=gen, device=cuda)
    sw = 0.1 * torch.randn((k2, d), generator=gen, device=cuda)
    zero = torch.zeros((d, d), device=cuda)
    got = bf.bam_apply(su, sw, zero)[0]
    want = bf.bam_apply_reference(su, sw, zero)[0]
    absprod = su.T.abs().double() @ sw.abs().double()
    assert bool(((got.double() - want.double()).abs()
                 <= 4.0 * k2 * 2.0 ** -24 * absprod + 1e-30).all())


def test_bam_paths_launch_the_f32_apply(cuda):
    """K7, a K8 block and K7 over K=3 replicas run ``apply_f32_kernel`` for
    their fat apply, one ``bam_apply`` launch an update, and never the
    template."""
    from tools.profile_gpu import profile_window

    from gsmvi_tpu_torch.ops import bam_fused as bf

    b, d, spc, k = 32, 256, 8, 3
    eps, v, mu, f = _bam_inputs(cuda, b, d)
    t = dense_gaussian(0, d, device=cuda)
    score_fn, params = t.fused_score
    block = torch.randn((spc * b, d), device=cuda)
    multi = bf.make_fused_bam_multistep(score_fn, len(params), b, d, spc)
    stack = lambda x: x.repeat(k, *([1] * x.dim()))

    def run():
        bf.bam_eps_update_fused(eps, v, mu, f, 0.05)
        multi([0.05] * spc, spc, 0, block, mu, f, *params)
        bf.bam_eps_update_replicas(stack(eps), stack(v), stack(mu), stack(f),
                                   0.05)
        torch.cuda.synchronize()

    run()
    fs.reset_launch_counts()
    _, kernels, _ = profile_window(run)
    names = {k.name for k in kernels}
    assert any("apply_f32_kernel" in n for n in names)
    assert not any("gemm_kernel" in n for n in names)
    # K7 1, K8 one an enqueued sub-step (nmax = spc), the replicas 1.
    assert fs.launch_counts()["bam_apply"] == 1 + spc + 1
