"""The port's BaM NS step (gsmvi_tpu_torch/ops/bam_fused.py) against the JAX
package on identical numpy-made inputs.

K7's and K8's wrappers run their plain versions on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_bam_fused.py
does, and its core ``_bam_smallspace_ns`` where a kernel has no ``ef``
input.  Flags and counts must be equal.  Tolerances: float32 on both sides
with sums in other orders; one update within 1e-5 * max(1, scale) (the JAX
package's interpret-vs-core bound, tests/test_bam_fused.py:100-102), four
chained sub-steps within 1e-4 * max(1, scale), the gate statistics within
1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmvi_tpu.bam_factor as j_bf
from gsmvi_tpu.ops.pallas import bam_fused as jbf
from gsmvi_tpu.ops.pallas.fused_step import gaussian_score_kernel
from gsmvi_tpu_torch.ops import bam_fused as tbf
from gsmvi_tpu_torch.ops import fused_step as tfs

# The port runs on the card by default; these tests run on the CPU.
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _stats_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-6)


def _inputs(seed, b, d, score_scale=1.0, v_scale=None):
    """tests/test_bam_fused.py's ``_benign_inputs``; ``v_scale`` replaces
    the scores by small noise (a benign Y)."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, d)).astype(np.float32)
    f = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    x = mu + e @ f.T
    v = (score_scale * -(x - rng.standard_normal(d))).astype(np.float32)
    if v_scale is not None:
        v = (v_scale * rng.standard_normal((b, d))).astype(np.float32)
    return e, v, mu, f


def test_ns_sqrt_both_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12))
    m = (np.eye(12) + a @ a.T / 12).astype(np.float32)
    for got, want in zip(tbf.ns_sqrt_both(*_t(m), 11),
                         jbf._ns_sqrt_both(*_j(m), 11)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("b,d,reg", [(8, 32, 0.3), (16, 48, 1.0)])
def test_smallspace_reference_matches_jax_core(b, d, reg, with_ef):
    e, v, mu, f = _inputs(b + d, b, d)
    ef = (e @ f.T).astype(np.float32) if with_ef else None
    got = tbf.bam_smallspace_ns_reference(
        *_t(e, v, mu[None], f), reg, batch=b,
        ef_t=None if ef is None else _t(ef)[0])
    want = jbf._bam_smallspace_ns(*_j(e, v, mu[None], f), reg, batch=b,
                                  ef_t=None if ef is None else _j(ef)[0])
    assert [bool(got[2]), bool(got[3])] == [bool(want[2]), bool(want[3])]
    assert bool(got[2]) and not bool(got[3])
    _close(got[0], want[0], 1e-5, "mean")
    _close(got[1], want[1], 1e-5, "factor")
    _stats_close([got[4], got[5]], [want[4], want[5]])


# case: (batch, dim, score scale, small-noise scores, reg, gate overrides,
#        expected (keep, stiff))
K7_CASES = {
    "benign": (8, 32, 1.0, None, 1.5, {}, (True, False)),
    # lmax(G) over the gate (tests/test_bam_fused.py:73-86).
    "stiff_lmax": (8, 32, 300.0, None, 20.0, {}, (False, True)),
    # gu over its gate with a benign Y (tests/test_bam_fused.py:322-340).
    "stiff_gu": (32, 128, 1.0, 0.02, 1e4, {"lmax_gate": float("inf")},
                 (False, True)),
    # Gates opened: the cu chain cannot converge, the residual gate rejects.
    "reject": (8, 40, 1.0, None, 3e5,
               {"lmax_gate": float("inf"), "gu_gate": float("inf")},
               (False, False)),
}


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_plain_matches_jax(case, with_ef):
    """K7 on CPU tensors against JAX's K7 in interpret mode (no ``ef``) or
    its core with ``ef_t`` and the kernel's select (with ``ef``)."""
    b, d, sc, vsc, reg, gates, flags = K7_CASES[case]
    e, v, mu, f = _inputs(3 * b + d, b, d, sc, vsc)
    ef = (e @ f.T).astype(np.float32) if with_ef else None
    m_t, f_t, keep_t, stiff_t, ns_t = tbf.bam_eps_update_fused(
        *_t(e, v, mu, f), reg, ef=None if ef is None else _t(ef)[0], **gates)
    if ef is None:
        m_j, f_j, keep_j, stiff_j, ns_j = jbf.bam_eps_update_fused(
            *_j(e, v, mu, f), reg, interpret=True, **gates)
    else:
        mu_n, f_n, good, stiff_j, gu, lm = jbf._bam_smallspace_ns(
            *_j(e, v, mu[None], f), reg, batch=b, ef_t=_j(ef)[0], **gates)
        keep_j = good & ~stiff_j
        m_j = jnp.where(keep_j, mu_n[0], mu)
        f_j = jnp.where(keep_j, f_n, f)
        ns_j = jnp.stack([gu, lm])
    assert (bool(keep_t), bool(stiff_t)) == (bool(keep_j), bool(stiff_j)) \
        == flags
    _stats_close(ns_t, ns_j)
    _close(m_t, m_j, 1e-5, "mean")
    _close(f_t, f_j, 1e-5, "factor")
    if not flags[0]:
        assert torch.equal(m_t, _t(mu)[0]) and torch.equal(f_t, _t(f)[0])


def _benign_target(d):
    mean_t = np.linspace(-1.0, 1.0, d).astype(np.float32)
    return mean_t, np.eye(d, dtype=np.float32)


SHORT = (2, 2, 2, 2, 2)
# case: (regs, nmax, stop_on_reject, NS iters, expected (done, acc, stopped))
K8_CASES = {
    "full": ([2.0, 1.0, 0.7, 0.5], 4, 0, None, (4, 4, 0)),
    "nmax_lt_spc": ([0.5] * 4, 3, 0, None, (3, 3, 0)),
    # A huge reg at sub-step 2 trips the gates: the block stops there,
    # leaving it unconsumed (tests/test_bam_fused.py:155-189).
    "stiff_stop": ([0.5, 0.5, 1e9, 0.5], 4, 0, None, (2, 2, 1)),
    # Two-sweep chains converge at reg 1e-4 but not at 5: a reject.
    "reject_consumed": ([1e-4, 1e-4, 5.0, 1e-4], 4, 0, SHORT, (4, 3, 0)),
    "stop_on_reject": ([1e-4, 1e-4, 5.0, 1e-4], 4, 1, SHORT, (2, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_k8_plain_matches_jax_interpret(case):
    """K8 on CPU tensors against make_fused_bam_multistep(interpret=True)
    with the Gaussian score: counts, the last attempted sub-step's stats,
    and the state."""
    regs, nmax, sor, iters, counts = K8_CASES[case]
    b, d, spc = 8, 16, 4
    mean_t, cov = _benign_target(d)
    prec = np.linalg.inv(cov).astype(np.float32)
    rng = np.random.default_rng(len(case))
    block = rng.standard_normal((spc * b, d)).astype(np.float32)
    mu = np.zeros(d, np.float32)
    f = np.eye(d, dtype=np.float32)
    kw = {} if iters is None else {"iters": iters}
    jstep = jbf.make_fused_bam_multistep(gaussian_score_kernel, 2, b, d, spc,
                                         interpret=True, **kw)
    got_j = jstep(jnp.asarray(regs, jnp.float32), nmax, sor,
                  *_j(block, mu, f, mean_t[None], prec))
    tstep = tbf.make_fused_bam_multistep(tfs.gaussian_score, 2, b, d, spc,
                                         **kw)
    got_t = tstep(regs, nmax, sor, *_t(block, mu, f, mean_t[None], prec))
    assert tuple(int(x) for x in got_t[2:5]) == \
        tuple(int(x) for x in got_j[2:5]) == counts
    _stats_close(got_t[5], got_j[5])
    _close(got_t[0], got_j[0], 1e-4, "mean")
    _close(got_t[1], got_j[1], 1e-4, "factor")
    # nmax = 0 consumes nothing and reports the cold-start stats.
    if case == "full":
        m0, f0, nd, na, st, ns = tstep(regs, 0, sor, *_t(block, mu, f,
                                                         mean_t[None], prec))
        assert (int(nd), int(na), int(st)) == (0, 0, 0)
        assert np.isinf(ns.numpy()).all() and torch.equal(f0, _t(f)[0])


STATS_GRID = [float("inf"), 1e5, 4e4, 1e3, 100.0, 44.7, 44.8, 20.0, 9.8,
              9.9, 5.0, 2.0, 1.0, 0.1]


@pytest.mark.parametrize("gates", [None, (20.0, 500.0), (5e4, 100.0)])
def test_ns_tiers_and_tier_choice_match_jax(gates):
    """FactorBaM's pruned ladders and ns_tier_from_stats against JAX's on a
    grid of (gu_ub, lmax_ub) with inf and values at the margin-scaled
    gates."""
    from gsmvi_tpu.models.gaussian import _gaussian_target
    from gsmvi_tpu_torch import FactorBaM
    from gsmvi_tpu_torch.models import gaussian_target_from_arrays

    d = 4
    mean_t, cov = _benign_target(d)
    tj = _gaussian_target(jnp.asarray(mean_t), jnp.asarray(cov), "g")
    tt = gaussian_target_from_arrays(mean_t, cov, device=DEV)
    kw = {} if gates is None else {"gu_gate": gates[0],
                                   "lmax_gate": gates[1]}
    for profile in ("auto", "long"):
        ti = FactorBaM(d, tt.lp, tt.lp_g, ns_profile=profile, device=DEV,
                       **kw)._ns_tiers()
        tj_ = j_bf.FactorBaM(d, tj.lp, tj.lp_g, ns_profile=profile,
                             **kw)._ns_tiers()
        assert [(tuple(i), float(g), float(l)) for i, g, l in ti] == \
            [(tuple(i), float(g), float(l)) for i, g, l in tj_]
    tiers = FactorBaM(d, tt.lp, tt.lp_g, device=DEV, **kw)._ns_tiers()
    for gu in STATS_GRID:
        for lm in STATS_GRID:
            assert tbf.ns_tier_from_stats(gu, lm, tiers) == int(
                jbf.ns_tier_from_stats(gu, lm, tiers)), (gu, lm)


def test_constants_and_kernel_range():
    for name in ("BAM_NS_ITERS_DEFAULT", "LMAX_GATE_DEFAULT",
                 "GU_GATE_DEFAULT", "BAM_NS_TIERS", "FEEDBACK_CADENCE",
                 "FEEDBACK_MARGIN"):
        assert getattr(tbf, name) == getattr(jbf, name), name
    assert np.isinf(tbf.NS_STATS_INIT).all()
    # B from 1 to the JAX kernel's 128 and D from 1 are inside the range;
    # the cluster kernel ends where its shared memory (kpad = B + 8 <= 64)
    # does, and the row-panel small space takes over above.
    assert all(tbf.bam_kernel_supports(32, d) for d in (1, 16, 200, 1024))
    assert tbf.BAM_KERNEL_BATCH_RANGE == (1, 128)
    assert tbf.BAM_SHARED_MAX_B == 56
    assert tbf.bam_smallspace_smem_bytes(56) <= tbf.SMEM_LIMIT_BYTES
    assert tbf.bam_kernel_supports(1, 256) and tbf.bam_kernel_supports(128, 8)
    assert not tbf.bam_kernel_supports(129, 256)
    assert not tbf.bam_kernel_supports(32, 8193)


def test_cpu_calls_launch_nothing():
    tfs.reset_launch_counts()
    e, v, mu, f = _inputs(0, 8, 16)
    tbf.bam_eps_update_fused(*_t(e, v, mu, f), 1.0)
    mean_t, cov = _benign_target(16)
    step = tbf.make_fused_bam_multistep(tfs.gaussian_score, 2, 8, 16, 2)
    step([1.0, 0.5], 2, 0, *_t(np.concatenate([e, e]), mu, f, mean_t[None],
                                np.linalg.inv(cov)))
    assert sum(tfs.launch_counts().values()) == 0
    assert {"bam_eps_update_fused", "make_fused_bam_multistep"} <= set(
        tfs.launch_counts())
