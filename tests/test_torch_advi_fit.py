"""The port's ADVI fitter as a whole: ``fit`` against JAX ``ADVI.fit``,
``fit_fused`` (both estimators) against JAX ``fit_fused``, resume, the
state lifts, trajectory invariance, recovery and the routing rules.

The port is fed JAX's own draws (``fit``: the ``split`` chain of its key;
``fit_fused``: ``normal(fold_in(key, s))``).  The JAX fused path runs as
tests/test_advi_fused.py runs it (``on_tpu`` monkeypatched, Pallas in
interpret mode); the port's kernel paths run on the CPU with its ``on_gpu``
monkeypatched, where the kernel wrappers run their plain versions.
Tolerances: ``fit`` in float64, where both packages compute the same
expressions, 1e-9 relative; ``fit_fused`` in float32 over ~20 chained
sub-steps with sums in other orders, 1e-4 * max(1, scale) (the per-call
kernel bound is 2e-5, tests/test_torch_advi_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsmvi_tpu.advi as j_advi
import gsmvi_tpu_torch.advi as t_advi
from gsmvi_tpu.models.gaussian import _gaussian_target
from gsmvi_tpu_torch import ADVI, Adam
from gsmvi_tpu_torch.advi import (ADVIState, FusedADVISTLState,
                                  FusedADVIState, advi_state_from_numpy)
from gsmvi_tpu_torch.driver import make_chunk_runner, run_fit_loop
from gsmvi_tpu_torch.models import dense_gaussian, gaussian_target_from_arrays

FUSED_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make the port's fit_fused apply the card's routing rules on the
    CPU (its kernel wrappers then run their plain versions)."""
    monkeypatch.setattr(t_advi, "on_gpu", lambda device: True)


def _targets(seed, d, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    cov = (0.6 * np.eye(d) + 0.3 * a @ a.T / d).astype(dtype)
    mean = rng.standard_normal(d).astype(dtype)
    return (_gaussian_target(jnp.asarray(mean), jnp.asarray(cov), "g"),
            gaussian_target_from_arrays(mean, cov))


def _jax_fused(monkeypatch, t, d, **kw):
    monkeypatch.setattr(j_advi, "on_tpu", lambda: True)
    g = j_advi.ADVI(D=d, lp=t.lp, pallas_score=t.pallas_score, **kw)
    g._interpret = True
    return g


def _fold_in_draws(key, n, b, d):
    draw = lambda s: jax.random.normal(jax.random.fold_in(key, s), (b, d),
                                       jnp.float32)
    return np.asarray(jax.vmap(draw)(jnp.arange(n)))


def _feed(g, draws):
    g._eps = lambda seed, step, batch, dd, dtype: torch.tensor(
        draws[step], dtype=dtype)


def _close(got, want, tol=FUSED_TOL, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("estimator,schedule", [("analytic", False),
                                                ("stl", False),
                                                ("analytic", True)])
def test_fit_matches_jax_fit(estimator, schedule):
    """50 steps of ``fit`` (autograd + Adam) against JAX ``fit`` with
    optax.adam on JAX's split-chain draws, float64: the loss trace, mean,
    cov and the Adam state; ``return_losses=False`` gives the same
    trajectory bit for bit."""
    d, b, niter = 8, 8, 49
    tj, tt = _targets(1, d, np.float64)
    key = jax.random.PRNGKey(3)
    if schedule:
        sched = optax.exponential_decay(3e-2, 20, 0.5)
        opt_j = optax.adam(sched)
        # The schedule's float32 values as JAX's compiled fit computes them
        # (a compiled float32 pow differs from an eager one in the last
        # bit), looked up at the count the port hands the schedule.
        table = np.asarray(jax.jit(jax.vmap(sched))(
            jnp.arange(niter + 1, dtype=jnp.int32)))
        opt_t = Adam(lambda s: float(table[int(s)]))
    else:
        opt_j, opt_t = optax.adam(2e-2), Adam(2e-2)
    gj = j_advi.ADVI(D=d, lp=tj.lp, dtype=jnp.float64)
    sj, loss_j = gj.fit(key, opt_j, niter=niter, batch_size=b, verbose=False,
                        return_state=True, estimator=estimator)
    draws, k = [], key
    for _ in range(niter + 1):
        k, ks = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(ks, (b, d), jnp.float64)))
    gt = ADVI(d, tt.lp, dtype=torch.float64)
    _feed(gt, draws)
    st, loss_t = gt.fit(0, opt_t, niter=niter, batch_size=b, verbose=False,
                        return_state=True, estimator=estimator)
    assert isinstance(loss_t, np.ndarray) and loss_t.shape == (niter + 1,)
    np.testing.assert_allclose(loss_t, np.asarray(loss_j), rtol=1e-9)
    np.testing.assert_allclose(st.loc.numpy(), np.asarray(sj.loc),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(st.scales.numpy(), np.asarray(sj.scales),
                               rtol=1e-9, atol=1e-9)
    adam_j = sj.opt_state[0]
    assert st.step == int(sj.step) == niter + 1
    assert int(st.opt_state.count) == int(adam_j.count)
    for got, want in zip(st.opt_state.mu + st.opt_state.nu,
                         tuple(adam_j.mu) + tuple(adam_j.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                                   atol=1e-12)
    mean, cov, none = gt.fit(0, opt_t, niter=niter, batch_size=b,
                             verbose=False, return_losses=False,
                             estimator=estimator)
    assert none is None
    assert torch.equal(mean, st.loc)
    assert torch.equal(cov, gt.scales_to_cov(st.scales))


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_fit_fused_matches_jax_and_resumes_from_jax_state(
        monkeypatch, kernel_paths, estimator):
    """``fit_fused`` against JAX ``fit_fused`` (interpret mode) on the same
    fold_in draws over six blocks (spc=4, the last one short), with stiff
    replays in the STL case; then both continue 12 more steps, the port
    from JAX's state carried over by ``advi_state_from_numpy``."""
    d, b, spc, n1, n2 = 16, 8, 4, 20, 11
    tj, tt = _targets(2, d, np.float32)
    key = jax.random.PRNGKey(5)
    stl = estimator == "stl"
    # STL: a small start and a large rate make the tracked inverse trip
    # its gate, so blocks stop and steps replay.
    lr = 0.05 if stl else 2e-2
    cov0 = 0.3 * np.eye(d, dtype=np.float32)
    gj = _jax_fused(monkeypatch, tj, d, steps_per_call=spc)
    sj1, _ = gj.fit_fused(key, learning_rate=lr, niter=n1, batch_size=b,
                          verbose=False, cov=jnp.asarray(cov0),
                          return_state=True, estimator=estimator)
    sj2, _ = gj.fit_fused(key, learning_rate=lr, niter=n2, batch_size=b,
                          verbose=False, state=sj1, return_state=True,
                          estimator=estimator)
    draws = _fold_in_draws(key, n1 + n2 + 2 + spc, b, d)

    gt = ADVI(d, tt.lp, fused_score=tt.fused_score, steps_per_call=spc)
    _feed(gt, draws)
    st1, none = gt.fit_fused(0, learning_rate=lr, niter=n1, batch_size=b,
                             verbose=False, cov=cov0, return_state=True,
                             estimator=estimator)
    assert none is None
    assert isinstance(st1, FusedADVISTLState if stl else FusedADVIState)
    counts = gt.fit_counts
    assert counts["kernel_calls"] >= -(-(n1 + 1) // spc)
    assert counts["report_reads"] == (counts["kernel_calls"] if stl else 0)
    if stl:
        assert counts["replays"] >= 1
    # The kernels take row-major operands: a replay's re-seeded inverse too.
    assert all(t.is_contiguous() for t in st1[:-2])
    assert st1.step == int(sj1.step) == n1 + 1
    for name in st1._fields[:-2]:
        _close(getattr(st1, name).numpy(), getattr(sj1, name),
               what=f"block run: {name}")

    moments = tuple(np.asarray(getattr(sj1, f))
                    for f in ("mloc", "vloc", "ml", "vl"))
    carried = advi_state_from_numpy(
        sj1.loc, sj1.l, 0, int(sj1.step), moments=moments,
        ainv=np.asarray(sj1.ainv) if stl else None)
    st2, _ = gt.fit_fused(99, learning_rate=lr, niter=n2, batch_size=b,
                          verbose=False, state=carried, return_state=True,
                          estimator=estimator)
    assert st2.step == int(sj2.step) == n1 + n2 + 2
    for name in st2._fields[:-2]:
        _close(getattr(st2, name).numpy(), getattr(sj2, name),
               what=f"resumed from JAX: {name}")


def test_fit_state_lifts_into_fit_fused_as_jax_does(monkeypatch,
                                                    kernel_paths):
    """An ``ADVIState`` of JAX ``fit`` (optax's Adam state included) carried
    over by ``advi_state_from_numpy(adam=...)`` lifts into ``fit_fused``
    with fresh moments and continues as JAX's ``fit_fused`` does."""
    d, b, spc = 16, 8, 4
    tj, tt = _targets(4, d, np.float32)
    key = jax.random.PRNGKey(1)
    gj = j_advi.ADVI(D=d, lp=tj.lp, dtype=jnp.float32)
    sx, _ = gj.fit(key, optax.adam(2e-2), niter=9, batch_size=b,
                   verbose=False, return_state=True)
    adam = sx.opt_state[0]
    carried = advi_state_from_numpy(sx.loc, sx.scales, 0, int(sx.step),
                                    adam=(adam.count, adam.mu, adam.nu))
    assert isinstance(carried, ADVIState) and carried.step == 10
    assert int(carried.opt_state.count) == 10
    gjf = _jax_fused(monkeypatch, tj, d, steps_per_call=spc)
    sj, _ = gjf.fit_fused(key, learning_rate=2e-2, niter=9, batch_size=b,
                          verbose=False, state=sx, return_state=True)
    gt = ADVI(d, tt.lp, fused_score=tt.fused_score, steps_per_call=spc)
    # JAX's lifted state keeps the fit's key as its fold_in base.
    _feed(gt, _fold_in_draws(sx.key, 30, b, d))
    st, _ = gt.fit_fused(7, learning_rate=2e-2, niter=9, batch_size=b,
                         verbose=False, state=carried, return_state=True)
    assert st.step == int(sj.step) == 20
    for name in st._fields[:-2]:
        _close(getattr(st, name).numpy(), getattr(sj, name), what=name)


@pytest.mark.parametrize("estimator", ["analytic", "stl"])
def test_fit_fused_invariant_to_spc_and_cadence(kernel_paths, estimator):
    """Eps per absolute step, rates and bias corrections per absolute step,
    blocks masked by nmax, the tracked inverse in the state: the trajectory
    is bit-identical across steps_per_call and monitor/print cadence."""
    d = 16
    t = dense_gaussian(5, d, scale=0.4)
    calls = []

    class Monitor:
        checkpoint = 7

        def __call__(self, i, params, lp, seed, nevals=0):
            calls.append(i)

    outs = []
    for spc, monitor in ((3, None), (8, None), (8, Monitor())):
        g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=spc)
        st, _ = g.fit_fused(2, learning_rate=1e-2, niter=50, batch_size=8,
                            verbose=False, monitor=monitor,
                            return_state=True, estimator=estimator)
        assert st.step == 51
        outs.append(st)
    for st in outs[1:]:
        for a, c in zip(st[:-2], outs[0][:-2]):
            assert torch.equal(a, c)
    assert calls[:3] == [0, 7, 14]


def test_fit_fused_resume_and_lifts(kernel_paths):
    """A split run resumes exactly on both estimators; an analytic state
    lifts into STL with its moments and an exact inverse (the two-phase
    recipe), and back."""
    d = 16
    t = dense_gaussian(8, d, scale=0.4)
    g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=4)
    for est in ("analytic", "stl"):
        a, _ = g.fit_fused(3, learning_rate=1e-2, niter=20, batch_size=8,
                           verbose=False, return_state=True, estimator=est)
        b, _ = g.fit_fused(3, learning_rate=1e-2, niter=30, batch_size=8,
                           verbose=False, state=a, return_state=True,
                           estimator=est)
        full, _ = g.fit_fused(3, learning_rate=1e-2, niter=51, batch_size=8,
                              verbose=False, return_state=True,
                              estimator=est)
        assert b.step == full.step == 52
        for x, y in zip(b[:-2], full[:-2]):
            assert torch.equal(x, y)
    bulk, _ = g.fit_fused(1, learning_rate=2e-2, niter=100, batch_size=8,
                          verbose=False, return_state=True)
    polish, _ = g.fit_fused(1, learning_rate=3e-3, niter=50, batch_size=8,
                            verbose=False, state=bulk, return_state=True,
                            estimator="stl")
    assert isinstance(polish, FusedADVISTLState)
    assert polish.step == bulk.step + 51
    lifted = g._lift(bulk, stl=True)
    assert torch.equal(lifted.ml, bulk.ml) and torch.equal(lifted.vl, bulk.vl)
    torch.testing.assert_close(lifted.ainv @ bulk.l, torch.eye(d),
                               rtol=0, atol=1e-5)
    back, _ = g.fit_fused(1, learning_rate=3e-3, niter=5, batch_size=8,
                          verbose=False, state=polish, return_state=True)
    assert isinstance(back, FusedADVIState) and back.step == polish.step + 6
    # An ADVIState from fit lifts with fresh moments at its step.
    xs, _ = g.fit(1, Adam(2e-2), niter=9, batch_size=8, verbose=False,
                  return_state=True)
    fx, _ = g.fit_fused(1, learning_rate=2e-2, niter=0, batch_size=8,
                        verbose=False, state=xs, return_state=True)
    assert fx.step == 11 and float(fx.vloc.abs().max()) > 0
    ref = g._lift(advi_state_from_numpy(xs.loc.numpy(), xs.scales.numpy(),
                                        1, 10), stl=False)
    assert torch.equal(ref.l, torch.tril(xs.scales))
    assert float(ref.vl.abs().max()) == 0.0


def test_fit_fused_recovers_target():
    """A fused fit on a benign dense Gaussian recovers its moments (the
    CPU plain path, D=8 outside the kernels' range), and a fused STL polish
    started at the optimum stays far closer to it than the analytic fit."""
    d = 8
    t = dense_gaussian(7, d, scale=0.3)
    g = ADVI(d, t.lp, fused_score=t.fused_score, steps_per_call=8)
    mean, cov, losses = g.fit_fused(0, learning_rate=5e-2, niter=2000,
                                    batch_size=16, verbose=False)
    assert losses is None
    scale = max(1.0, float(t.cov.abs().max()))
    assert float((mean - t.mean).abs().max()) < 0.1 * scale
    assert float((cov - t.cov).abs().max()) < 0.15 * scale
    errs = {}
    for est in ("analytic", "stl"):
        m, c, _ = g.fit_fused(2, learning_rate=5e-3, niter=1500,
                              batch_size=16, verbose=False, mean=t.mean,
                              cov=t.cov, estimator=est)
        errs[est] = (float((m - t.mean).abs().max())
                     + float((c - t.cov).abs().max()) / scale)
    assert errs["stl"] < 0.1 * errs["analytic"], errs


def test_fit_fused_routing_and_errors(monkeypatch):
    """Unknown estimators raise on both paths; on the card fit_fused runs
    the kernels or raises (shape, dtype), never turning into fit; the
    unported options raise."""
    d = 8
    t = dense_gaussian(1, d, scale=0.5)
    g = ADVI(d, t.lp, fused_score=t.fused_score)
    with pytest.raises(ValueError, match="estimator"):
        g.fit_fused(0, niter=4, batch_size=8, verbose=False, estimator="slt")
    with pytest.raises(ValueError, match="estimator"):
        g.fit(0, Adam(1e-2), niter=4, batch_size=8, verbose=False,
              estimator="slt")
    with pytest.raises(ValueError, match="fused_score"):
        ADVI(d, t.lp).fit_fused(0, niter=2, verbose=False)
    monkeypatch.setattr(t_advi, "on_gpu", lambda device: True)
    with pytest.raises(ValueError, match=r"D in \[16, 1024\]"):
        g.fit_fused(0, niter=2, batch_size=8, verbose=False)
    d = 16
    t = dense_gaussian(1, d, scale=0.5)
    with pytest.raises(ValueError, match=r"B in \[8, 64\]"):
        ADVI(d, t.lp, fused_score=t.fused_score).fit_fused(
            0, niter=2, batch_size=4, verbose=False)
    with pytest.raises(NotImplementedError, match="float32"):
        ADVI(d, t.lp, fused_score=t.fused_score,
             dtype=torch.float64).fit_fused(0, niter=2, batch_size=8,
                                            verbose=False)
    with pytest.raises(NotImplementedError, match="mesh"):
        ADVI(d, t.lp, mesh=object())
    with pytest.raises(NotImplementedError, match="fit_batch"):
        ADVI(d, t.lp).fit_batch(None, Adam(1e-2))


def test_collect_aux_stacks_values_across_chunks():
    """``run_fit_loop(collect_aux=True)`` returns the per-step aux of all
    ``niter + 1`` steps in order across chunk boundaries (monitor and print
    cadence), stacked on the device."""

    class S:
        def __init__(self, k):
            self.k, self.seed = k, 0

    def step(s):
        return S(s.k + 1), torch.tensor(float(s.k))

    class Monitor:
        checkpoint = 4

        def __call__(self, *a, **kw):
            pass

    state, aux = run_fit_loop(S(0), 10, make_chunk_runner(step, True),
                              monitor=Monitor(), monitor_params=lambda s: [],
                              verbose=True, nprint=3, collect_aux=True)
    assert state.k == 11
    assert aux.tolist() == [float(i) for i in range(11)]
