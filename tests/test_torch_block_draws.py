"""K2/K6 blocks on persistent buffers, checked on the CPU.

- The in-place draw (``EpsStream.into`` through ``driver.draw_block``)
  writes, for one fit and for K replicas, exactly what ``torch.randn`` on a
  generator seeded with ``step_seed(seed, s)`` gives for each absolute step
  s, bit for bit, at several steps and offsets in the block, for spc in
  {1, 3, 8} and B in {1, 32}; rows past ``nmax`` are left alone.
- ``FactorGSM(fused_score).fit`` and ``.fit_batch(small_solver="fused")``
  on their kernel routes (``on_gpu`` monkeypatched; the wrappers run their
  plain versions on CPU tensors) give the state of the earlier draw path,
  which assembled each block with ``torch.cat`` of the per-step draws, and
  replica i gives ``fit(seeds[i])``; a returned state keeps its values
  after the next block runs.
- ``FusedBlocks``' graph control flow on a stand-in kernel library and a
  stand-in capture: the first full block of a params key runs eagerly and
  captures, later ones only replay (no launch from the host), the launch
  counts equal the eager path's, remainder blocks capture nothing, new
  params addresses capture anew, the cache stays bounded, and a failed
  capture raises naming the score with the counts left as they were.
"""

import numpy as np
import pytest
import torch

import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu_torch import FactorGSM
from gsmvi_tpu_torch.driver import EpsStream, draw_block, step_seed
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import batch_fused as bfm
from gsmvi_tpu_torch.ops import fused_step as fs

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_paths(monkeypatch):
    """Make FactorGSM take its kernel routes on the CPU."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)


def _randn(seed, step, b, d):
    gen = torch.Generator(device=DEV).manual_seed(step_seed(seed, step))
    return torch.randn((b, d), generator=gen)


@pytest.mark.parametrize("spc", [1, 3, 8])
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("k", [None, 3])
def test_in_place_draw_equals_randn(spc, b, k):
    """Every sub-step's rows (an odd D, so rows start at every alignment)
    hold ``torch.randn`` of their absolute step, for one fit or for each
    replica's own seed; rows past nmax keep what they held."""
    d = 5
    seeds = 7 if k is None else (7, 0, 123456789)
    lead = () if k is None else (k,)
    stream = EpsStream(DEV)
    for step in (0, 1, 9, 3001, 2 ** 40 + 3):
        for nmax in sorted({1, max(1, spc // 2), spc}):
            out = torch.full((*lead, spc * b, d), float("nan"))
            draw_block(stream, out, seeds, step, nmax, b)
            for j in range(spc):
                rows = out[..., j * b:(j + 1) * b, :]
                if j >= nmax:
                    assert bool(torch.isnan(rows).all())
                    continue
                for i, seed in enumerate((seeds,) if k is None else seeds):
                    got = rows if k is None else rows[i]
                    want = _randn(seed, step + j, b, d)
                    assert torch.equal(got, want), (step, j, i)
                    assert torch.equal(got, stream(seed, step + j, b, d))


def test_a_stand_in_draw_is_copied_in():
    """A fitter's ``_eps`` stand-in that returns its draw (the JAX-parity
    tests' fixed draws) is copied into the block's rows."""
    draws = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    out = torch.zeros((3 * 2, 3))
    draw_block(lambda seed, s, b, d, dtype: torch.from_numpy(draws[s]), out,
               0, 1, 3, 2)
    np.testing.assert_array_equal(out.numpy(), draws[1:4].reshape(6, 3))


def _parent_fit(g, seeds, b, niter):
    """The earlier K2/K6 runner: each block's eps rows assembled with
    ``torch.cat`` of all spc per-step draws, then the K2 (K6) plain
    version; returns (mean, factor, n_accepted)."""
    score_fn, params = g.fused_score
    spc, d = g.steps_per_call, g.D
    replicas = isinstance(seeds, tuple)
    lead = (len(seeds),) if replicas else ()
    state = t_gf.FactorVIState(
        torch.zeros((*lead, d)), torch.eye(d).expand(*lead, d, d).contiguous(),
        seeds, 0, torch.zeros(lead, dtype=torch.int32), None)
    total = niter + 1
    while state.step < total:
        nmax = min(spc, total - state.step)
        block = torch.cat([g._draw(state, b, j) for j in range(spc)], dim=-2)
        if replicas:
            mean, f, n = bfm.eps_batch_multistep_reference(
                score_fn, params, nmax, block, state.mean, state.factor,
                batch=b, iters=g._iters(b))
        else:
            mean, f, n = fs.eps_multistep_reference(
                score_fn, params, nmax, block, state.mean, state.factor,
                batch=b, iters=g._iters(b))
        state = state._replace(mean=mean, factor=f, step=state.step + nmax,
                               n_accepted=state.n_accepted + n)
    return state.mean, state.factor, state.n_accepted


def test_fit_and_fit_batch_equal_the_cat_draw_path(kernel_paths):
    """D=16, B=4, 45 steps at spc=8 (five full blocks and a remainder of
    5): the in-place draws give the state the cat-assembled blocks gave,
    bit for bit, and each fit_batch replica equals its single fit."""
    d, b, niter, seeds = 16, 4, 44, (3, 0, 11)
    t = dense_gaussian(2, d, scale=0.5, device=DEV)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device=DEV)
    assert g._fused_mode(b) == "step"
    st = g.fit(seeds[0], batch_size=b, niter=niter, verbose=False,
               return_state=True)
    mean, f, n = _parent_fit(g, seeds[0], b, niter)
    assert torch.equal(st.mean, mean) and torch.equal(st.factor, f)
    assert int(st.n_accepted) == int(n)
    sb = g.fit_batch(seeds, batch_size=b, niter=niter, return_state=True,
                     small_solver="fused")
    means, fs_, ns = _parent_fit(g, seeds, b, niter)
    assert torch.equal(sb.mean, means) and torch.equal(sb.factor, fs_)
    assert sb.n_accepted.tolist() == ns.tolist()
    for i, seed in enumerate(seeds):
        si = g.fit(seed, batch_size=b, niter=niter, verbose=False,
                   return_state=True)
        assert torch.equal(sb.mean[i], si.mean)
        assert torch.equal(sb.factor[i], si.factor)
        assert int(sb.n_accepted[i]) == int(si.n_accepted)


def test_a_returned_state_keeps_its_values(kernel_paths):
    """The runner draws every block into one persistent eps block; the
    state one block returns is unchanged after the next block runs."""
    d, b = 16, 4
    t = dense_gaussian(2, d, scale=0.5, device=DEV)
    g = FactorGSM(d, t.lp, t.lp_g, fused_score=t.fused_score,
                  steps_per_call=8, device=DEV)
    runner = g._get_runner(b, "step")
    eps = runner.blocks.eps_block(DEV)
    zero = torch.zeros((), dtype=torch.int32)
    s0 = t_gf.FactorVIState(torch.zeros(d), torch.eye(d), 5, 0, zero, zero)
    s1 = runner(s0, 8)
    held = (s1.mean.clone(), s1.factor.clone(), s1.n_accepted.clone())
    s2 = runner(s1, 8)
    assert runner.blocks.eps_block(DEV) is eps
    assert torch.equal(eps[7 * b:], _randn(5, 15, b, d))
    assert torch.equal(s1.mean, held[0]) and torch.equal(s1.factor, held[1])
    assert torch.equal(s1.n_accepted, held[2])
    assert not torch.equal(s2.mean, s1.mean)


# ---------------------------------------------------------------------------
# The graph control flow, on a stand-in library and a stand-in capture
# ---------------------------------------------------------------------------

class _Card:
    """Stands in for the kernel library (records each launch) and for the
    CUDA graph capture (runs the body once, recording its launches as
    captured; a replay records nothing)."""

    def __init__(self):
        self.calls = []
        self.captured = []
        self.replays = 0
        self.fail = None

    def call(self, name, *args):
        self.calls.append(name)

    def size(self, name, *args):
        return 16

    def capture(self, body):
        start = len(self.calls)
        body()
        if self.fail is not None:
            raise self.fail
        self.captured.append(self.calls[start:])
        del self.calls[start:]
        card = self

        class Graph:
            def replay(self):
                card.replays += 1

        return Graph()


@pytest.fixture
def card(monkeypatch):
    rec = _Card()
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: rec)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_capture_graph", rec.capture)
    fs.reset_launch_counts()
    yield rec
    fs.reset_launch_counts()


def _problem(b=4, d=16, spc=8, k=None):
    lead = () if k is None else (k,)
    params = (torch.zeros((1, d)), torch.eye(d))
    if k is None:
        step = fs.make_fused_eps_multistep(fs.gaussian_score, 2, b, d, spc)
    else:
        step = bfm.make_fused_eps_batch_multistep(fs.gaussian_score, 2, b, d,
                                                  k, spc)
    return (step, params, torch.zeros((*lead, spc * b, d)),
            torch.zeros((*lead, d)), torch.eye(d).expand(*lead, d, d)
            .contiguous())


SUB_STEP = ["gsmvi_thin_rows", "gsmvi_thin_score", "gsmvi_thin_rows",
            "gsmvi_thin_rows", "gsmvi_eps_smallspace_cluster",
            "gsmvi_factor_apply"]


@pytest.mark.parametrize("k", [None, 3])
def test_full_blocks_capture_once_then_replay(card, k):
    spc = 8
    step, params, block, mean, f = _problem(spc=spc, k=k)
    for _ in range(3):
        step(spc, block, mean, f, *params)
    # The first block ran eagerly and captured; the next two only replayed.
    assert card.calls == SUB_STEP * spc
    assert card.captured == [SUB_STEP * spc] and card.replays == 2
    graph_counts = fs.launch_counts()
    fs.reset_launch_counts()
    card.calls.clear()
    for _ in range(3):
        step(spc, block, mean, f, *params, graph=False)
    assert card.calls == SUB_STEP * spc * 3 and card.replays == 2
    assert fs.launch_counts() == graph_counts
    name = ("make_fused_eps_multistep" if k is None
            else "make_fused_eps_batch_multistep")
    assert graph_counts[name] == 3
    assert graph_counts["gaussian_score"] == 3 * spc
    assert graph_counts["thin_product"] == 9 * spc


def test_remainder_blocks_capture_nothing(card):
    step, params, block, mean, f = _problem(spc=8)
    for nmax in (0, 1, 5, 7):
        step(nmax, block, mean, f, *params)
    assert card.captured == [] and card.replays == 0
    assert card.calls == SUB_STEP * (1 + 5 + 7)
    assert fs.launch_counts()["make_fused_eps_multistep"] == 3


def test_graphs_are_keyed_on_param_addresses_and_bounded(card):
    spc = 2
    step, params, block, mean, f = _problem(spc=spc)
    step(spc, block, mean, f, *params)
    params[0].add_(1.0)                       # new contents, same address
    step(spc, block, mean, f, *params)
    assert len(card.captured) == 1 and card.replays == 1
    keep = [tuple(p.clone() for p in params)
            for _ in range(fs.GRAPH_CACHE_SIZE + 2)]
    for other in keep:
        step(spc, block, mean, f, *other)
    assert len(card.captured) == 1 + len(keep)
    assert len(step._graphs) == fs.GRAPH_CACHE_SIZE
    # The first params' graph went first: they capture again.
    step(spc, block, mean, f, *params)
    assert len(card.captured) == 2 + len(keep)


def test_a_failed_capture_raises_naming_the_score(card):
    spc = 4
    step, params, block, mean, f = _problem(spc=spc)
    card.fail = RuntimeError("operation not permitted when stream is "
                             "capturing")
    with pytest.raises(RuntimeError, match="gaussian_score could not be "
                                           "captured"):
        step(spc, block, mean, f, *params)
    counts = fs.launch_counts()
    # The eager warm-up counts; the failed capture adds nothing.
    assert counts["gaussian_score"] == spc
    assert counts["make_fused_eps_multistep"] == 1
    assert step.captures == 0 and step._graphs == {}


def test_the_returned_tensors_are_copies(card):
    spc = 2
    step, params, block, mean, f = _problem(spc=spc)
    outs = [step(spc, block, mean, f, *params) for _ in range(2)]
    bufs = step._bufs[torch.device(DEV)]
    for m, f_, n in outs:
        assert m.data_ptr() != bufs.mean.data_ptr()
        assert f_.data_ptr() != bufs.f.data_ptr()
        assert n.data_ptr() != bufs.acc.data_ptr()
    assert outs[0][1].data_ptr() != outs[1][1].data_ptr()
    # The caller's own eps block is copied in; the persistent one is not.
    assert step.eps_block(DEV) is bufs.eps
