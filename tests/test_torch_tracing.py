"""The port's spans and counters (``gsmvi_tpu_torch/utils/profiling.py``).

- Without a profiler ``span`` returns one shared no-op context and nothing
  is recorded; under ``torch.profiler`` (CPU activity) a public fit call
  gives one ``gsmvi.fit`` span holding ``gsmvi.fit.setup``,
  ``gsmvi.fit.loop`` and ``gsmvi.fit.finish`` in that order, also when
  ``GSM`` hands the fit to ``FactorGSM``; the block spans lie in the loop.
- ``fit_counts["steps"]`` is ``niter + 1`` for every fitter's ``fit`` and
  K (niter + 1) for ``fit_batch``, on the plain routes and on the kernel
  routes (``on_gpu`` monkeypatched: the wrappers run their plain versions
  on CPU tensors); draws count the generator's seedings.
- ``recent_fits()`` is bounded, keeps the newest last and takes one record
  per public call, a nested call inside its outer call's record.
- The graph counters on a stand-in kernel library and capture: a K2 fit
  captures once on its first fit and replays every later full block.
- On the card (``TESTS_ON_GPU=1``, else skipped): the same graph counts,
  K8's one report read per kernel call, and no ``gsmvi.`` record among the
  profiler's device operations.
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gsmvi_tpu_torch.advi as t_advi
import gsmvi_tpu_torch.bam_factor as t_bf
import gsmvi_tpu_torch.gsm_factor as t_gf
from gsmvi_tpu_torch import (ADVI, GSM, Adam, BaM, FactorBaM, FactorGSM,
                             Regularizers)
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.ops import fused_step as fs
from gsmvi_tpu_torch.utils import profiling, recent_fits, span

DEV = "cpu"
D, B, NITER = 6, 4, 20
SEEDS = (3, 0, 17)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _target(device=DEV):
    return dense_gaussian(1, D, scale=0.5, device=device)


def _program_spans(prof) -> list:
    """The port's host spans, (name, start, end), in start order."""
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("gsmvi.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = span("gsmvi.fit")
    assert first is profiling.NO_SPAN and span("gsmvi.block.draw") is first
    with first as entered:
        assert entered is first
    t = _target()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    GSM(D, t.lp, t.lp_g, device=DEV).fit(0, batch_size=B, niter=3,
                                          verbose=False)
    assert _program_spans(prof) == []


def _fit_gsm(t):
    GSM(D, t.lp, t.lp_g, device=DEV, use_factor=True,
        fused_score=t.fused_score).fit(0, batch_size=B, niter=NITER,
                                        verbose=False)


def _fit_factor_bam(t):
    FactorBaM(D, t.lp, t.lp_g, device=DEV, fused_score=t.fused_score).fit(
        0, Regularizers().linear(10.0), batch_size=B, niter=NITER,
        verbose=False)


@pytest.mark.parametrize("fit", [_fit_gsm, _fit_factor_bam],
                         ids=["GSM", "FactorBaM"])
def test_a_fit_is_one_span_with_its_three_phases(fit):
    t = _target()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit(t)
    spans = _program_spans(prof)
    fits = [s for s in spans if s[0] == "gsmvi.fit"]
    assert len(fits) == 1
    _, start, end = fits[0]
    phases = [s for s in spans if s[0].startswith("gsmvi.fit.")]
    assert [p[0] for p in phases] == ["gsmvi.fit.setup", "gsmvi.fit.loop",
                                      "gsmvi.fit.finish"]
    assert all(start <= s <= e <= end for _, s, e in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_utils_trace_writes_the_program_spans(tmp_path):
    """``utils.trace(logdir)``'s Chrome trace holds a fit's spans."""
    import json

    t = _target()
    with profiling.trace(str(tmp_path)):
        _fit_gsm(t)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gsmvi.fit", "gsmvi.fit.setup", "gsmvi.fit.loop",
            "gsmvi.fit.finish"} <= names


def test_the_block_spans_lie_in_the_loop(monkeypatch):
    """FactorGSM's K2 route (plain version on the CPU): per block a draw
    span and a launch span, all inside the loop phase."""
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    t = _target()
    g = FactorGSM(D, t.lp, t.lp_g, device=DEV, fused_score=t.fused_score,
                  steps_per_call=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.fit(0, batch_size=B, niter=NITER, verbose=False)
    spans = _program_spans(prof)
    (loop,) = [s for s in spans if s[0] == "gsmvi.fit.loop"]
    blocks = -(-(NITER + 1) // 8)
    for name in ("gsmvi.block.draw", "gsmvi.block.launch"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == blocks
        assert all(loop[1] <= s <= e <= loop[2] for _, s, e in inner)


def _steps_cases():
    """(id, route patch, run(t) -> (fitter, replicas))."""
    regf = Regularizers().linear(10.0)

    def gsm(t):
        g = GSM(D, t.lp, t.lp_g, device=DEV)
        g.fit(1, batch_size=B, niter=NITER, verbose=False)
        return g, 1

    def gsm_batch(t):
        g = GSM(D, t.lp, t.lp_g, device=DEV)
        g.fit_batch(SEEDS, batch_size=B, niter=NITER)
        return g, len(SEEDS)

    def factor_gsm(spc=8, mode_score=True):
        def run(t):
            g = FactorGSM(D, t.lp, t.lp_g, device=DEV, steps_per_call=spc,
                          fused_score=t.fused_score if mode_score else None)
            g.fit(1, batch_size=B, niter=NITER, verbose=False)
            return g, 1
        return run

    def factor_gsm_batch(solver):
        def run(t):
            g = FactorGSM(D, t.lp, t.lp_g, device=DEV,
                          fused_score=t.fused_score)
            g.fit_batch(SEEDS, batch_size=B, niter=NITER,
                        small_solver=solver)
            return g, len(SEEDS)
        return run

    def bam(t):
        g = BaM(D, t.lp, t.lp_g, device=DEV)
        g.fit(1, regf, batch_size=B, niter=NITER, verbose=False)
        return g, 1

    def bam_batch(t):
        g = BaM(D, t.lp, t.lp_g, device=DEV)
        g.fit_batch(SEEDS, regf, batch_size=B, niter=NITER)
        return g, len(SEEDS)

    def factor_bam(score):
        def run(t):
            g = FactorBaM(D, t.lp, t.lp_g, device=DEV,
                          fused_score=t.fused_score if score else None)
            g.fit(1, regf, batch_size=B, niter=NITER, verbose=False)
            return g, 1
        return run

    def factor_bam_batch(t):
        g = FactorBaM(D, t.lp, t.lp_g, device=DEV)
        g.fit_batch(SEEDS, regf, batch_size=B, niter=NITER)
        return g, len(SEEDS)

    def advi(t):
        g = ADVI(D, t.lp, device=DEV)
        g.fit(1, Adam(1e-2), batch_size=B, niter=NITER, verbose=False)
        return g, 1

    def advi_batch(t):
        g = ADVI(D, t.lp, device=DEV)
        g.fit_batch(SEEDS, Adam(1e-2), batch_size=B, niter=NITER)
        return g, len(SEEDS)

    def advi_fused(estimator):
        def run(t):
            g = ADVI(D, t.lp, device=DEV, fused_score=t.fused_score,
                     steps_per_call=8)
            g.fit_fused(1, batch_size=B, niter=NITER, verbose=False,
                        estimator=estimator)
            return g, 1
        return run

    return [
        ("GSM.fit", None, gsm), ("GSM.fit_batch", None, gsm_batch),
        ("FactorGSM.fit-plain", None, factor_gsm()),
        ("FactorGSM.fit-K1", t_gf, factor_gsm(mode_score=False)),
        ("FactorGSM.fit-K2", t_gf, factor_gsm(spc=8)),
        ("FactorGSM.fit-K4", t_gf, factor_gsm(spc=1)),
        ("FactorGSM.fit_batch-K1", t_gf, factor_gsm_batch("auto")),
        ("FactorGSM.fit_batch-K6", t_gf, factor_gsm_batch("fused")),
        ("BaM.fit", None, bam), ("BaM.fit_batch", None, bam_batch),
        ("FactorBaM.fit-plain", None, factor_bam(False)),
        ("FactorBaM.fit-K7", t_bf, factor_bam(False)),
        ("FactorBaM.fit-K8", t_bf, factor_bam(True)),
        ("FactorBaM.fit_batch-K7", t_bf, factor_bam_batch),
        ("ADVI.fit", None, advi), ("ADVI.fit_batch", None, advi_batch),
        ("ADVI.fit_fused-K9", t_advi, advi_fused("analytic")),
        ("ADVI.fit_fused-K10", t_advi, advi_fused("stl")),
    ]


@pytest.mark.parametrize("case", _steps_cases(), ids=lambda c: c[0])
def test_steps_count_every_update(monkeypatch, case):
    """``steps`` is niter + 1 a replica on every route; the kernel routes
    count their calls; each draw is one generator seeding (retries and
    resampling draw more)."""
    name, module, run = case
    if module is not None:
        monkeypatch.setattr(module, "on_gpu", lambda device: True)
    fitter, k = run(_target())
    counts = fitter.fit_counts
    assert counts["steps"] == k * (NITER + 1), counts
    assert counts["draws"] >= k * (NITER + 1)
    assert counts["runner_builds"] >= 1
    assert counts["graph_replays"] == counts["graph_captures"] == 0
    kernel = module is not None and not name.endswith("plain")
    assert (counts["kernel_calls"] > 0) == kernel, counts
    record = recent_fits()[-1]
    assert record["fitter"] == name.split(".")[0]
    assert {k_: v for k_, v in record.items() if k_ != "fitter"} == counts


def test_k8_reads_one_report_a_call(monkeypatch):
    """FactorBaM's K8 route (its plain version on the CPU): one report read
    per kernel call, the steps the reports say plus the replayed ones."""
    monkeypatch.setattr(t_bf, "on_gpu", lambda device: True)
    fitter, _ = dict((c[0], c[2]) for c in _steps_cases())[
        "FactorBaM.fit-K8"](_target())
    counts = fitter.fit_counts
    assert counts["kernel_calls"] == counts["report_reads"] > 0
    assert counts["steps"] == NITER + 1


def test_counts_reset_at_each_call_and_repeat():
    t = _target()
    g = FactorBaM(D, t.lp, t.lp_g, device=DEV)
    regf = Regularizers().linear(10.0)
    g.fit(1, regf, batch_size=B, niter=NITER, verbose=False)
    first = dict(g.fit_counts)
    g.fit(1, regf, batch_size=B, niter=NITER, verbose=False)
    assert g.fit_counts == dict(first, runner_builds=0)


def test_recent_fits_is_bounded_and_keeps_the_newest_last():
    t = _target()
    g = GSM(D, t.lp, t.lp_g, device=DEV, use_factor=True)
    n = profiling.RECENT_FITS
    for i in range(n + 3):
        g.fit(i, batch_size=B, niter=i % 3, verbose=False)
    records = recent_fits()
    assert len(records) == n
    # One record per public call; the FactorGSM call nested in GSM's is
    # GSM's record.
    assert [r["steps"] for r in records[-3:]] == [
        (i % 3) + 1 for i in range(n, n + 3)]
    assert all(r["fitter"] == "GSM" for r in records)
    records[-1]["steps"] = -1
    assert recent_fits()[-1]["steps"] == (n + 2) % 3 + 1


def test_a_failed_call_leaves_no_record():
    t = _target()
    g = FactorGSM(D, t.lp, lambda x: x.cpu().numpy(), device=DEV)
    before = recent_fits()
    with pytest.raises(TypeError):
        g.fit(0, batch_size=B, niter=2, verbose=False)
    assert recent_fits() == before
    GSM(D, t.lp, t.lp_g, device=DEV).fit(0, batch_size=B, niter=2,
                                          verbose=False)
    assert recent_fits()[-1]["fitter"] == "GSM"


class _Card:
    """Stands in for the kernel library (launches do nothing) and the graph
    capture (runs the body once; a replay runs nothing)."""

    def call(self, name, *args):
        pass

    def size(self, name, *args):
        return 16

    def capture(self, body):
        body()

        class Graph:
            def replay(self):
                pass

        return Graph()


def test_graph_counts_of_a_k2_fit_on_a_stand_in_card(monkeypatch):
    """The first fit's first full block runs eagerly and captures; every
    later full block replays, on that fit and on a repeat, which captures
    nothing and builds no runner."""
    card = _Card()
    monkeypatch.setattr(t_gf, "on_gpu", lambda device: True)
    monkeypatch.setattr(fs, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fs, "_library", lambda: card)
    monkeypatch.setattr(fs, "_stream", lambda device: None)
    monkeypatch.setattr(fs, "_capture_graph", card.capture)
    t = _target()
    spc, niter = 8, 3 * 8 + 4
    g = FactorGSM(D, t.lp, t.lp_g, device=DEV, fused_score=t.fused_score,
                  steps_per_call=spc)
    full = (niter + 1) // spc
    g.fit(0, batch_size=B, niter=niter, verbose=False)
    first = dict(g.fit_counts)
    g.fit(1, batch_size=B, niter=niter, verbose=False)
    again = dict(g.fit_counts)
    assert first["graph_captures"] == 1 and first["runner_builds"] == 1
    assert first["graph_replays"] == full - 1
    assert again["graph_captures"] == again["runner_builds"] == 0
    assert again["graph_replays"] == full
    assert first["kernel_calls"] == again["kernel_calls"] == full + 1
    assert first["steps"] == again["steps"] == niter + 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if os.environ.get("TESTS_ON_GPU", "") in ("", "0", "false", "False"):
        pytest.skip("needs an NVIDIA GPU: run with TESTS_ON_GPU=1")
    if not torch.cuda.is_available():
        pytest.fail("TESTS_ON_GPU=1 but torch sees no CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_k2_graph_counts_on_the_card(cuda):
    t = dense_gaussian(1, 64, scale=0.5, device=cuda)
    g = FactorGSM(64, t.lp, t.lp_g, device=cuda, fused_score=t.fused_score,
                  steps_per_call=8)
    niter = 100
    full = (niter + 1) // 8
    g.fit(0, batch_size=16, niter=niter, verbose=False)
    first = dict(g.fit_counts)
    g.fit(1, batch_size=16, niter=niter, verbose=False)
    again = dict(g.fit_counts)
    assert (first["graph_captures"], first["graph_replays"]) == (1, full - 1)
    assert (again["graph_captures"], again["graph_replays"]) == (0, full)
    assert first["steps"] == again["steps"] == niter + 1


@pytest.mark.gpu
def test_k8_report_reads_on_the_card(cuda):
    t = dense_gaussian(1, 64, scale=0.5, device=cuda)
    g = FactorBaM(64, t.lp, t.lp_g, device=cuda, fused_score=t.fused_score)
    g.fit(0, Regularizers().linear(100.0), batch_size=32, niter=100,
          verbose=False)
    counts = g.fit_counts
    assert counts["kernel_calls"] == counts["report_reads"] > 0
    assert counts["steps"] == 101


@pytest.mark.gpu
def test_no_program_span_among_the_device_operations(cuda):
    """The spans are host records: none of them comes back as a device
    operation (a record on the card's timeline that is not a mirrored
    user annotation)."""
    from torch.autograd import DeviceType

    t = dense_gaussian(1, 64, scale=0.5, device=cuda)
    g = GSM(64, t.lp, t.lp_g, device=cuda, fused_score=t.fused_score)
    b = FactorBaM(64, t.lp, t.lp_g, device=cuda, fused_score=t.fused_score)
    g.fit(0, batch_size=16, niter=20, verbose=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.fit(1, batch_size=16, niter=40, verbose=False)
        b.fit(1, Regularizers().linear(100.0), batch_size=32, niter=40,
              verbose=False)
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    assert {"gsmvi.fit", "gsmvi.fit.loop", "gsmvi.block.launch",
            "gsmvi.block.report"} <= host
    device = [e.name for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    assert device and not [n for n in device if n.startswith("gsmvi.")]
