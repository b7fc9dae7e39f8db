"""The readers of the program's own spans and counters, on synthetic host
spans and device records, and on the program's counters of CPU fits."""

from __future__ import annotations

import pytest

from portbench import manifest, program_trace as pt, trace as tr

BENCH = manifest.load()
SPAN_METRICS = ("fitapi_idle_pct", "fitloop_idle_pct", "steploop_idle_pct",
                "fit_fixed_ms")
COUNTER_METRICS = ("host_waits_per_step", "steps_run_pct",
                   "rebuilds_per_job")


def _trace(device, host, window_us=100.0, steps=10, jobs=1):
    cell, config = manifest.cell(BENCH, "gsm_gauss256.fit_b32")
    return tr.Trace(device=device, host=host, runtime={},
                    window_s=window_us * 1e-6, steps=steps, jobs=jobs,
                    cell=cell, config=config)


def _read(metric, trace):
    return manifest.reader(metric)(trace)


def test_a_gap_across_two_spans_splits_exactly():
    """Idle 10-30 us: 2 in the loop, 6 in the draws, 7 in the launch, 5 in
    the loop again; no share by the gap's middle."""
    device = [("void thin_kernel<1>(ThinArgs)", 0.0, 10.0),
              ("void thin_kernel<1>(ThinArgs)", 30.0, 40.0)]
    host = [("gsmvi.fit", 0.0, 40.0), ("gsmvi.fit.loop", 5.0, 40.0),
            ("gsmvi.block.draw", 12.0, 18.0),
            ("aten::normal_", 13.0, 17.0),
            ("gsmvi.block.launch", 18.0, 25.0)]
    t = _trace(device, host, window_us=40.0)
    by_span = pt.idle_by_span(t)
    assert by_span == pytest.approx({None: 0.0, "gsmvi.fit.loop": 7e-6,
                                     "gsmvi.block.draw": 6e-6,
                                     "gsmvi.block.launch": 7e-6})
    assert _read("fitloop_idle_pct", t) == pytest.approx(100 * 13 / 40)
    assert _read("steploop_idle_pct", t) == pytest.approx(100 * 7 / 40)
    assert _read("fitapi_idle_pct", t) == 0.0


def test_the_innermost_span_takes_the_gap():
    """A gap inside set-up within the fit call counts to set-up; the rest of
    a gap under the fit call alone counts to the fitter API; idle under no
    program span counts to none of the three."""
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0),
              ("k", 80.0, 90.0)]
    host = [("portbench.job", 0.0, 100.0), ("gsmvi.fit", 5.0, 70.0),
            ("gsmvi.fit.setup", 5.0, 15.0), ("gsmvi.fit.loop", 15.0, 40.0),
            ("gsmvi.block.launch", 22.0, 38.0), ("cudaMemcpyAsync", 31.0,
                                                  33.0)]
    t = _trace(device, host)
    by_span = pt.idle_by_span(t)
    # Gaps: 10-20 (set-up 10-15, loop 15-20), 30-50 (launch 30-38, loop
    # 38-40, the fit call 40-50), 60-80 (the fit call 60-70, none 70-80).
    assert by_span == pytest.approx({
        None: 10e-6, "gsmvi.fit.setup": 5e-6, "gsmvi.fit.loop": 7e-6,
        "gsmvi.block.launch": 8e-6, "gsmvi.fit": 20e-6})
    assert _read("fitapi_idle_pct", t) == pytest.approx(25.0)
    assert _read("fitloop_idle_pct", t) == pytest.approx(7.0)
    assert _read("steploop_idle_pct", t) == pytest.approx(8.0)
    total = sum(_read(m, t) for m in ("fitapi_idle_pct", "fitloop_idle_pct",
                                      "steploop_idle_pct"))
    gaps = 10 + 20 + 20
    assert total == pytest.approx(100 * (gaps - 10) / 100)
    assert total <= _read("device_idle_pct", t)


def test_innermost_segments():
    segs = pt.innermost([("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 4.0, 6.0),
                         ("d", 12.0, 14.0)])
    assert segs == [(0.0, 2.0, "a"), (2.0, 4.0, "b"), (4.0, 6.0, "c"),
                    (6.0, 10.0, "a"), (12.0, 14.0, "d")]


def test_fixed_cost_is_the_fit_call_less_its_loop():
    host = [("gsmvi.fit", 0.0, 100.0), ("gsmvi.fit.setup", 0.0, 10.0),
            ("gsmvi.fit.loop", 10.0, 90.0), ("gsmvi.fit", 200.0, 260.0),
            ("gsmvi.fit.loop", 205.0, 255.0)]
    t = _trace([("k", 0.0, 1.0)], host, window_us=300.0, jobs=2)
    assert _read("fit_fixed_ms", t) == pytest.approx((20 + 10) / 2 * 1e-3)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_program_span_gives_none(metric):
    """A program without spans (an older checkout) reads None: the run
    leaves the metric out."""
    t = _trace([("k", 0.0, 10.0), ("k", 20.0, 30.0)],
               [("portbench.job", 0.0, 30.0), ("aten::mm", 10.0, 20.0)])
    assert _read(metric, t) is None


def _records(monkeypatch, records):
    from gsmvi_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recent_fits", lambda: list(records))


def test_counters_read_the_window_jobs_records(monkeypatch):
    """The newest ``trace.jobs`` records are the window's jobs; older ones
    (the warm-up fit) are left out."""
    warm = {"fitter": "FactorBaM", "steps": 65, "report_reads": 9,
            "replays": 1, "retries": 0, "graph_captures": 0,
            "runner_builds": 1}
    job = {"fitter": "FactorBaM", "steps": 2001, "report_reads": 251,
           "replays": 3, "retries": 2, "graph_captures": 0,
           "runner_builds": 0}
    _records(monkeypatch, [warm, job, dict(job, graph_captures=1)])
    t = _trace([], [], steps=2 * 2001, jobs=2)
    assert _read("host_waits_per_step", t) == pytest.approx(
        2 * 256 / (2 * 2001))
    assert _read("steps_run_pct", t) == 100.0
    assert _read("rebuilds_per_job", t) == 0.5
    # A fit that skipped steps reads under 100.
    _records(monkeypatch, [job, dict(job, steps=2000)])
    assert _read("steps_run_pct", t) == pytest.approx(100 * 4001 / 4002)
    # GSM's records have no report key: no waits.
    _records(monkeypatch, [{"fitter": "GSM", "steps": 3001,
                            "graph_captures": 0, "runner_builds": 0}] * 2)
    assert _read("host_waits_per_step", _trace([], [], steps=6002,
                                                jobs=2)) == 0.0


@pytest.mark.parametrize("metric", COUNTER_METRICS)
def test_counters_without_records_give_none(monkeypatch, metric):
    from gsmvi_tpu_torch.utils import profiling

    t = _trace([], [], steps=20, jobs=2)
    _records(monkeypatch, [{"fitter": "GSM", "steps": 10}])
    assert _read(metric, t) is None
    monkeypatch.delattr(profiling, "recent_fits")
    assert _read(metric, t) is None


def test_the_program_counts_its_cpu_fits():
    """Two CPU fits of the port, as jobs: every step counted, nothing
    rebuilt after the first fit, no host wait on GSM's plain route."""
    import gsmvi_tpu_torch as port

    d, b, niter = 6, 4, 20
    target = port.dense_gaussian(1, d, scale=0.5, device="cpu")
    fitter = port.GSM(d, target.lp, target.lp_g, device="cpu")
    for seed in range(3):
        fitter.fit(seed, batch_size=b, niter=niter, verbose=False)
    t = _trace([], [], steps=2 * (niter + 1), jobs=2)
    assert _read("steps_run_pct", t) == 100.0
    assert _read("rebuilds_per_job", t) == 0.0
    assert _read("host_waits_per_step", t) == 0.0
    records = pt.fit_records(t)
    assert [r["fitter"] for r in records] == ["GSM", "GSM"]
    assert all(r["draws"] == niter + 1 for r in records)


def test_the_program_spans_reach_the_host_records():
    """Under a CPU profiler a port fit's spans come back among the host
    records of ``trace.records``, none among the device's."""
    from torch.profiler import ProfilerActivity, profile

    import gsmvi_tpu_torch as port

    d = 6
    target = port.dense_gaussian(1, d, scale=0.5, device="cpu")
    fitter = port.GSM(d, target.lp, target.lp_g, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fitter.fit(0, batch_size=4, niter=5, verbose=False)
    device, host, _ = tr.records(prof)
    names = [h[0] for h in host if h[0].startswith(pt.PREFIX)]
    assert names[0] == "gsmvi.fit"
    assert sorted(set(names)) == ["gsmvi.fit", "gsmvi.fit.finish",
                                  "gsmvi.fit.loop", "gsmvi.fit.setup"]
    assert not [r for r in device if r[0].startswith(pt.PREFIX)]


def test_traced_run_on_a_stand_in_profile_with_the_program_spans(
        monkeypatch):
    """A whole ``--trace 1`` run on the CPU, the profiler replaced by a
    record of two kernels a step, busy half of it, and the program's spans
    of each job's fit call: every per-layer metric of the cell reads, and
    the idle splits between the fit loop and the fitter API."""
    import time

    from portbench import run
    from portbench.tests.conftest import tiny
    from portbench.tests.test_portbench_metrics import _Event, _Prof

    def stand_in(window, tries=3):
        jobs, answers = out = window()
        start, end = jobs[0][0] * 1e6, jobs[-1][1] * 1e6
        steps = sum(j[2] for j in jobs)
        step_us = (end - start) / steps
        events = [_Event("portbench.job", start, end, device=False),
                  _Event("cudaGraphLaunch", start, start + 1, device=False)]
        # Each job's fit call, a hundredth of it set-up and a hundredth
        # finish, the loop between.
        for s, e, _ in jobs:
            s, e = s * 1e6, e * 1e6
            cut = 0.01 * (e - s)
            events += [_Event(name, a, b, device=False) for name, a, b in (
                ("gsmvi.fit", s, e), ("gsmvi.fit.setup", s, s + cut),
                ("gsmvi.fit.loop", s + cut, e - cut),
                ("gsmvi.fit.finish", e - cut, e))]
        for i in range(steps):
            t = start + i * step_us
            events += [_Event("void thin_kernel<1>(ThinArgs)", t,
                              t + 0.1 * step_us, device=True),
                       _Event("void eps_cluster_kernel<2>(ClusterArgs)",
                              t + 0.1 * step_us, t + 0.5 * step_us,
                              device=True)]
        return _Prof(events), out

    monkeypatch.setattr(tr, "profile_window", stand_in)
    cell, config = tiny(*manifest.cell(BENCH, "gsm_gauss256.fit_b32"),
                        trace_jobs=2)
    res = run.run_cell(BENCH, cell, config, 11, 1.0, True, device="cpu",
                       t_start=time.perf_counter())
    assert res["correct"] is True and res["attempted"] == 2
    assert set(res["metrics"]) == {
        m["name"] for m in manifest.metrics(BENCH, "per_layer",
                                            "gsm_gauss256.fit_b32")}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["device_idle_pct"] == pytest.approx(50.0, abs=0.5)
    assert got["steps_run_pct"] == 100.0 and got["rebuilds_per_job"] == 0.0
    assert got["host_waits_per_step"] == 0.0
    assert got["steploop_idle_pct"] == 0.0
    assert got["fitloop_idle_pct"] == pytest.approx(49.0, abs=1.0)
    assert got["fitapi_idle_pct"] == pytest.approx(1.0, abs=0.5)
    assert not [d for d in res["breakdown"]["device_ops"]
                if d[0].startswith(pt.PREFIX)]
