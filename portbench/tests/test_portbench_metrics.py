"""The metric readers on a synthetic profiler record."""

from __future__ import annotations

import json

import pytest

from portbench import manifest, peaks, trace as tr
from portbench.window import Window

BENCH = manifest.load()


def _trace(**kw):
    cell, config = manifest.cell(BENCH, "gsm_gauss256.fit_b32")
    # Two steps of 100 us each: a thin product, the small space, a
    # mma product that is not a thin_kernel, and a gap of 20 us.
    device = [
        ("void thin_kernel<2>(ThinArgs)", 0.0, 4.0),
        ("void eps_cluster_kernel<3>(ClusterArgs)", 5.0, 70.0),
        ("void thin_mma_kernel<1>(ThinMmaArgs)", 70.0, 72.0),
        ("void thin_kernel<2>(ThinArgs)", 80.0, 84.0),
        ("void eps_cluster_kernel<3>(ClusterArgs)", 83.0, 150.0),
        ("Memcpy DtoH (Device -> Pageable)", 180.0, 200.0),
    ]
    host = [
        ("portbench.job", -10.0, 210.0),
        ("aten::normal_", 150.0, 170.0),
        ("cudaGraphLaunch", 72.0, 78.0),
    ]
    runtime = {"cudaLaunchKernel": 3, "cudaLaunchKernelExC_v11060": 2,
               "cudaGraphLaunch": 1, "cudaMemcpyAsync": 1,
               "cudaStreamSynchronize": 1}
    base = dict(device=device, host=host, runtime=runtime, window_s=200e-6,
                steps=2, jobs=1, cell=cell, config=config,
                work=manifest.work("gsm_gauss256"))
    base.update(kw)
    return tr.Trace(**base)


def test_busy_is_the_union():
    t = _trace()
    # [0,4] [5,72] [80,150] [180,200]
    assert tr.busy_s(t.device) == pytest.approx((4 + 67 + 70 + 20) * 1e-6)


def test_kernel_names_match_whole_words():
    t = _trace()
    assert len(t.kernels(["thin_kernel"])) == 2
    assert len(t.kernels(["eps_cluster_kernel"])) == 2
    assert len(t.kernels(["thin_mma_kernel"])) == 1
    assert t.kernels(["cluster_kernel"]) == []


def test_device_idle():
    t = _trace()
    got = manifest.reader("device_idle_pct")(t)
    assert got == pytest.approx(100 * (1 - 161 / 200))


def test_host_launches_per_step():
    got = manifest.reader("host_launches_per_step")(_trace())
    assert got == pytest.approx((3 + 2 + 1) / 2)


def test_step_mfu():
    t = _trace()
    flops = t.work.step_flops(32, 256) * 2
    got = manifest.reader("step_mfu_pct")(t)
    assert got == pytest.approx(100 * flops / 200e-6 / peaks.FP32_FLOPS)


def test_rooflines():
    t = _trace()
    fl, nb = t.work.smallspace(32, 256)
    per_update = (65 + 67) * 1e-6 / 2
    got = manifest.reader("smallspace_roofline_pct")(t)
    assert got == pytest.approx(100 * peaks.roofline_s(fl, nb) / per_update)
    fl, nb = t.work.rowprod(32, 256)
    got = manifest.reader("rowprod_roofline_pct")(t)
    assert got == pytest.approx(100 * peaks.roofline_s(fl, nb) / 4e-6)
    assert 0 < got < 100


@pytest.mark.parametrize("metric", ["device_idle_pct",
                                    "host_launches_per_step",
                                    "step_mfu_pct",
                                    "smallspace_roofline_pct",
                                    "rowprod_roofline_pct"])
def test_nothing_to_read_gives_none(metric):
    empty = _trace(device=[], runtime={}, steps=0, window_s=0.0)
    assert manifest.reader(metric)(empty) is None


def test_roofline_without_its_kernels_gives_none():
    t = _trace(device=[("void gram_kernel(GramArgs)", 0.0, 5.0)])
    assert manifest.reader("smallspace_roofline_pct")(t) is None
    assert manifest.reader("rowprod_roofline_pct")(t) is None


def test_breakdown():
    got = tr.breakdown(_trace())
    ops = dict(got["device_ops"])
    assert ops["eps_cluster_kernel<3>(ClusterArgs)"] == pytest.approx(132e-6)
    assert got["device_ops"][0][0] == "eps_cluster_kernel<3>(ClusterArgs)"
    gaps = dict(got["idle_gaps"])
    # Gaps: (4, 5) in portbench.job, (72, 80) in cudaGraphLaunch,
    # (150, 180) in aten::normal_ (its middle, 165, is inside it).
    assert gaps == pytest.approx({"portbench.job": 1e-6,
                                  "cudaGraphLaunch": 8e-6,
                                  "aten::normal_": 30e-6})
    assert got["idle_gaps"][0][0] == "aten::normal_"
    json.dumps(got)


def test_end_to_end_readers():
    jobs = [(0.0, 0.3, 3001), (0.31, 0.62, 3001), (0.63, 1.0, 3001)]
    w = Window(jobs, 9.5)
    assert manifest.reader("fit_steps_per_s")(w) == pytest.approx(9003.0)
    assert manifest.reader("fit_s_p95")(w) == pytest.approx(0.37)
    assert manifest.reader("setup_s")(w) == 9.5
    assert manifest.reader("fit_steps_per_s")(Window([], 1.0)) is None


def test_short_names():
    assert tr.short_name("void (anonymous namespace)::thin_kernel<true, 0>("
                         "(anonymous namespace)::ThinArgs)") == (
        "thin_kernel<true, 0>(ThinArgs)")
    assert len(tr.short_name("x" * 500)) == 96


def test_host_at_takes_the_innermost_open_record():
    host = [("job", 0.0, 100.0), ("a", 10.0, 20.0), ("b", 12.0, 15.0),
            ("c", 30.0, 40.0)]
    assert tr.host_at(host, [5.0, 11.0, 13.0, 17.0, 25.0, 35.0, 150.0]) == [
        "job", "a", "b", "a", "job", "c", None]


class _Range:
    def __init__(self, s, e):
        self.start, self.end = s, e


class _Event:
    def __init__(self, name, s, e, device, annotation=False):
        from torch.autograd import DeviceType

        self.name, self.time_range = name, _Range(s, e)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_records_leave_out_annotations_mirrored_on_the_device():
    prof = _Prof([
        _Event("portbench.job", 0, 100, device=False),
        _Event("portbench.job", 1, 99, device=True, annotation=True),
        _Event("portbench.job", 1, 99, device=True),
        _Event("user_span", 2, 50, device=True, annotation=True),
        _Event("void thin_kernel<1>(ThinArgs)", 3, 5, device=True),
        _Event("cudaLaunchKernel", 2, 3, device=False),
        _Event("cudaGraphLaunch", 6, 7, device=False),
        _Event("cudaDeviceSynchronize", 90, 99, device=False),
    ])
    device, host, runtime = tr.records(prof)
    assert device == [("void thin_kernel<1>(ThinArgs)", 3, 5)]
    assert [h[0] for h in host] == ["portbench.job", "cudaLaunchKernel",
                                    "cudaGraphLaunch",
                                    "cudaDeviceSynchronize"]
    assert runtime == {"cudaLaunchKernel": 1, "cudaGraphLaunch": 1}


def test_traced_run_on_a_stand_in_profile(monkeypatch):
    """A whole ``--trace 1`` run on the CPU, the profiler replaced by a
    record of two kernels a step, busy half of it: the per-layer line, busy
    and window."""
    import time

    from portbench import run
    from portbench.tests.conftest import tiny

    def stand_in(window, tries=3):
        jobs, answers = out = window()
        start, end = jobs[0][0] * 1e6, jobs[-1][1] * 1e6
        steps = sum(j[2] for j in jobs)
        step_us = (end - start) / steps
        events = [_Event("portbench.job", start, end, device=False),
                  _Event("cudaGraphLaunch", start, start + 1, device=False)]
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
    assert res["metrics"]["device_idle_pct"]["value"] == pytest.approx(
        50.0, abs=0.5)
    assert res["metrics"]["host_launches_per_step"]["value"] == pytest.approx(
        1 / (2 * 301))
    assert res["device"]["busy_s"] == pytest.approx(
        0.5 * res["device"]["window_s"], rel=1e-2)
    assert res["breakdown"]["device_ops"][0][0] == (
        "eps_cluster_kernel<2>(ClusterArgs)")
    assert list(res)[-2:] == ["breakdown", "compared"]
