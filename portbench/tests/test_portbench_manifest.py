"""BENCHMARK.json against its schema's static rules, and discovery by
name: a cell, a configuration and a metric added as new files only."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import check, manifest

ROOT = manifest.ROOT
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    for section in ("configs", "workloads"):
        seen = [e["name"] for e in BENCH[section]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec, config = manifest.cell(BENCH, cell)
    assert spec["name"] == cell and config["name"] == spec["config"]
    assert set(spec["limits"]) == set(check.NUMBERS)
    assert spec["check_steps"] and min(spec["check_steps"]) >= 1
    work = manifest.work(config["name"])
    b, d = spec["job"]["batch_size"], config["dim"]
    assert work.step_flops(b, d) > 0
    manifest.target(config["target"]["recipe"])
    manifest.reference(config["reference"])
    end = manifest.metrics(BENCH, "end_to_end", cell)
    assert "setup_s" in {m["name"] for m in end} and len(end) >= 2
    layer = manifest.metrics(BENCH, "per_layer", cell)
    assert layer and all(m["moves"] in {e["name"] for e in end}
                         for m in layer)
    for m in end + layer:
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _digest(root: Path) -> dict:
    files = [p for p in sorted(root.rglob("*"))
             if p.is_file() and "__pycache__" not in p.parts]
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    """In a copy of the benchmark, add a configuration, a cell on it and a
    per-layer metric as new files and entries in BENCHMARK.json; the harness
    finds and runs them (on the CPU, at a tiny size) with every file that
    was there unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(tmp_path / "portbench")
    base = tmp_path / "portbench"
    cfg = json.loads((base / "configs" / "gsm_gauss256.json").read_text())
    cfg.update(name="gsm_gauss8", dim=8)
    (base / "configs" / "gsm_gauss8.json").write_text(json.dumps(cfg))
    shutil.copy(base / "work" / "gsm_gauss256.py",
                base / "work" / "gsm_gauss8.py")
    cell = json.loads((base / "workloads" / "gsm_gauss256.fit_b32.json")
                      .read_text())
    cell.update(name="gsm_gauss8.fit_b4", config="gsm_gauss8",
                traffic="fit_b4", warmup_niter=3, check_fits=2,
                job=dict(cell["job"], batch_size=4, niter=200),
                limits={k: 1e-3 for k in check.NUMBERS})
    (base / "workloads" / "gsm_gauss8.fit_b4.json").write_text(
        json.dumps(cell))
    (base / "metrics" / "jobs_traced.py").write_text(
        '"""Jobs in the traced window."""\n\n\n'
        'def read(trace):\n    return float(trace.jobs)\n')
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gsm_gauss8", "source": "test",
                             "file": "portbench/configs/gsm_gauss8.json",
                             "reduced": ["dim"], "why": "test"})
    bench["workloads"].append({"name": "gsm_gauss8.fit_b4",
                               "config": "gsm_gauss8", "traffic": "fit_b4",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "jobs_traced", "unit": "jobs",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "fit_steps_per_s",
                               "workloads": ["gsm_gauss8.fit_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import manifest, run, trace\n"
        "bench = manifest.load()\n"
        "cell, cfg = manifest.cell(bench, 'gsm_gauss8.fit_b4')\n"
        "res = run.run_cell(bench, cell, cfg, 2**31 + 9, 0.3, False, "
        "device='cpu', t_start=time.perf_counter())\n"
        "names = [m['name'] for m in manifest.metrics(bench, 'per_layer', "
        "'gsm_gauss8.fit_b4')]\n"
        "t = trace.Trace([], [], {}, 1.0, 10, 3, cell, cfg)\n"
        "print(json.dumps({'res': res, 'names': names, "
        "'jobs': manifest.reader('jobs_traced')(t)}))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["res"]["correct"] is True
    assert set(got["res"]["metrics"]) == {"fit_steps_per_s", "fit_s_p95",
                                          "setup_s"}
    assert "jobs_traced" in got["names"] and got["jobs"] == 3.0
    after = _digest(base)
    assert {k: after[k] for k in before} == before
