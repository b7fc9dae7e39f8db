"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; without a card the run prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import manifest, run

ROOT = manifest.ROOT


def _python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_a_run_loads_no_jax():
    """The harness, the program and the reference, driven through a whole
    run on the CPU in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or gsmvi_tpu."""
    code = (
        "import json, sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "import portbench.run as run, portbench.control, portbench.trace\n"
        "from portbench import manifest\n"
        "bench = manifest.load()\n"
        "cell, cfg = manifest.cell(bench, 'bam_gauss256.fit_b128')\n"
        "cfg = dict(cfg, dim=8)\n"
        "cell = dict(cell, job=dict(cell['job'], batch_size=4, niter=50),"
        " warmup_niter=3, check_fits=1)\n"
        "run.run_cell(bench, cell, cfg, 5, 0.1, False, device='cpu',"
        " t_start=time.perf_counter())\n"
        "print(json.dumps({'tops': sorted({m.split('.')[0] for m in "
        "sys.modules}), 'found': run.forbidden_modules()}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gsmvi_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "gsmvi_tpu"} & set(got["tops"])
    assert got["found"] == []


def test_names_are_compared_whole():
    code = (
        "import sys, types\n"
        "from portbench import run\n"
        "for name in ['gsmvi_tpu_torch.x', 'jaxtyping', 'flaxen', "
        "'jax_utils']:\n"
        "    sys.modules[name] = types.ModuleType(name)\n"
        "print(run.forbidden_modules())\n"
        "sys.modules['gsmvi_tpu.models'] = types.ModuleType('m')\n"
        "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
        "print(run.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.strip().splitlines()
    assert first == "[]"
    assert second == "['gsmvi_tpu', 'jaxlib']"


def test_no_card_no_result():
    """Here there is no CUDA card: the run exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "gsm_gauss256.fit_b32", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_run_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run: the set-up fails, so no run there can print a result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = (
        "import time\n"
        "from portbench import manifest, run\n"
        "bench = manifest.load()\n"
        "cell, cfg = manifest.cell(bench, 'gsm_gauss256.fit_b32')\n"
        "run.run_cell(bench, cell, dict(cfg, dim=8), 5, 0.1, False, "
        "device='cpu', t_start=time.perf_counter())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _python(code, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "gsmvi_tpu_torch" in out.stderr
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "gsmvi_tpu")
