"""On the card: one short run of each cell through ``BENCHMARK.json``'s
command, and its result line.  Skipped without a CUDA card (decided inside the
test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import manifest

BENCH = manifest.load()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_card(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [*BENCH["command"], "--workload", cell, "--seed", "2147483999",
         "--seconds", "3", "--trace", str(traced)], cwd=manifest.ROOT,
        capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "compared"
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu"
    section = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in manifest.metrics(BENCH, section, cell)}
    assert set(res["metrics"]) == want
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
