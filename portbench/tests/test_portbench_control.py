"""The controls at a size a CPU test holds: the plain reference at TF32 in
the program's place, and with half of each step's batch left out, read far
above the program's own float32 answers, and limits between them refuse
both.  On the card the same readings at the cells' sizes, judged by the
cells' own limits, are ``python3 -m portbench.control`` (PERF.md gives
them)."""

from __future__ import annotations

import pytest
import torch

from portbench import check, control, manifest
from portbench.tests.conftest import tiny

BENCH = manifest.load()
LIMITS = {"mean_gap": 2e-3, "cov_gap": 2e-3, "step_mean_gap": 1e-3,
          "step_cov_gap": 1e-3}


@pytest.mark.parametrize("name", ["gsm_gauss256.fit_b32",
                                  "bam_gauss256.fit_b128"])
@pytest.mark.parametrize("seed", [5, 6])
def test_control_is_refused(name, seed):
    cell, config = tiny(*manifest.cell(BENCH, name), dim=32, batch=8,
                        niter=600)
    got = control.readings(cell, config, seed, torch.device("cpu"))
    assert check.verdict(got["program"], LIMITS)
    for kind in ("control_tf32", "half_batch"):
        assert not check.verdict(got[kind], LIMITS)
        assert any(got[kind][k] >= 3 * got["program"][k]
                   for k in check.NUMBERS)
    assert got["half_batch"]["step_mean_gap"] > 1e-2
