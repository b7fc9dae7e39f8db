"""Runs with the timed path broken underneath: ``correct`` has to come out
false.  Each drives a whole run on the CPU (the harness's look for a card
skipped) at a tiny size, with a fault planted in the program.

The faults: a step that returns its state unchanged; an answer altered where
the fitter produces it; the score altered where the target produces it; half
of each step's batch left out, the mean taken over the rest.  The last
converges to the same Gaussian, so only the reads before convergence
(``check_steps``) see it.  One card, so no exchange between cards to leave
out.
"""

from __future__ import annotations

import time

import pytest
import torch

import gsmvi_tpu_torch as port
import gsmvi_tpu_torch.models as port_models
from portbench import manifest, run
from portbench.tests.conftest import tiny

BENCH = manifest.load()
CELLS = ["gsm_gauss256.fit_b32", "bam_gauss256.fit_b128",
         "gsm_gauss256.fit_b128"]
FITTERS = (port.GSM, port.FactorGSM, port.FactorBaM)


def _run(name, seed=2 ** 31 + 101):
    cell, config = tiny(*manifest.cell(BENCH, name))
    return run.run_cell(BENCH, cell, config, seed, 0.2, False, device="cpu",
                        t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged(name, monkeypatch):
    for cls in FITTERS:
        monkeypatch.setattr(cls, "_make_step",
                            lambda self, *a, **k: (lambda s: s))
    res = _run(name)
    assert res["correct"] is False
    assert res["compared"]["cov_gap"]["value"] > 1e-2


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered(name, monkeypatch):
    for cls, method in ((port.GSM, "fit"), (port.FactorGSM, "fit_batch"),
                        (port.FactorBaM, "fit")):
        orig = getattr(cls, method)

        def altered(self, *a, _orig=orig, **k):
            if k.get("return_state"):
                return _orig(self, *a, **k)
            mean, cov = _orig(self, *a, **k)
            cov = cov.clone()
            cov[..., 1, 2] += 0.01 * cov.abs().max()
            return mean, cov

        monkeypatch.setattr(cls, method, altered)
    res = _run(name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_score_altered(name, monkeypatch):
    orig = port_models.gaussian_target_from_arrays

    def wrong(*a, **k):
        t = orig(*a, **k)
        lp_g = t.lp_g
        t.lp_g = lambda x: 1.25 * lp_g(x)
        t.fused_score = None
        return t

    monkeypatch.setattr(port_models, "gaussian_target_from_arrays", wrong)
    res = _run(name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_half_batch(name, monkeypatch):
    for cls in FITTERS:
        orig = cls._make_step

        def half(self, batch_size, *a, _orig=orig, **k):
            return _orig(self, batch_size // 2, *a, **k)

        monkeypatch.setattr(cls, "_make_step", half)
    res = _run(name)
    assert res["correct"] is False
    compared = res["compared"]
    assert compared["mean_gap"]["value"] <= compared["mean_gap"]["limit"]
    assert compared["step_mean_gap"]["value"] > 1e-2
