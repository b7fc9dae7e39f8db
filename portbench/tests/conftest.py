"""Shared fixtures of the benchmark's own tests (CPU unless marked ``gpu``)."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small CPU shapes: threaded BLAS only adds overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell: dict, config: dict, *, dim=8, batch=4, niter=300,
         limits=(1e-3, 1e-3, 1e-3, 1e-3), **extra) -> tuple:
    """A cell and its configuration cut to a CPU test's size."""
    config = dict(config, dim=dim)
    job = dict(cell["job"], batch_size=batch, niter=niter)
    cell = dict(cell, job=job, warmup_niter=5, check_fits=2,
                limits=dict(zip(("mean_gap", "cov_gap", "step_mean_gap",
                                 "step_cov_gap"), limits)), **extra)
    return cell, config
