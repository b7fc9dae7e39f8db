"""The window's arithmetic on synthetic job times with one stall."""

from __future__ import annotations

import math

import pytest

from portbench import window


def _jobs():
    """99 jobs of 0.3 s with 2 ms between them, one 3 s stall at job 40,
    3001 steps each."""
    jobs, t = [], 10.0
    for i in range(100):
        length = 3.0 if i == 40 else 0.3
        jobs.append((t, t + length, 3001))
        t += length + 0.002
    return jobs


def test_rate_is_all_steps_over_the_whole_window():
    jobs = _jobs()
    wall = 99 * 0.3 + 3.0 + 99 * 0.002
    assert window.steps_per_s(jobs) == pytest.approx(100 * 3001 / wall,
                                                     rel=1e-12)
    # The stall costs the rate what it costs the wall: the same jobs
    # without it run 2.7 s shorter.
    steady, t = [], 10.0
    for _ in range(100):
        steady.append((t, t + 0.3, 3001))
        t += 0.302
    assert window.steps_per_s(steady) == pytest.approx(
        100 * 3001 / (wall - 2.7), rel=1e-12)


def test_p95_is_over_every_job():
    jobs = _jobs()
    assert window.fit_s_p95(jobs) == pytest.approx(0.3)
    # Six stalls of 100 jobs reach the 95th percentile (nearest rank 95).
    stalled = [(s, s + (3.0 if i < 6 else 0.3), n)
               for i, (s, _, n) in enumerate(jobs)]
    assert window.fit_s_p95(stalled) == pytest.approx(3.0)
    five = [(s, s + (3.0 if i < 5 else 0.3), n)
            for i, (s, _, n) in enumerate(jobs)]
    assert window.fit_s_p95(five) == pytest.approx(0.3)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 100, 257])
def test_nearest_rank(n):
    values = list(range(n, 0, -1))
    got = window.percentile(values, 95.0)
    assert got == max(1, math.ceil(0.95 * n))
    assert sum(v <= got for v in values) >= 0.95 * n


def test_window_object():
    w = window.Window(_jobs(), 12.5)
    assert w.setup_s == 12.5 and len(w.jobs) == 100


def test_jobs_walk_the_pool_in_an_order_drawn_from_the_seed():
    from portbench import seeds

    pool = seeds.pool(16)
    assert len(set(pool)) == 16 and pool == seeds.pool(16)
    run = [seeds.job_seeds(7, j, 1, 16)[0] for j in range(40)]
    assert sorted(run[:16]) == sorted(pool) == sorted(run[16:32])
    assert run[:16] != run[16:32]
    assert run == [seeds.job_seeds(7, j, 1, 16)[0] for j in range(40)]
    other = [seeds.job_seeds(8, j, 1, 16)[0] for j in range(16)]
    assert other != run[:16] and sorted(other) == sorted(pool)
    sweep = seeds.job_seeds(7, 3, 8, 16)
    assert sweep == [run[3] + r for r in range(8)]
