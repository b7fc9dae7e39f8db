"""Seeds: the program's per-step draw seed, copied, and the benchmark's own.

``step_seed`` is a frozen copy of ``gsmvi_tpu_torch.driver.step_seed``: the
reference draws step ``s`` of a fit seeded with ``seed`` from a generator
seeded with it, the numbers the program draws.  ``derive`` makes the
benchmark's seeds from the run's ``--seed`` with the same mix under a salt
of its own.

A cell's jobs fit a fixed pool of fit seeds, the same in every run, in an
order drawn from the run's seed (each pass over the pool in a fresh order):
a BaM fit's work depends on its seed (the Newton-Schulz tiers it takes), so
fresh seeds in every run would change the work from run to run.
"""

from __future__ import annotations

import random

_MASK64 = (1 << 64) - 1

# Salts of the benchmark's own streams.
POOL = 1
JOBS = 2
CHECK = 3


def step_seed(seed: int, step: int) -> int:
    """Generator seed of absolute step ``step``: splitmix64 of
    ``seed * 0x9E3779B97F4A7C15 + step`` (mod 2**64), as a 63-bit int."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def derive(seed: int, salt: int, i: int = 0) -> int:
    """The ``i``-th seed of stream ``salt`` of a run seeded with ``seed``:
    a 31-bit int (``salt`` keeps the streams apart)."""
    return step_seed(step_seed(seed, salt), i) >> 32


def pool(size: int) -> list:
    """The fixed pool of a cell's first fit seeds (31-bit ints)."""
    return [derive(0, POOL, i) for i in range(size)]


def job_seeds(seed: int, job: int, replicas: int, size: int) -> list:
    """Fit seeds of job ``job`` of a run seeded with ``seed``: a seed of the
    pool of ``size`` (pass ``job // size`` over it in an order drawn from
    ``seed``), and for a sweep of ``replicas`` fits the consecutive seeds
    after it."""
    order = list(range(size))
    random.Random(derive(seed, JOBS, job // size)).shuffle(order)
    first = pool(size)[order[job % size]]
    return [first + r for r in range(replicas)]
