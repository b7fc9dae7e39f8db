"""Fit-loop driver shared by the port's fitters.

Counterpart of ``gsmvi_tpu/driver.py:28-265``.  JAX compiles the step and
runs it as a ``lax.scan`` in chunks between host events; here a chunk is a
Python loop over steps, each of which only enqueues work on the device (no
step reads a device value, so the host never waits inside a chunk).  Chunk
boundaries are the host-visible events (monitor checkpoints, progress
prints), and a fit runs ``niter + 1`` steps, as the reference does.

Eps for absolute step ``s`` of a fit seeded with ``seed`` comes from a
``torch.Generator`` seeded with ``step_seed(seed, s)`` (a splitmix64 mix of
the pair), so every trajectory is invariant to chunking and steps-per-call
and resumes exactly from a saved (seed, step).  A ``fit_batch`` replica
seeded with ``seed_i`` draws from the same stream (``draw_replicas``), so
it draws exactly what ``fit(seed_i)`` draws.  The whole-step blocks (K2,
K6) take their draws in place into a persistent block (``draw_block``):
the same numbers, with no block assembled per call.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def on_gpu(device) -> bool:
    """True when ``device`` (a fitter's device) is a CUDA device."""
    return torch.device(device).type == "cuda"


def takes_tensors(fn: Callable, batch: int, d: int, dtype, device) -> bool:
    """Whether the score ``fn`` is a tensor callable: the counterpart of
    ``is_traceable`` (``gsmvi_tpu/driver.py:38``), with JAX's rule that any
    exception counts.  One probe call of ``fn`` on a (batch, d) tensor of
    zeros on the fit's device; a callable that raises on it, or returns
    something that is not a tensor, is a host (numpy) callable, which the
    fitters call through ``host_score``."""
    probe = torch.zeros((batch, d), dtype=dtype, device=device)
    try:
        return torch.is_tensor(fn(probe))
    except Exception:
        return False


def host_score(lp_g: Callable) -> Callable:
    """The tensor form of a host (numpy) score: rows on the device are
    copied to the host (``.cpu().numpy()``), ``lp_g`` is called on the
    numpy array, and its result is copied back (``torch.as_tensor(...,
    device=, dtype=)``, the rows' device and dtype).  The two copies are the
    contract of a host callable, as JAX's eager loop makes them
    (``gsmvi_tpu/gsm.py:255-265``): every step waits for the device, and
    the score runs on the host."""

    def score(x: torch.Tensor) -> torch.Tensor:
        out = lp_g(x.detach().cpu().numpy())
        return torch.as_tensor(np.asarray(out), dtype=x.dtype,
                               device=x.device)

    return score


def step_seed(seed: int, step: int) -> int:
    """Generator seed of absolute step ``step``: splitmix64 of
    ``seed * 0x9E3779B97F4A7C15 + step`` (mod 2**64), as a 63-bit int."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


# Salt of the retry stream: resample attempt ``a`` (1, 2, ...) of absolute
# step ``s`` draws from ``step_seed(retry_seed(seed, s), a)``, disjoint from
# the per-step stream ``step_seed(seed, s)`` as JAX keeps its retries on
# ``fold_in(key, -s - 1)``.
RETRY_SALT = 0x2545F4914F6CDD1D


def retry_seed(seed: int, step: int) -> int:
    """Base seed of step ``step``'s resample attempts (see RETRY_SALT)."""
    return step_seed(int(seed) ^ RETRY_SALT, step)


class EpsStream:
    """Standard-normal (B, D) draws per absolute step on one device.  With
    ``counts`` (a fitter's ``fit_counts``) each draw, one seeding of the
    generator, adds one to ``counts["draws"]``."""

    def __init__(self, device, counts=None):
        self.generator = torch.Generator(device=device)
        self.counts = counts

    def __call__(self, seed: int, step: int, batch: int, d: int,
                 dtype=torch.float32) -> torch.Tensor:
        if self.counts is not None:
            self.counts["draws"] += 1
        self.generator.manual_seed(step_seed(seed, step))
        return torch.randn((batch, d), generator=self.generator, dtype=dtype,
                           device=self.generator.device)

    def into(self, out: torch.Tensor, seed: int, step: int) -> torch.Tensor:
        """Step ``step``'s draw written in place into ``out`` (a contiguous
        (B, D) view on the stream's device): the numbers of ``self(seed,
        step, B, D, out.dtype)``, since ``randn`` is ``empty`` followed by
        ``normal_``."""
        if self.counts is not None:
            self.counts["draws"] += 1
        self.generator.manual_seed(step_seed(seed, step))
        return out.normal_(generator=self.generator)


def draw_replicas(draw: Callable, seeds, step: int, batch: int, d: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(K, B, D) draws of K replicas at absolute step ``step``: replica i's
    is ``draw(seeds[i], step, batch, d, dtype)``, the draw of a single fit
    seeded with ``seeds[i]`` (``draw`` is a fitter's ``_eps``, an
    ``EpsStream`` or a stand-in for it).  The host seeds one generator per
    replica and step: the cost that keeps each replica on its own stream."""
    return torch.stack([draw(s, step, batch, d, dtype) for s in seeds])


def draw_block(draw, out: torch.Tensor, seeds, step: int, nmax: int,
               batch: int) -> None:
    """Write the draws of absolute steps ``step`` .. ``step + nmax - 1``
    in place into a K2/K6 eps block ``out``: sub-step j's in rows [j*B,
    (j+1)*B) of a (spc*B, D) block for one fit seeded with the int
    ``seeds``, or of each replica's (spc*B, D) rows of a (K, spc*B, D)
    block for the tuple ``seeds``, replica i drawing what the single fit
    seeded with ``seeds[i]`` draws.  ``draw`` is a fitter's ``_eps``: an
    ``EpsStream`` writes in place (``EpsStream.into``); a stand-in that
    returns the draw, ``draw(seed, step, batch, d, dtype)``, is copied
    in."""
    into = getattr(draw, "into", None)
    if into is None:
        into = lambda rows, seed, s: rows.copy_(
            draw(seed, s, rows.shape[0], rows.shape[1], rows.dtype))
    replicas = seeds if isinstance(seeds, tuple) else None
    for j in range(nmax):
        rows = out[..., j * batch:(j + 1) * batch, :]
        if replicas is None:
            into(rows, seeds, step + j)
        else:
            for i, seed in enumerate(replicas):
                into(rows[i], seed, step + j)


def broadcast_replicas(x, default, k: int, shape, dtype, device):
    """``fit_batch`` initial-state helper (``gsmvi_tpu/driver.py:106-116``):
    ``x`` (or ``default`` when None) of ``shape`` broadcast to ``k``
    replicas, or an already per-replica (k, *shape) stack passed through;
    a contiguous (k, *shape) tensor."""
    x = torch.as_tensor(default if x is None else x, dtype=dtype,
                        device=device)
    if x.dim() == len(shape):
        x = x.expand(k, *shape)
    if tuple(x.shape) != (k, *shape):
        raise ValueError(f"expected {tuple(shape)} or {(k, *shape)}, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


class RunnerCache:
    """Bounded LRU cache of chunk runners keyed partly on object identity;
    holds a strong reference to every keyed object so its id cannot be
    reused while the entry lives.  With ``counts`` (a fitter's
    ``fit_counts``) each build adds one to ``counts["runner_builds"]``."""

    def __init__(self, maxsize: int = 16, counts=None):
        self._entries = {}
        self._maxsize = maxsize
        self.counts = counts

    def get(self, static_key, key_objs: tuple, build: Callable) -> Callable:
        key = (static_key, tuple(id(o) for o in key_objs))
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.pop(key)       # refresh: move to MRU end
            self._entries[key] = hit
            return hit[1]
        runner = build()
        if self.counts is not None:
            self.counts["runner_builds"] += 1
        if len(self._entries) >= self._maxsize:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (key_objs, runner)
        return runner


def replicas(state) -> int:
    """Replicas a (stacked) fit state holds: its seeds' count, 1 for one
    fit."""
    seed = getattr(state, "seed", None)
    return len(seed) if isinstance(seed, tuple) else 1


def make_chunk_runner(step: Callable, collect_aux: bool = False,
                      counts=None) -> Callable:
    """``(state, k) -> state`` running ``k`` steps.

    With ``collect_aux`` the step returns ``(state, aux)``, ``aux`` a 0-d
    tensor on the fit's device (ADVI's per-step loss), and the runner
    returns ``(state, (k,) tensor of the aux values)``, stacked on the
    device: nothing is read back inside a chunk.  With ``counts`` (a
    fitter's ``fit_counts``) each step adds the state's replicas to
    ``counts["steps"]``."""
    if counts is None:
        counts = {"steps": 0}

    if collect_aux:
        def run_chunk(state, k: int):
            aux, n = [], replicas(state)
            for _ in range(k):
                state, a = step(state)
                counts["steps"] += n
                aux.append(a)
            return state, torch.stack(aux)

        return run_chunk

    def run_chunk(state, k: int):
        n = replicas(state)
        for _ in range(k):
            state = step(state)
            counts["steps"] += n
        return state

    return run_chunk


def monitor_seed(seed: int, i: int) -> int:
    """Seed handed to a monitor at checkpoint ``i`` (independent draws per
    checkpoint, fit trajectory untouched)."""
    return step_seed(seed ^ 0x5DEECE66D, i)


# Salt of the audit draws (``utils/audit.py``): the audit at iteration ``i``
# draws from a generator seeded with ``audit_seed(seed, i)``, a second
# salted mix on top of ``step_seed(seed, i)``, as JAX folds ``AUDIT_SALT``
# on top of ``fold_in(key, i)`` (``gsmvi_tpu/utils/audit.py:38-48``): its
# stream shares no seed with the per-step, monitor or retry streams, so an
# audit never perturbs a fit.
AUDIT_SALT = 0x5D17


def audit_seed(seed: int, i: int) -> int:
    """Generator seed of the audit draw at iteration ``i``."""
    return step_seed(step_seed(seed, i) ^ AUDIT_SALT, AUDIT_SALT)


def _next_event(i: int, total: int, cadences) -> int:
    """First iteration > i that is a multiple of any cadence (or ``total``)."""
    nxt = total
    for c in cadences:
        if c:
            nxt = min(nxt, ((i // c) + 1) * c)
    return nxt


def run_fit_loop(state, niter: int, run_chunk: Callable, *, monitor=None,
                 monitor_params: Optional[Callable] = None, lp=None,
                 nprint: int = 10, verbose: bool = True,
                 batch_size: int = 1, collect_aux: bool = False,
                 state_hook: Optional[Callable] = None,
                 state_hook_every: int = 0):
    """Run ``niter + 1`` steps with the reference's print and monitor cadence.

    ``monitor`` follows the reference hook protocol
    ``monitor(i, params, lp, seed, nevals=...)`` at ``monitor.checkpoint``
    cadence, plus one call after the loop; ``monitor_params(state)`` gives
    its params (default ``[state.mean, state.cov]``).  With ``collect_aux``
    ``run_chunk`` returns ``(state, aux)`` (``make_chunk_runner(...,
    collect_aux=True)``) and the loop returns ``(state, aux)``, the chunks'
    aux concatenated on the device over all ``niter + 1`` steps.
    ``state_hook(i, state)`` runs on the live state every
    ``state_hook_every`` iterations (i > 0, before the monitor; chunk ends
    align to the cadence): the factor fitters' ``audit_every``
    (``utils/audit.py``).  Unlike ``monitor`` it sees the raw state.
    """
    total = niter + 1
    checkpoint = getattr(monitor, "checkpoint", None) if monitor is not None else None
    if monitor_params is None:
        monitor_params = lambda s: [s.mean, s.cov]
    nevals = 1
    print_every = (max(1, niter // min(nprint, max(niter, 1)))
                   if (verbose and nprint) else 0)
    hook_every = state_hook_every if state_hook is not None else 0
    cadences = (checkpoint, print_every, hook_every)
    aux_chunks = []
    i = 0
    while i < total:
        if print_every and i % print_every == 0:
            print(f"Iteration {i} of {niter}")
        if hook_every and i % hook_every == 0 and i > 0:
            state_hook(i, state)
        if monitor is not None and checkpoint and i % checkpoint == 0:
            monitor(i, monitor_params(state), lp, monitor_seed(state.seed, i),
                    nevals=nevals)
            nevals = 0
        k = _next_event(i, total, cadences) - i
        if collect_aux:
            state, aux = run_chunk(state, k)
            aux_chunks.append(aux)
        else:
            state = run_chunk(state, k)
        nevals += k * batch_size
        i += k
    if monitor is not None:
        monitor(niter, monitor_params(state), lp,
                monitor_seed(state.seed, total), nevals=nevals)
    if collect_aux:
        return state, torch.cat(aux_chunks)
    return state
