"""Data-parallel score statistics with the collectives written out.

Counterpart of ``gsmvi_tpu/parallel/sharded.py``.  JAX writes these as
``shard_map`` bodies over a mesh of devices in one process; here each rank
of the process group is one device and runs the body itself (SPMD): every
function below takes THIS RANK'S rows of the batch, ``local_rows`` of the
whole (B, D) draw, and returns what every rank returns (replicated
results) unless it says otherwise.  Rows are split in order: with q =
ceil(B / n), rank r of the ``axis`` holds rows [r q, min((r + 1) q, B)).

Only O(B D) row tensors and the O(D^2) Gram partials cross ranks, and the
fitters' mesh steps use only the first: each rank scores its own rows,
the rows are gathered, and the update (a kernel on the card) runs
replicated on the whole batch (``make_gathered_update``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.gsm import gsm_update_stats
from .mesh import all_gather_into, axis_group, axis_rank, axis_size


class DataRows:
    """The split of the batch rows over the ``axis`` of ``mesh``: with
    q = ceil(B / n), rank r holds rows [r q, min((r + 1) q, B)).  With no
    mesh, or one rank on the axis, that rank holds every row and nothing
    is sent."""

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.n = 1 if mesh is None else axis_size(mesh, axis)
        self.rank = 0 if mesh is None else axis_rank(mesh, axis)
        self.group = axis_group(mesh, axis) if self.n > 1 else None

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (a view) of a (B, ...) tensor every rank holds."""
        if self.n == 1:
            return x
        q = -(-x.shape[0] // self.n)
        start = min(self.rank * q, x.shape[0])
        return x[start:min(start + q, x.shape[0])]

    def gather(self, x: torch.Tensor, b: int = None) -> torch.Tensor:
        """The (B, ...) tensor of every rank's rows ``x``, in rank order (one
        ``all_gather``); ``b`` is the whole batch (default: n times this
        rank's rows, the equal split)."""
        if self.n == 1:
            return x
        if b is None:
            b = self.n * x.shape[0]
        q = -(-b // self.n)
        if x.shape[0] != q:
            x = torch.cat([x, x.new_zeros((q - x.shape[0], *x.shape[1:]))])
        out = x.new_empty((self.n * q, *x.shape[1:]))
        all_gather_into(out, x.contiguous(), self.group)
        return out[:b]

    def score(self, lp_g, eps: torch.Tensor, mean: torch.Tensor,
              f: torch.Tensor, dtype, panels=None):
        """(ef, vs) of the whole (B, D) draw ``eps`` (every rank's): this
        rank's rows of ef = eps F^T and of the score vs = lp_g(mean + ef) in
        ``dtype``, gathered.  F is the factor or the dense fit's Cholesky
        factor (with ``panels``, a ``large_d.ColumnPanels``, this rank's
        column panel of it).  The mesh step of every fitter's plain
        route."""
        b = eps.shape[0]
        rows = self.local(eps)
        ef = rows @ f.T if panels is None else panels.rows_t(rows, f)
        vs = lp_g(mean + ef).to(dtype)
        return self.gather(ef, b), self.gather(vs, b)


def no_mesh(fitter, what: str) -> None:
    """Raise where a fitter with a mesh, a column-sharded covariance or a
    blocked Cholesky reaches a method that runs on one device and factors
    whole (``fit_batch``)."""
    if any(getattr(fitter, name, None) is not None
           for name in ("mesh", "cov_sharding", "chol_block")):
        raise ValueError(f"{what} runs its replicas on one device: mesh=, "
                         "cov_sharding= and chol_block= are for fit")


def local_rows(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (a view) of a (B, ...) tensor every rank holds."""
    return DataRows(mesh, axis).local(x)


def _sum(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x


def sharded_gsm_stats(mesh, lp_g, samples, mu0, S0, axis: str = "data"):
    """(dmu, dS) of a GSM step from this rank's rows ``samples`` (equal
    shards): ``lp_g`` on the local rows, the local deltas, then one
    all-reduce and a divide by the n ranks (the mean of the shards' means
    is the batch mean)."""
    n = axis_size(mesh, axis)
    dmu, ds = gsm_update_stats(samples, lp_g(samples).to(samples.dtype), mu0,
                               S0)
    both = _sum(mesh, axis, torch.cat([dmu[None], ds]))
    return both[0] / n, both[1:] / n


def sharded_bam_stats(mesh, lp_g, samples, axis: str = "data"):
    """(xbar, C, gbar, G) of a BaM step from this rank's rows ``samples``.

    Two rounds: the batch sums of the rows and scores (with the row count)
    in one all-reduce, then the Gram partials of the rows centred on the
    BATCH means in another; centring on the batch mean before the Gram
    keeps the result exact (no E[xx^T] - xbar xbar^T cancellation)."""
    vs = lp_g(samples).to(samples.dtype)
    d = samples.shape[1]
    sums = torch.cat([samples.sum(0), vs.sum(0),
                      samples.new_full((1,), samples.shape[0])])
    sums = _sum(mesh, axis, sums)
    b = sums[-1]
    xbar, gbar = sums[:d] / b, sums[d:2 * d] / b
    xd, gd = samples - xbar, vs - gbar
    grams = _sum(mesh, axis, torch.stack([xd.T @ xd, gd.T @ gd]))
    return xbar, grams[0] / b, gbar, grams[1] / b


def sharded_score_eval(mesh, lp_g, samples, axis: str = "data"):
    """``lp_g`` on this rank's rows; the result stays sharded: a DTensor
    with rows over ``axis`` (equal shards), whose ``to_local()`` is this
    rank's scores and ``full_tensor()`` the batch's."""
    from torch.distributed.tensor import DTensor

    from .mesh import data_sharding

    return DTensor.from_local(lp_g(samples), mesh,
                              data_sharding(mesh, axis).placements,
                              run_check=False)


def make_gathered_update(mesh, axis: str, lp_g, update_fn,
                         pass_ef: bool = False):
    """A data-parallel score composed with a REPLICATED whole-batch update
    (the mesh pattern of ``FactorGSM`` and ``FactorBaM``, whose update is
    K1 or K7 on the card).

    Returns ``gathered(eps_local, mean, f, *extras)``: this rank's rows
    ``eps_local`` (equal shards) give ef = eps F^T and the score
    ``lp_g(mean + ef)`` (in F's dtype); the eps and score rows are
    gathered (one all-gather each) and ``update_fn(eps, vs, mean, f,
    *extras)`` runs on the whole batch on every rank, which computes the
    same update, so its outputs are replicated.  ``pass_ef`` gathers the
    ef rows too and passes them as ``ef=`` (the kernels' sampling product,
    so a one-rank mesh computes what the fit without one computes).  With
    ``mesh`` None it is the plain composition on one device."""

    rows = DataRows(mesh, axis)

    def gathered(eps_local, mean, f, *extras):
        ef = eps_local @ f.T
        vs = lp_g(mean + ef).to(f.dtype).contiguous()
        kw = {"ef": rows.gather(ef)} if pass_ef else {}
        return update_fn(rows.gather(eps_local), rows.gather(vs), mean, f,
                         *extras, **kw)

    return gathered


def sharded_gsm_fit(mesh, lp_g, seed: int, d: int, niter: int,
                    batch_size: int, mean=None, cov=None, axis: str = "data",
                    dtype=None, device=None):
    """A whole dense GSM fit on ``sharded_gsm_stats``: every step draws the
    batch (the stream of ``GSM.fit``), keeps this rank's rows, samples
    them from the Cholesky factor, reduces the local statistics over the
    mesh and runs the replicated accept/revert.  The same fit as
    ``GSM(mesh=..., use_factor=False).fit`` on the plain update, with the
    batch sums reduced over ranks in place of gathered rows.  Returns the
    final ``VIState``."""
    from ..driver import EpsStream, make_chunk_runner, run_fit_loop
    from ..state import accept_or_revert, init_state

    state = init_state(seed, d, mean, cov, dtype, device)
    draw = EpsStream(state.mean.device)

    def step(s):
        eps = local_rows(mesh, axis, draw(s.seed, s.step, batch_size, d,
                                          s.mean.dtype))
        dmu, ds = sharded_gsm_stats(mesh, lp_g, s.mean + eps @ s.chol.T,
                                    s.mean, s.cov, axis)
        return accept_or_revert(s, s.mean + dmu, s.cov + ds)

    return run_fit_loop(state, niter, make_chunk_runner(step), verbose=False,
                        batch_size=batch_size)
