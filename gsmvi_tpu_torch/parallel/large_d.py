"""Large D: 2-D (data x model) meshes with a column-sharded covariance.

Counterpart of ``gsmvi_tpu/parallel/large_d.py``.  At large D the state is
O(D^2) and its products O(B D^2), so the (D, D) covariance, its Cholesky
factor or the factor F is split by columns over the ``model`` axis while
the Monte-Carlo rows split over ``data``:

- ``make_mesh_2d``, ``cov_sharding`` (``Shard(1)`` on ``model``) and
  ``batch_sharding_2d`` give the layouts;
- ``GSM(..., cov_sharding=...)`` and ``FactorGSM(..., cov_sharding=...)``
  keep those matrices as DTensors in that layout, each rank holding a
  (D, D/m) column panel, and run their plain step on the panels
  (``ColumnPanels``): every O(B D^2) product works on the rank's own
  columns, and only O(B D) rows and (B,)/(2B)^2 small tensors cross ranks.
  JAX leaves the same partitioning to GSPMD; here the collectives are
  written out, because DTensor's own propagation would gather the (D, D)
  matrix for the factorizations;
- with ``GSM(..., chol_block=b)`` the dense fit's Cholesky factor is the
  blocked right-looking one of ``parallel/chol.py`` on the same panels.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import (NamedSharding, _placements, all_gather_into, axis_group,
                   axis_rank, axis_size, init_mesh)


def make_mesh_2d(n_data: int, n_model: int, data_axis: str = "data",
                 model_axis: str = "model", devices=None):
    """(n_data x n_model) mesh over every rank of the process group (which
    must number n_data * n_model); ``devices`` is the device type ("cuda"
    unless "cpu" is asked for)."""
    return init_mesh((n_data, n_model), (data_axis, model_axis), devices)


def cov_sharding(mesh, model_axis: str = "model") -> NamedSharding:
    """Column-shard a (D, D) matrix over the model axis."""
    from torch.distributed.tensor import Shard

    return NamedSharding(mesh, _placements(mesh, {model_axis: Shard(1)}))


def batch_sharding_2d(mesh, data_axis: str = "data",
                      model_axis: Optional[str] = None) -> NamedSharding:
    """(B, D) batches: rows over ``data_axis``, optionally columns over
    ``model_axis``."""
    from torch.distributed.tensor import Shard

    by_name = {data_axis: Shard(0)}
    if model_axis is not None:
        by_name[model_axis] = Shard(1)
    return NamedSharding(mesh, _placements(mesh, by_name))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module: no
    DTensor exists before something imported it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def column_axis(sharding: NamedSharding) -> str:
    """The name of the mesh axis a ``cov_sharding`` splits columns over."""
    from torch.distributed.tensor import Replicate, Shard

    names = sharding.mesh.mesh_dim_names or ()
    cols = [n for n, p in zip(names, sharding.placements)
            if isinstance(p, Shard) and p.dim == 1]
    others = [p for p in sharding.placements
              if not (isinstance(p, Replicate)
                      or (isinstance(p, Shard) and p.dim == 1))]
    if len(cols) != 1 or others:
        raise ValueError("cov_sharding must split the columns over one mesh "
                         f"axis and replicate elsewhere, got "
                         f"{sharding.placements}")
    return cols[0]


def _dtensor_sharding(x: torch.Tensor) -> NamedSharding:
    return NamedSharding(x.device_mesh, tuple(x.placements))


class ColumnPanels:
    """The (D, D) matrices of one fit split by columns over a mesh axis:
    rank j of that axis holds columns ``cols`` = [j c, min((j + 1) c, D)),
    c = ceil(D / m), DTensor's ``Shard(1)`` split.  Products of O(B D) rows
    with a panel are formed on the rank's columns and summed or gathered
    over the axis; everything D x D stays a panel."""

    def __init__(self, sharding: NamedSharding, d: int):
        self.sharding = sharding
        self.d = int(d)
        axis = column_axis(sharding)
        mesh = sharding.mesh
        self.m = axis_size(mesh, axis)
        self.group = axis_group(mesh, axis) if self.m > 1 else None
        self.chunk = -(-self.d // self.m)
        start = min(axis_rank(mesh, axis) * self.chunk, self.d)
        self.cols = slice(start, min(start + self.chunk, self.d))
        self.width = self.cols.stop - self.cols.start

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (D, width) panel of ``x``: a DTensor's local piece
        (redistributed to this layout if it has another), or the columns
        of a full tensor."""
        if is_dtensor(x):
            if tuple(x.placements) != tuple(self.sharding.placements):
                x = x.redistribute(self.sharding.mesh,
                                   self.sharding.placements)
            return x.to_local()
        return x[..., self.cols]

    def wrap(self, panel: torch.Tensor):
        """The (D, D) DTensor whose local piece is ``panel``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(panel, self.sharding.mesh,
                                  self.sharding.placements, run_check=False,
                                  shape=torch.Size((self.d, self.d)),
                                  stride=(self.d, 1))

    def sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of every rank's ``partial`` (in place)."""
        if self.m > 1:
            dist.all_reduce(partial, group=self.group)
        return partial

    def rows_t(self, x: torch.Tensor, panel: torch.Tensor) -> torch.Tensor:
        """``x @ M^T`` (rows, D) for rows ``x`` (rows, D) and M's panel."""
        return self.sum(x[:, self.cols] @ panel.T)

    def rows(self, x: torch.Tensor, panel: torch.Tensor) -> torch.Tensor:
        """``x @ M`` (rows, D): each rank's columns ``x @ panel``, gathered."""
        return self.gather_cols(x @ panel)

    def gather_cols(self, y: torch.Tensor) -> torch.Tensor:
        """(rows, D) from every rank's (rows, width) columns, in order."""
        if self.m == 1:
            return y
        part = y.new_zeros((self.chunk, y.shape[0]))
        part[:self.width] = y.T
        out = y.new_empty((self.m * self.chunk, y.shape[0]))
        all_gather_into(out, part, self.group)
        return out[:self.d].T

    def all(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool flag that holds on every rank of the axis."""
        if self.m == 1:
            return flag
        f = flag.to(torch.int32)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.group)
        return f.to(torch.bool)


def panels_of(x: torch.Tensor) -> ColumnPanels:
    """The ``ColumnPanels`` of a (D, D) DTensor in a ``cov_sharding``."""
    return ColumnPanels(_dtensor_sharding(x), x.shape[-1])


def all_finite(x: torch.Tensor) -> torch.Tensor:
    """Whether a (D, D) DTensor in a ``cov_sharding`` is finite on every
    rank (a 0-d bool tensor, the same on every rank)."""
    p = panels_of(x)
    return p.all(torch.isfinite(x.to_local()).all())


def select(good: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``torch.where(good, new, old)`` on two DTensors of one layout (panel
    by panel; ``good`` a plain bool tensor, the same on every rank)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.where(good, new.to_local(),
                                          old.to_local()),
                              new.device_mesh, new.placements,
                              run_check=False, shape=new.shape,
                              stride=new.stride())


def panel_gsm_update(samples, vs, mu0, s0, p: ColumnPanels):
    """The dense GSM update (``ops/gsm.py``) with S0 given as this rank's
    column panel: (mu, this rank's panel of S).  The (B, D) rows are
    whole on every rank; S0 v_b is formed on the rank's columns and
    gathered, and each rank forms its own columns of the Gram delta (and of
    its transpose, for the exact symmetrization)."""
    from ..ops.gsm import gsm_row_deltas

    b = samples.shape[0]
    a, dmu_b = gsm_row_deltas(samples, vs, mu0, p.rows(vs, s0))
    bm = a + dmu_b
    c = p.cols
    ds = (a.T @ a[:, c] - bm.T @ bm[:, c]) / b
    ds_t = ((a[:, c].T @ a - bm[:, c].T @ bm) / b).T
    return mu0 + torch.mean(dmu_b, dim=0), s0 + 0.5 * (ds + ds_t)


def panel_eps_update(eps, vs, ef, mean, f, p: ColumnPanels):
    """One exact eps step (``ops/gsm_eps.gsm_eps_factor_update``) with F
    given as this rank's column panel and ef = eps F^T whole: (mean, this
    rank's panel of F', good).  vf = vs F is formed on the rank's columns
    and gathered, vf F^T summed over the ranks; the (2B)^2 small space runs
    on every rank, and each rank applies the correction to its own
    columns.  In the branch 2B >= D (small D) the D x D middle matrix is
    factored on every rank and F W's columns summed over the ranks."""
    from ..ops.gsm_eps import _chol_pd, eps_core, eps_rows

    b, d = eps.shape
    vf = p.rows(vs, f)
    dmu, zt, fz_t = eps_rows(eps, vs, vf, -ef, p.rows_t(vf, f))
    c = p.cols
    if 2 * b >= d:
        jj = torch.cat([torch.ones(b, dtype=f.dtype, device=f.device),
                        -torch.ones(b, dtype=f.dtype, device=f.device)])
        eye = torch.eye(d, dtype=f.dtype, device=f.device)
        m = eye + zt.T @ (zt * jj[:, None])
        w, good = _chol_pd(0.5 * (m + m.T))
        w = torch.where(good, w, eye)
        return mean + dmu, p.sum(f @ w[c])[:, c], good
    s2, good = eps_core(zt, b)
    return mean + dmu, f + fz_t.T @ (s2 @ zt[:, c]), good


def sharded_cov(f):
    """S = F F^T of a column-sharded factor F (a DTensor), in F's layout:
    each rank's Fc Fc^T summed over the model axis (one (D, D)
    all-reduce: a fit's result, not its loop), symmetrized, and the rank's
    columns kept."""
    p = panels_of(f)
    fc = f.to_local()
    s = p.sum(fc @ fc.T)
    return p.wrap((0.5 * (s + s.T))[:, p.cols].contiguous())
