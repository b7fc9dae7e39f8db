"""Device meshes and the canonical shardings of a data-parallel fit.

Counterpart of ``gsmvi_tpu/parallel/mesh.py``.  Score-matching VI has one
batch axis, the per-iteration Monte-Carlo draw (B, D), and small replicated
parameters (mean, covariance or factor).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, one rank per device, its dimensions named; the canonical
layout is a 1-D ``data`` mesh with rows of the draw split over it and the
parameters replicated.

A sharding is a ``NamedSharding``: the mesh and one DTensor placement per
mesh dimension (``Shard(0)`` rows, ``Shard(1)`` columns, ``Replicate()``),
the counterpart of JAX's ``NamedSharding(mesh, PartitionSpec)``.

The mesh needs the process group first (``initialize_distributed``); it
does not start one itself.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class NamedSharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dimension."""

    mesh: object
    placements: tuple

    def place(self, x: torch.Tensor):
        """The DTensor of the full tensor ``x`` (the same on every rank) in
        this layout: each rank keeps its own piece, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def _require_group(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} spans the ranks of a torch.distributed process group, "
            "and none is up: call gsmvi_tpu_torch.parallel."
            "initialize_distributed(...) in every rank first (a one-rank "
            "group is fine)")


def init_mesh(shape: tuple, names: tuple, devices=None):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over all ranks
    of the process group, on device type ``devices`` (default ``"cuda"``:
    the CPU must be asked for, ``devices="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group("a device mesh")
    need, world = 1, dist.get_world_size()
    for n in shape:
        need *= int(n)
    if need != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {need} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(devices or "cuda", tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices=None):
    """1-D mesh named ``axis`` over ``n_devices`` ranks (default: every
    rank of the process group, which must then number ``n_devices``);
    ``devices`` is the device type ("cuda" unless "cpu" is asked for)."""
    _require_group("a device mesh")
    n = dist.get_world_size() if n_devices is None else n_devices
    return init_mesh((n,), (axis,), devices)


def _placements(mesh, by_name: dict) -> tuple:
    from torch.distributed.tensor import Replicate

    names = mesh.mesh_dim_names or ()
    unknown = set(by_name) - set(names)
    if unknown:
        raise ValueError(f"mesh has no axis {sorted(unknown)}; its axes are "
                         f"{list(names)}")
    return tuple(by_name.get(name, Replicate()) for name in names)


def data_sharding(mesh, axis: str = "data") -> NamedSharding:
    """(B, D) draws and scores: rows split over ``axis``."""
    from torch.distributed.tensor import Shard

    return NamedSharding(mesh, _placements(mesh, {axis: Shard(0)}))


def replicated_sharding(mesh) -> NamedSharding:
    """Every rank holds the whole tensor (the variational parameters)."""
    return NamedSharding(mesh, _placements(mesh, {}))


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dimension named ``axis``."""
    return int(mesh.size(_dim(mesh, axis)))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(_dim(mesh, axis)))


def axis_group(mesh, axis: str):
    """The process group of this rank's line of the mesh along ``axis``."""
    return mesh.get_group(_dim(mesh, axis))


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Every rank's ``x`` of ``group`` concatenated along dim 0 into ``out``
    (one collective; torch names it ``all_gather_single`` from 2.13 on, and
    ``all_gather_into_tensor`` before)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _dim(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{list(names)}")
    return names.index(axis)
