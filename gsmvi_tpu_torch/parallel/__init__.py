"""Data-parallel and model-sharded fits over ``torch.distributed``.

Counterpart of ``gsmvi_tpu/parallel``.  JAX runs one process over many
devices; torch runs one process per device, the ranks of a process group,
and a ``DeviceMesh`` names their layout:

- ``distributed`` — ``initialize_distributed``: start the process group
  (NCCL on the card, gloo on the CPU; torchrun's environment with
  ``auto=True``).
- ``mesh``        — ``make_mesh`` and the canonical shardings (draw rows
  over a ``data`` axis, parameters replicated).
- ``sharded``     — the score statistics with their collectives written
  out, and ``make_gathered_update``, the fitters' mesh step: each rank
  scores its rows of the draw, the rows are gathered, and the update runs
  replicated.
- ``large_d``     — 2-D (data x model) meshes and the column-sharded
  covariance of ``GSM``/``FactorGSM(cov_sharding=...)``.
- ``chol``        — the blocked right-looking Cholesky that factors a
  column-sharded covariance without gathering it.

Every rank draws the whole batch from the fit's stream and keeps its own
rows, so a one-rank mesh computes exactly what the fit without one does.
"""

from .chol import blocked_cholesky, make_blocked_cholesky
from .distributed import initialize_distributed
from .large_d import batch_sharding_2d, cov_sharding, make_mesh_2d
from .mesh import NamedSharding, data_sharding, make_mesh, replicated_sharding
from .sharded import (make_gathered_update, sharded_bam_stats,
                      sharded_gsm_fit, sharded_gsm_stats, sharded_score_eval)

__all__ = [
    "NamedSharding", "batch_sharding_2d", "blocked_cholesky", "cov_sharding",
    "data_sharding", "initialize_distributed", "make_blocked_cholesky",
    "make_gathered_update", "make_mesh", "make_mesh_2d",
    "replicated_sharding", "sharded_bam_stats", "sharded_gsm_fit",
    "sharded_gsm_stats", "sharded_score_eval",
]
