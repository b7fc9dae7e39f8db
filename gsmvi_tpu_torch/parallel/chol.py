"""Blocked right-looking Cholesky that keeps a column-sharded matrix sharded.

Counterpart of ``gsmvi_tpu/parallel/chol.py``.  The dense fitters' validity
check and sampling factor are one Cholesky of the (D, D) covariance
(``state.accept_or_revert``).  Handed a column-sharded DTensor,
``torch.linalg.cholesky_ex`` and ``solve_triangular`` gather the whole
matrix onto every rank and factor it there.  This module factors it in the
classical right-looking blocked form instead, on the ranks' column panels
(``large_d.ColumnPanels``):

    for each diagonal block k (nb = ceil(D / b) blocks, in order):
        the block column A[k:, k] (rows from k down, b columns), summed
            from the ranks that hold its columns onto every rank;
        L_kk = chol(A_kk)                   (b x b, on every rank)
        L_pk = A_pk L_kk^-T                 (triangular solve on the b side)
        A_tt -= L_pk L_pk^T                 (each rank on its own columns)

Only the b-wide block column crosses ranks; the O(D^3) trailing updates
run on each rank's own columns, so no (D, D) matrix is ever gathered, and
the factor comes back in the layout the input had (or ``out_sharding``).
``cholesky_ex`` and ``solve_triangular`` see the small block and the
panel alone.

NaN rule: JAX's ``jnp.linalg.cholesky`` gives NaN for a matrix that is not
positive definite, torch's ``cholesky_ex`` a partial factor and a nonzero
``info``.  A block that fails is made all NaN (``safe_cholesky``), and the
NaNs run through its panel solve and every later trailing update, so the
factor is NaN from the bad block onward and finite before it, as JAX's,
and ``accept_or_revert``'s finiteness check rejects what JAX rejects.
"""

from __future__ import annotations

import torch

from ..distributions import safe_cholesky
from .large_d import ColumnPanels, is_dtensor


def blocked_cholesky(a, block_size: int = 256, out_sharding=None):
    """Lower Cholesky factor of SPD ``a`` (D, D) by right-looking blocks
    of ``block_size``.

    ``a`` is a plain tensor or a DTensor in a ``cov_sharding`` layout;
    ``out_sharding`` (a ``NamedSharding``, e.g. ``large_d.cov_sharding``)
    is the layout of the factor, by default the input's.  A plain input
    with no ``out_sharding`` gives a plain factor, and with a block as
    wide as D it is ``safe_cholesky(a)``."""
    d = a.shape[-1]
    if tuple(a.shape) != (d, d):
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    b = int(min(block_size, d))
    if b <= 0:
        raise ValueError("block_size must be positive")
    sharding = out_sharding
    if sharding is None and is_dtensor(a):
        from .mesh import NamedSharding

        sharding = NamedSharding(a.device_mesh, tuple(a.placements))
    if sharding is None:
        if b >= d:
            return safe_cholesky(a)
        return _blocked(a.clone(), 0, d, b, None)
    p = ColumnPanels(sharding, d)
    return p.wrap(_blocked(p.local(a).clone(), p.cols.start, d, b, p))


def _blocked(work: torch.Tensor, c0: int, d: int, b: int, panels):
    """The factor's columns [c0, c0 + width) from the same columns of the
    matrix, ``work`` (D, width), overwritten with the trailing updates.
    ``panels`` sums each block column over the ranks (None: one rank
    holds every column)."""
    width = work.shape[1]
    c1 = c0 + width
    out = torch.zeros_like(work)
    off = 0
    while off < d:
        bk = min(b, d - off)
        lo, hi = max(off, c0), min(off + bk, c1)
        if panels is None:
            col = work[off:, off:off + bk]
        else:
            col = work.new_zeros((d - off, bk))
            if lo < hi:
                col[:, lo - off:hi - off] = work[off:, lo - c0:hi - c0]
            col = panels.sum(col)
        lkk = safe_cholesky(col[:bk])
        lpk = torch.linalg.solve_triangular(lkk, col[bk:].T, upper=False).T
        if lo < hi:
            out[off:off + bk, lo - c0:hi - c0] = lkk[:, lo - off:hi - off]
            out[off + bk:, lo - c0:hi - c0] = lpk[:, lo - off:hi - off]
        t0 = max(off + bk, c0)
        if t0 < c1:
            # A_tt -= L_pk L_pk^T on this rank's columns [t0, c1).
            work[off + bk:, t0 - c0:] -= lpk @ lpk[t0 - off - bk:c1 - off - bk].T
        off += bk
    return out


def make_blocked_cholesky(block_size: int = 256, out_sharding=None):
    """``blocked_cholesky`` with its block and layout fixed: the
    ``chol_fn`` of ``state.accept_or_revert`` / ``GSM(chol_block=...)``."""
    return lambda a: blocked_cholesky(a, block_size, out_sharding)
