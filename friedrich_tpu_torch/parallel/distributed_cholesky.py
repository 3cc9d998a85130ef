"""Distributed streamed Cholesky over the ranks of a mesh.

Counterpart of ``friedrich_tpu/parallel/distributed_cholesky.py``
(``_build_factor_program`` ``:59-164``, ``distributed_cholesky_factor``
``:167-211``): the left-looking panel loop of ``ops/streamed.py`` with the
training inputs and the factor row-sharded (``parallel/mesh.py``). Rank
``r`` holds rows ``[r0, r0 + R)``, ``R = cap / W``, of both; panels of
width ``B`` divide ``R``, so none straddles two ranks. For the panel
``[j0, j0 + B)``, owned by the rank holding those rows:

1. the owner broadcasts ``X_j`` (B, d) and its factored rows of the panel,
   ``L[j0:j0+B, :j0]`` (the one broadcast that grows with cap: cap^2
   elements over a factorization);
2. each rank builds its rows >= j0 of the strip
   ``S = K(X_rank, X_j) - L_rank[:, :j0] L[j0:j0+B, :j0]^T`` in ONE launch
   of the panel-strip kernel (B2): one operand on the owner (its rows
   start at the panel's), two below it (the broadcast rows as the second
   operand, the strip's first global row ``r0``). Ranks wholly above the
   panel launch nothing;
3. the owner broadcasts its (B, B) diagonal block, which every rank below
   or at the panel factors (cuSOLVER, or the epsilon substitute) and
   applies to its rows by TRSM.

The last rank's panels have no rank below them and broadcast nothing; a
mesh of one sends no collective but the final flag. Over a factorization
the broadcasts carry, for each panel of a rank but the last,
``B (j0 + B + d)`` elements (``j0`` padded to :data:`ROW_PAD`). ``ok``
(finite factor on every rank) is one all-reduce MIN. Every collective goes
through ``parallel/mesh.py``'s helpers, which count them.

The work is not balanced. Panel ``j0`` downdates the rows below it, a
prefix ``j0`` deep, so rank ``r`` of ``W`` computes about ((r + 1)^3 -
r^3) / W^3 of a build's products: 1, 7, 19 and 37 sixty-fourths on four
ranks. The last rank sets the build's length, and rank 0 is idle for every
panel after its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cholesky import cholesky, cholesky_with_substitute
from ..ops.panel_fused import panel_strip
from ..ops.partition import DEFAULT_PANEL_TARGET, pick_block
from ..ops.streamed import STORAGE_DTYPES, check_storage
from .mesh import Mesh, all_reduce, broadcast

#: Column padding of the broadcast panel rows: a row stride that is a
#: multiple of 8 elements keeps them 16-byte aligned for the kernel's TMA in
#: every dtype.
ROW_PAD = 8


def local_block(mesh: Mesh, cap: int, block: Optional[int]) -> tuple[int, int, int]:
    """``(r0, R, B)``: this rank's first row and row count of a capacity
    ``cap``, and the panel width, ``pick_block(R, block)`` (default
    ``ops/partition.DEFAULT_PANEL_TARGET``): a divisor of R, so that no
    panel straddles two ranks."""
    r0, r1 = mesh.rows(cap)
    rows = r1 - r0
    return r0, rows, pick_block(rows, DEFAULT_PANEL_TARGET if block is None else int(block))


def distributed_cholesky_factor(
    mesh: Mesh,
    kernel,
    x_local: torch.Tensor,
    n: int,
    noise,
    eps: Optional[float] = None,
    block: Optional[int] = None,
    method: str = "gram",
    storage: Optional[str] = None,
    l0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Covariance build and Cholesky factorization, row-sharded over the
    mesh. ``x_local`` is this rank's (R, d) row block of the padded inputs
    (capacity ``R * mesh.size``); returns ``(l_local, ok)``, this rank's (R,
    cap) row block of the factor and a 0-d bool tensor, the same on every
    rank: the whole factor is finite.

    ``storage="bf16"`` stores the row block in bfloat16 (float32 inputs):
    every panel is computed in float32 and rounded when written back, the
    broadcast rows travel in bfloat16 and B2 runs its bfloat16-prefix
    instantiation. ``l0``: an (R, cap) buffer of the storage dtype to factor
    into (zeroed first), so that a refit never holds two factors; its old
    contents are lost either way.
    """
    check_storage(storage, None, x_local.dtype)
    store_dtype = STORAGE_DTYPES[storage] or x_local.dtype
    rows, d = x_local.shape
    cap = rows * mesh.size
    r0, _, b = local_block(mesh, cap, block)
    if l0 is None:
        l_local = torch.zeros((rows, cap), dtype=store_dtype, device=x_local.device)
    else:
        if l0.shape != (rows, cap) or l0.dtype != store_dtype or not l0.is_contiguous():
            raise ValueError(f"factor buffer must be a contiguous ({rows}, {cap}) {store_dtype} "
                             f"tensor, got {tuple(l0.shape)} {l0.dtype}")
        l_local = l0.zero_()
    for j0 in range(0, cap, b):
        owner = j0 // rows
        # a panel of the last rank has no rank below it: nothing to send
        sends = owner < mesh.size - 1
        if mesh.rank < owner:  # above the panel: take part in its broadcasts only
            if sends:
                _panel_broadcasts(mesh, owner, j0, b, d, x_local, l_local, None)
                broadcast(mesh, x_local.new_empty((b, b)), owner)
            continue
        if mesh.rank == owner:
            off = j0 - r0
            xj = (_panel_broadcasts(mesh, owner, j0, b, d, x_local, l_local, off)[0] if sends
                  else x_local[off:off + b])
            # one operand: the strip's columns are its own first rows
            strip = panel_strip(kernel, x_local[off:], xj, None, n, noise, j0, b, method,
                                prefix=l_local[off:, :j0])
            diag, first = strip[:b].contiguous(), off + b
        else:
            xj, lj = _panel_broadcasts(mesh, owner, j0, b, d, x_local, l_local, None)
            # two operands: the broadcast panel rows, the strip from row r0
            strip = panel_strip(kernel, x_local, xj, None, n, noise, j0, b, method,
                                prefix=l_local[:, :j0], panel_rows=lj[:, :j0], row0=r0)
            diag, first = strip.new_empty((b, b)), 0
        if sends:
            broadcast(mesh, diag, owner)
        if eps is None:
            ld, _ = cholesky(diag)
        else:
            ld = cholesky_with_substitute(diag, eps)
        below = strip[b:] if mesh.rank == owner else strip
        if mesh.rank == owner:
            # written back in the storage dtype (rounded for bf16 storage)
            l_local[off:off + b, j0:j0 + b] = ld
        if below.shape[0]:
            # below @ Ld^T = S
            l_local[first:, j0:j0 + b] = torch.linalg.solve_triangular(ld.mT, below, upper=True,
                                                                        left=False)
        del strip, below
    acc = torch.float32 if store_dtype == torch.bfloat16 else store_dtype
    ok = torch.isfinite(torch.sum(l_local, dtype=acc)).to(torch.int32).reshape(1)
    all_reduce(mesh, ok, "min")
    return l_local, ok[0] > 0


def _panel_broadcasts(mesh: Mesh, owner: int, j0: int, b: int, d: int, x_local, l_local,
                      off: Optional[int]):
    """The owner's ``X_j`` (B, d) and panel rows ``L[j0:j0+B, :j0]`` on
    every rank (the rows padded to a multiple of :data:`ROW_PAD` columns, of
    which the first ``j0`` are read; none at j0 = 0); ``off``: the panel's
    first local row on the owner."""
    xj = x_local.new_empty((b, d))
    lj = l_local.new_empty((b, min(-(-j0 // ROW_PAD) * ROW_PAD, l_local.shape[1])))
    if mesh.rank == owner:
        xj.copy_(x_local[off:off + b])
        lj[:, :j0] = l_local[off:off + b, :j0]
        lj[:, j0:] = 0
    broadcast(mesh, xj, owner)
    if j0:
        broadcast(mesh, lj, owner)
    return xj, lj
