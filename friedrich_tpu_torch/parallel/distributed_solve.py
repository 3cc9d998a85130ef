"""Distributed triangular solves against a row-sharded Cholesky factor.

Counterpart of ``friedrich_tpu/parallel/distributed_solve.py``
(``:55-270``). With the factor row-sharded (``distributed_cholesky.py``),
the predict and fit paths need ``L^-1 C`` and ``L^-T C``: blocked sweeps
over the same panels. The collectives carry only solution blocks, (B, m)
all-reduces of zero-filled buffers, never factor rows, so a sweep moves
cap x m elements forward and 2 cap x m backward whatever the number of
ranks (``tests/test_comm_volume.py``'s contract):

- forward (lower), RIGHT-LOOKING: the panel's owner solves its (B, B)
  diagonal block against its downdated right-hand-side rows; one all-reduce
  gives every rank the (B, m) solution block, and each rank downdates its
  own later rows with its columns of the panel (the dominant work,
  balanced over the ranks);
- backward (lower^T), LEFT-LOOKING: each rank's rows below the panel
  contribute ``L[rows, j0:j0+B]^T x_rows`` (one all-reduce of the (B, m)
  sum), the owner solves its diagonal block transposed, and a second
  all-reduce gives every rank the solved block.

The right-hand side is replicated (cap, m) on every rank, or, for the
forward sweep, row-sharded like the factor (``distributed_solve_lower_
sharded_rhs``: each rank built only its rows, ``distributed_cross_
covariance``). The solution comes back replicated. A bfloat16 factor is
read a panel at a time in the right-hand side's dtype.

``gradient_partials`` is the fits' one other collective: the per-parameter
traces of ``dK`` against the solves, summed over the ranks' rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.covariance import covariance_tile
from ..ops.streamed_matvec import streamed_grad_matvec
from .distributed_cholesky import local_block
from .mesh import Mesh, all_reduce


def _as_matrix(c: torch.Tensor) -> torch.Tensor:
    return c if c.ndim == 2 else c[:, None]


def distributed_solve_lower_sharded_rhs_inplace(mesh: Mesh, l_local: torch.Tensor,
                                                rhs_local: torch.Tensor,
                                                block: Optional[int] = None) -> torch.Tensor:
    """``L^-1 C`` by the right-looking forward sweep from this rank's (R, m)
    rows of C, which it downdates in place (no copy of a freshly built
    right-hand side); returns the replicated (cap, m) solution."""
    rows, cap = l_local.shape
    r0, _, b = local_block(mesh, cap, block)
    m = rhs_local.shape[1]
    dtype = rhs_local.dtype
    y = rhs_local.new_zeros((cap, m))
    for j0 in range(0, cap, b):
        owner = j0 // rows
        yj = rhs_local.new_zeros((b, m))
        if mesh.rank == owner:
            off = j0 - r0
            ld = l_local[off:off + b, j0:j0 + b].to(dtype)
            yj = torch.linalg.solve_triangular(ld, rhs_local[off:off + b], upper=False).contiguous()
        all_reduce(mesh, yj)  # the sweep's one (B, m) collective per panel
        y[j0:j0 + b] = yj
        if mesh.rank >= owner:
            lo = j0 - r0 + b if mesh.rank == owner else 0
            if lo < rows:
                # in place: no (rows, m) temporary beside the right-hand side
                rhs_local[lo:].addmm_(l_local[lo:, j0:j0 + b].to(dtype), yj, alpha=-1)
    return y


def distributed_solve_lower(mesh: Mesh, l_local: torch.Tensor, c: torch.Tensor,
                            block: Optional[int] = None) -> torch.Tensor:
    """``L^-1 C`` with L row-sharded and C (cap, m) or (cap,) replicated;
    returns the solution replicated, in C's shape."""
    cap = l_local.shape[1]
    r0, r1 = mesh.rows(cap)
    y = distributed_solve_lower_sharded_rhs_inplace(mesh, l_local, _as_matrix(c)[r0:r1].clone(),
                                                    block)
    return y if c.ndim == 2 else y[:, 0]


def distributed_solve_lower_sharded_rhs(mesh: Mesh, l_local: torch.Tensor, c_local: torch.Tensor,
                                        block: Optional[int] = None) -> torch.Tensor:
    """``L^-1 C`` with C row-sharded like L (this rank's (R, m) or (R,)
    rows); returns the solution replicated (cap, m) or (cap,)."""
    y = distributed_solve_lower_sharded_rhs_inplace(mesh, l_local, _as_matrix(c_local).clone(),
                                                    block)
    return y if c_local.ndim == 2 else y[:, 0]


def distributed_solve_lower_t(mesh: Mesh, l_local: torch.Tensor, c: torch.Tensor,
                              block: Optional[int] = None) -> torch.Tensor:
    """``L^-T C`` with L row-sharded and C replicated; returns the solution
    replicated, in C's shape."""
    rows, cap = l_local.shape
    r0, _, b = local_block(mesh, cap, block)
    c2 = _as_matrix(c)
    m, dtype = c2.shape[1], c2.dtype
    y = c2.new_zeros((cap, m))
    for j0 in range(cap - b, -1, -b):
        owner = j0 // rows
        contrib = c2.new_zeros((b, m))
        if mesh.rank >= owner:
            lo = j0 - r0 + b if mesh.rank == owner else 0
            if lo < rows:
                contrib = (l_local[lo:, j0:j0 + b].to(dtype).mT @ y[r0 + lo:r0 + rows]).contiguous()
        all_reduce(mesh, contrib)  # first (B, m) collective: the rows below
        xj = c2.new_zeros((b, m))
        if mesh.rank == owner:
            off = j0 - r0
            ld = l_local[off:off + b, j0:j0 + b].to(dtype)
            xj = torch.linalg.solve_triangular(ld.mT, c2[j0:j0 + b] - contrib,
                                               upper=True).contiguous()
        all_reduce(mesh, xj)  # second: the solved block
        y[j0:j0 + b] = xj
    return y if c.ndim == 2 else y[:, 0]


def distributed_cho_solve(mesh: Mesh, l_local: torch.Tensor, c: torch.Tensor,
                          block: Optional[int] = None) -> torch.Tensor:
    """``K^-1 C`` by the forward and the backward sweep (C replicated)."""
    return distributed_solve_lower_t(mesh, l_local, distributed_solve_lower(mesh, l_local, c, block),
                                     block)


def distributed_cross_covariance(mesh: Mesh, kernel, x_local: torch.Tensor, n: int,
                                 xq: torch.Tensor, method: str = "gram") -> torch.Tensor:
    """This rank's (R, m) rows of ``K(X_train_pad, Xq)``, dead rows zeroed:
    one launch of the covariance-tile kernel (B1) in cross mode at the
    rank's first row. Feed it to :func:`distributed_solve_lower_sharded_rhs`."""
    r0, _ = mesh.rows(x_local.shape[0] * mesh.size)
    return covariance_tile(kernel, x_local, xq, n, method=method, row0=r0)


def gradient_partials(mesh: Mesh, kernel, x_pad: torch.Tensor, n: int, alpha: torch.Tensor,
                      probes: torch.Tensor, kinv_z: torch.Tensor,
                      method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha^T dK_p alpha, mean_z (K^-1 z)^T (dK_p z))`` per kernel
    parameter, from ``alpha``, the probes ``Z`` and ``K^-1 Z``, replicated:
    each rank streams its rows of ``dK_p [alpha | Z]`` and the partial sums
    travel in one (2p,) all-reduce."""
    r0, r1 = mesh.rows(x_pad.shape[0])
    dk = streamed_grad_matvec(kernel, x_pad, n, torch.cat([alpha[:, None], probes], dim=1),
                              method=method, rows=(r0, r1))
    data_fit = dk[:, :, 0] @ alpha[r0:r1]
    complexity = torch.einsum("is,pis->p", kinv_z[r0:r1], dk[:, :, 1:]) / probes.shape[1]
    partial = all_reduce(mesh, torch.cat([data_fit, complexity]))
    p = data_fit.shape[0]
    return partial[:p], partial[p:]
