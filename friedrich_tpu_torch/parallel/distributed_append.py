"""Distributed blocked rank-k Cholesky append (``add_samples`` at scale).

Counterpart of ``friedrich_tpu/parallel/distributed_append.py``
(``:69-112``), the row-sharded form of ``ops/cholesky.cholesky_append_
padded``:

    C   = K(X_old, X_new)   each rank's rows, one B1 launch (cross mode)
    S   = L^-1 C            one distributed forward sweep (sharded rhs)
    L22 = chol(K22 + noise^2 I - S^T S)    (k x k, on every rank)
    rows [n, n+k) of L := [S^T | L22 at columns n..n+k]

The new rows are written by whichever rank owns them, across a rank
boundary too, in place: no second factor and no gather of L.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cholesky import _unblocked_cholesky_substitute, cholesky
from ..ops.covariance import cross_covariance, kernel_diag
from .distributed_solve import distributed_cross_covariance, distributed_solve_lower_sharded_rhs
from .mesh import Mesh


def distributed_cholesky_append(
    mesh: Mesh,
    l_local: torch.Tensor,
    kernel,
    x_local: torch.Tensor,
    n: int,
    x_new: torch.Tensor,
    noise,
    eps: Optional[float] = None,
    block: Optional[int] = None,
    method: str = "gram",
) -> bool:
    """Append ``k = len(x_new)`` rows to the row-sharded factor, in place.

    ``x_local`` is this rank's row block of the padded inputs, which must
    already hold the new points at global rows ``[n, n + k)``; the capacity
    must cover ``n + k``. Returns whether the new rows are finite (the same
    on every rank); when they are not, ``l_local`` is left as it was.
    """
    rows, cap = l_local.shape
    k = x_new.shape[0]
    if n + k > cap:
        raise ValueError(f"capacity {cap} cannot take {n} + {k} rows")
    c_local = distributed_cross_covariance(mesh, kernel, x_local, n, x_new, method=method)
    s = distributed_solve_lower_sharded_rhs(mesh, l_local, c_local, block)  # (cap, k)
    k22 = cross_covariance(kernel, x_new, x_new, method=method)
    # analytic diagonal: see ops/covariance.train_covariance_padded
    kd = kernel_diag(kernel, x_new) + noise * noise
    idx = torch.arange(k, device=x_new.device)
    k22 = torch.where(idx[:, None] == idx[None, :], kd[:, None], k22)
    m22 = k22 - s.mT @ s
    if eps is None:
        l22, _ = cholesky(m22)
    else:
        l22 = _unblocked_cholesky_substitute(m22, eps)
    new_rows = s.mT.contiguous()  # (k, cap): S^T with L22 at columns n..n+k
    new_rows[:, n:n + k] = l22
    ok = bool(torch.isfinite(new_rows).all())  # replicated: the same on every rank
    if ok:
        r0 = mesh.rank * rows
        lo, hi = max(n, r0), min(n + k, r0 + rows)
        if lo < hi:
            l_local[lo - r0:hi - r0] = new_rows[lo - n:hi - n].to(l_local.dtype)
    return ok
