"""Panel-blocked triangular solves against a factor that may be stored in
bfloat16.

Counterpart of ``friedrich_tpu/ops/blocked_solve.py`` (``:86``,
``:187-211``). Two sweeps over the factor's row panels of width ``b``:

  forward :  y_j = Ld_j^-1 (c_j - L[j, :j] y[:j])
  backward:  x_j = Ld_j^-T (c_j - L[j+1:, j]^T x[j+1:])

Each panel is read once per sweep and cast to the right-hand side's dtype
on the fly, so a bfloat16 factor is solved in float32 without a float32
copy of the whole factor. Diagonal blocks go through
``torch.linalg.solve_triangular`` (or a precomputed inverse from
:func:`panel_inverses`), the products beside them through ``@``.

The models use these sweeps for a bfloat16 factor only; a float32 or
float64 factor keeps the whole ``torch.linalg.solve_triangular``. The JAX
package's ``fori_loop``/unrolled split and ``MAX_UNROLL_PANELS`` shape TPU
programs and are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from .partition import panel_widths, pick_block


def _compute_dtype(l_mat: torch.Tensor) -> torch.dtype:
    return torch.float32 if l_mat.dtype == torch.bfloat16 else l_mat.dtype


def panel_inverses(l_mat: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Stacked inverses of the factor's diagonal panels, ``(num, b, b)``
    with ``b = pick_block(cap, block)``, in float32 for a bfloat16 factor
    (``friedrich_tpu/ops/blocked_solve.py:86``, ``lower_inverse``)."""
    n = l_mat.shape[0]
    b = pick_block(n, block)
    dtype = _compute_dtype(l_mat)
    eye = torch.eye(b, dtype=dtype, device=l_mat.device)
    return torch.stack([
        torch.linalg.solve_triangular(l_mat[j0:j0 + b, j0:j0 + b].to(dtype), eye, upper=False)
        for j0 in range(0, n, b)
    ])


def _widths(n: int, block: Optional[int], diag_inv: Optional[torch.Tensor]) -> tuple[int, ...]:
    if diag_inv is None:
        return panel_widths(n, block)
    # the inverses fix the panel width
    b = diag_inv.shape[-1]
    if b * diag_inv.shape[0] != n:
        raise ValueError(f"diag_inv {tuple(diag_inv.shape)} does not tile a factor of size {n}")
    return (b,) * (n // b)


def _diag_solve(ld: torch.Tensor, rhs: torch.Tensor, trans: bool,
                diag_inv: Optional[torch.Tensor], j: int) -> torch.Tensor:
    if diag_inv is not None:
        inv = diag_inv[j].to(rhs.dtype)
        return (inv.mT if trans else inv) @ rhs
    ld = ld.to(rhs.dtype)
    return torch.linalg.solve_triangular(ld.mT if trans else ld, rhs, upper=trans)


def _solve(l_mat: torch.Tensor, c: torch.Tensor, block: Optional[int], transposed: bool,
           diag_inv: Optional[torch.Tensor]) -> torch.Tensor:
    n = l_mat.shape[0]
    c2 = c if c.ndim == 2 else c[:, None]
    if c2.dtype == torch.bfloat16:
        c2 = c2.float()
    widths = _widths(n, block, diag_inv)
    starts = [0]
    for w in widths[:-1]:
        starts.append(starts[-1] + w)
    y = torch.empty_like(c2)
    dtype = c2.dtype
    if not transposed:
        for j, (j0, w) in enumerate(zip(starts, widths)):
            j1 = j0 + w
            rhs = c2[j0:j1]
            if j0 > 0:
                rhs = rhs - l_mat[j0:j1, :j0].to(dtype) @ y[:j0]
            y[j0:j1] = _diag_solve(l_mat[j0:j1, j0:j1], rhs, False, diag_inv, j)
    else:
        for j in range(len(widths) - 1, -1, -1):
            j0 = starts[j]
            j1 = j0 + widths[j]
            rhs = c2[j0:j1]
            if j1 < n:
                rhs = rhs - l_mat[j1:, j0:j1].to(dtype).mT @ y[j1:]
            y[j0:j1] = _diag_solve(l_mat[j0:j1, j0:j1], rhs, True, diag_inv, j)
    return y if c.ndim == 2 else y[:, 0]


def blocked_solve_lower(l_mat: torch.Tensor, c: torch.Tensor, block: Optional[int] = None,
                        diag_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``L^-1 c`` by the forward panel sweep; ``c`` a matrix or a vector.
    ``block``: the panel width (``ops/partition.panel_widths``; None for its
    default); ``diag_inv``: :func:`panel_inverses` in place of the diagonal
    solves."""
    return _solve(l_mat, c, block, False, diag_inv)


def blocked_solve_lower_t(l_mat: torch.Tensor, c: torch.Tensor, block: Optional[int] = None,
                          diag_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``L^-T c`` by the backward panel sweep."""
    return _solve(l_mat, c, block, True, diag_inv)


def blocked_cho_solve(l_mat: torch.Tensor, c: torch.Tensor, block: Optional[int] = None,
                      diag_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(L L^T)^-1 c`` by the two sweeps."""
    return blocked_solve_lower_t(l_mat, blocked_solve_lower(l_mat, c, block, diag_inv), block,
                                 diag_inv)
