"""Cholesky factorizations: plain path with an ``ok`` flag, the per-pivot
epsilon-substitute path, and the blocked rank-k append.

Counterpart of ``friedrich_tpu/ops/cholesky.py``; replaces the nalgebra
calls of the reference:

- ``covmatrix.cholesky()`` (``algebra/mod.rs:90``) -> :func:`cholesky`
  (``torch.linalg.cholesky_ex``, with a failed factorization marked NaN as
  JAX marks it, and a finiteness flag instead of a panic);
- ``Cholesky::new_with_substitute`` (``algebra/mod.rs:83``) ->
  :func:`cholesky_with_substitute`, a blocked right-looking factorization
  whose unblocked diagonal step substitutes ``eps`` for any pivot that is
  not strictly positive (nalgebra's per-pivot semantics);
- ``Cholesky::insert_column`` one column at a time (``algebra/mod.rs:124``)
  -> :func:`cholesky_append_padded`, one blocked rank-k append.
"""

from __future__ import annotations

import torch

from .covariance import cross_covariance, cross_covariance_train_padded, kernel_diag

DEFAULT_BLOCK = 128


def solve_lower(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L^-1 b`` for a matrix or a vector ``b``."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(l_mat, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(l_mat, b, upper=False)


def solve_lower_t(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L^-T b`` for a matrix or a vector ``b``."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(l_mat.mT, b[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(l_mat.mT, b, upper=True)


def cho_solve(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``K^-1 b`` from the lower factor of K."""
    return solve_lower_t(l_mat, solve_lower(l_mat, b))


def cholesky(k_mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain path: ``(L, ok)``, ``ok`` a 0-d bool tensor (finite factor);
    for a stack of matrices, one flag per matrix.

    ``torch.linalg.cholesky`` raises where JAX returns NaN, so this uses
    ``cholesky_ex`` and turns a failed factorization into NaN in place —
    no host sync. The caller raises
    :class:`~friedrich_tpu_torch.utils.errors.CholeskyError` on a False
    flag (the reference panics, ``algebra/mod.rs:90``).
    """
    l_mat, info = torch.linalg.cholesky_ex(k_mat)
    l_mat.mul_(torch.where(info == 0, 1.0, float("nan"))[..., None, None])
    return l_mat, torch.isfinite(torch.sum(l_mat, dim=(-2, -1)))


def _unblocked_cholesky_substitute(a: torch.Tensor, eps) -> torch.Tensor:
    """Right-looking unblocked Cholesky of a small block with per-pivot
    epsilon substitution (nalgebra ``new_with_substitute`` semantics), built
    column by column without in-place updates, so that autograd can
    differentiate it."""
    b = a.shape[0]
    idx = torch.arange(b, device=a.device)
    m, cols = a, []
    for j in range(b):
        d = m[j, j]
        ljj = torch.sqrt(torch.where(d > 0, d, eps))
        below = torch.where(idx > j, m[:, j] / ljj, 0.0)
        cols.append(below + torch.where(idx == j, ljj, 0.0))
        m = m - torch.outer(below, below)
    return torch.tril(torch.stack(cols, dim=1))


def cholesky_with_substitute(k_mat: torch.Tensor, eps,
                             block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Blocked right-looking Cholesky with epsilon pivot substitution.

    Each panel step: (1) factor the diagonal block with the substituting
    unblocked routine, (2) solve the column strip below it against
    L11^T, (3) rank-``block`` update of the trailing matrix. Pivot-level
    substitution is preserved because failures only surface in step (1).
    """
    n = k_mat.shape[0]
    m = k_mat.clone()
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        l11 = _unblocked_cholesky_substitute(m[j0:j1, j0:j1], eps)
        m[j0:j1, j0:j1] = l11
        if j1 < n:
            # below @ L11^T = strip
            below = torch.linalg.solve_triangular(l11.mT, m[j1:, j0:j1], upper=True, left=False)
            m[j1:, j0:j1] = below
            m[j1:, j1:] -= below @ below.mT
    return torch.tril(m)


def cholesky_with_substitute_functional(k_mat: torch.Tensor, eps,
                                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """:func:`cholesky_with_substitute` built out of place, column panel by
    column panel, so that autograd can differentiate it (the density of
    ``mcmc/logprob.py`` with ``cholesky_epsilon`` set); the same
    arithmetic. It holds about twice the memory of the in-place version,
    which the factorizations of large matrices keep."""
    n = k_mat.shape[0]
    m, panels = k_mat, []  # m: the trailing matrix from row/column j0
    for j0 in range(0, n, block):
        w = min(block, n - j0)
        l11 = _unblocked_cholesky_substitute(m[:w, :w], eps)
        below = torch.linalg.solve_triangular(l11.mT, m[w:, :w], upper=True, left=False)
        panels.append(torch.cat([k_mat.new_zeros((j0, w)), l11, below], dim=0))
        m = m[w:, w:] - below @ below.mT
    return torch.tril(torch.cat(panels, dim=1))


def factor(k_mat: torch.Tensor, eps=None,
           block: int = DEFAULT_BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Cholesky when ``eps`` is None, substituting blocked
    factorization otherwise (mirrors the two arms of
    ``make_cholesky_cov_matrix``, ``algebra/mod.rs:81-91``).

    Returns ``(L, ok)``.
    """
    if eps is None:
        return cholesky(k_mat)
    l_mat = cholesky_with_substitute(k_mat, eps, block=block)
    # check the WHOLE factor: a heavily indefinite matrix can overflow the
    # substitute cascade into NaN in OFF-diagonal entries while the
    # diagonal stays finite. A sum propagates NaN/inf without a
    # (cap, cap) bool temporary.
    return l_mat, torch.isfinite(torch.sum(l_mat))


def cholesky_append_padded(
    l_pad: torch.Tensor,
    kernel,
    x_pad: torch.Tensor,
    n_old: int,
    k_new: int,
    noise,
    eps=None,
    method: str = "gram",
    in_place: bool = False,
) -> torch.Tensor:
    """Blocked rank-k append of ``k_new`` rows to a padded Cholesky factor;
    returns a new factor (``l_pad`` is not modified), or, with
    ``in_place=True``, writes rows ``[n_old, n_old+k)`` of ``l_pad`` itself
    and returns it: no second (cap, cap) factor is held.

    Replaces the reference's per-row ``Cholesky::insert_column`` loop
    (``algebra/mod.rs:97-126``) with one blocked update:

        C   = K(X_old, X_new)            (cap x k, dead rows zeroed)
        S   = L^-1 C                     (one triangular solve)
        L22 = chol(K_new + noise^2 I - S^T S)
        L  <- rows [n_old, n_old+k) := [S^T with L22 at column n_old]

    The caller guarantees capacity >= n_old + k_new. When ``eps`` is set,
    the new diagonal block uses the substituting factorization (the
    reference ignores ``cholesky_epsilon`` here — COMPAT.md deviation 3).
    """
    x_new = x_pad[n_old:n_old + k_new]
    c = cross_covariance_train_padded(kernel, x_pad, n_old, x_new, method=method)
    s = solve_lower(l_pad, c)  # (cap, k) — zero in dead rows
    k22 = cross_covariance(kernel, x_new, x_new, method=method)
    # analytic diagonal: see ops/covariance.train_covariance_padded
    kd = kernel_diag(kernel, x_new) + noise * noise
    idx = torch.arange(k_new, device=x_pad.device)
    k22 = torch.where(idx[:, None] == idx[None, :], kd[:, None], k22)
    m22 = k22 - s.mT @ s
    if eps is None:
        l22, _ = cholesky(m22)
    else:
        l22 = _unblocked_cholesky_substitute(m22, eps)
    l_new = l_pad if in_place else l_pad.clone()
    l_new[n_old:n_old + k_new] = s.mT  # columns >= n_old are zero
    l_new[n_old:n_old + k_new, n_old:n_old + k_new] = l22
    return l_new
