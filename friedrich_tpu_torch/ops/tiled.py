"""In-place tiled right-looking Cholesky: the ``"tiled"`` backend.

Counterpart of ``friedrich_tpu/ops/tiled.py``. K is built ONCE into one
(cap, cap) buffer, which the factorization turns into L in place, at the
n^3 / 3 operation count of a right-looking factorization:

    for each panel j:   Ld = chol(K[j, j])
                        L[j+1:, j] = K[j+1:, j] Ld^-T        (one TRSM)
                        K[i, j+1:i+1] -= L[i, j] L[j+1:i+1, j]^T
                                        (one GEMM per row strip i > j)

On the card K is one launch of the covariance-tile kernel (train mode) and
the factorization is cuSOLVER's ``potrf`` on each diagonal tile and cuBLAS
through ``torch.linalg``: one triangular solve of the whole strip below the
tile and one in-place ``addmm_`` per row strip, on views of the buffer (row
stride cap), lower tiles only. That is about (cap/B)^2 / 2 products,
2,556 at capacity 100,512 (B = 1,396), where the JAX package's loop issues
one per tile pair.

Only the lower triangle is read: ``torch.linalg.cholesky_ex`` (and the
substituting factorization) read the lower triangle of a diagonal tile, so
the JAX package's ``mirror_diag``, which symmetrizes a tile for XLA's
Cholesky, has no counterpart; neither has its float32 inverse-GEMM in place
of the triangular solve, a TPU workaround. The stale upper triangle is
zeroed in place at the end (``Tensor.tril_``), so the peak stays at one
buffer plus one strip.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import scope
from .cholesky import cholesky, cholesky_with_substitute
from .covariance import train_covariance_padded
from .partition import pick_block

DEFAULT_TILE = 2048


def region_cholesky_inplace(m: torch.Tensor, base: int, nb: int, block: int,
                            eps: Optional[float]) -> torch.Tensor:
    """Right-looking tiled Cholesky of the ``nb * block``-sized region of
    ``m`` from (base, base), in place; reads and writes the region's lower
    tiles and its diagonal tiles only (a diagonal tile's upper triangle ends
    zero). The tile loop of both the ``"tiled"`` backend (base 0) and the
    hybrid factorization's S22 region (``ops/hybrid.py``). ``eps``: the
    per-pivot substitute in each diagonal tile. Returns ``m``."""
    end = base + nb * block
    for j0 in range(base, end, block):
        j1 = j0 + block
        diag = m[j0:j1, j0:j1]
        if eps is None:
            ld, _ = cholesky(diag)
        else:
            ld = cholesky_with_substitute(diag, eps)
        diag.copy_(ld)
        if j1 == end:
            break
        # below @ Ld^T = K[j1:, j]
        m[j1:end, j0:j1] = torch.linalg.solve_triangular(
            ld.mT, m[j1:end, j0:j1], upper=True, left=False
        )
        for i0 in range(j1, end, block):
            i1 = i0 + block
            m[i0:i1, j1:i1].addmm_(m[i0:i1, j0:j1], m[j1:i1, j0:j1].mT, alpha=-1)
    return m


def tiled_cholesky_inplace(k_mat: torch.Tensor, eps: Optional[float] = None,
                           block: int = DEFAULT_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor a (cap, cap) SPD matrix in place, its upper triangle zeroed;
    ``cap % block == 0``. Returns ``(L, ok)``, ``L`` the input buffer, ``ok``
    a 0-d bool tensor: the whole factor is finite."""
    cap = k_mat.shape[0]
    region_cholesky_inplace(k_mat, 0, cap // block, block, eps)
    k_mat.tril_()
    return k_mat, torch.isfinite(torch.sum(k_mat))


def tiled_cholesky_factor(kernel, x_pad: torch.Tensor, n: int, noise,
                          eps: Optional[float] = None, block: int = DEFAULT_TILE,
                          method: str = "gram") -> tuple[torch.Tensor, torch.Tensor]:
    """The padded training covariance built into one buffer, then factored
    in place (:func:`tiled_cholesky_inplace`) with tiles of
    ``pick_block(cap, block)``. Returns ``(L, ok)``.

    The JAX package builds K strip by strip, because its whole-matrix
    builder's sqdist intermediate would double the peak; the covariance-tile
    kernel has none, so K is one launch here, its output the buffer."""
    b = pick_block(x_pad.shape[0], block)
    with scope("tiled/covariance"):
        k_mat = train_covariance_padded(kernel, x_pad, n, noise, method=method)
    with scope("tiled/factor"):
        return tiled_cholesky_inplace(k_mat, eps=eps, block=b)
