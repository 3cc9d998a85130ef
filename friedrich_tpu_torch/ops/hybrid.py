"""Hybrid split Cholesky: the ``"hybrid"`` backend.

Counterpart of ``friedrich_tpu/ops/hybrid.py``. The matrix is split at row
``h``; the leading region is factored by the streamed left-looking panel
loop (or split again, ``levels``), the rest right-looking in place:

    [0, h)                 streamed panels (leaf) or a recursive split
    L21 = K21 L11^-T       column panel by column panel of L11
    S22 = K22 - L21 L21^T  lower column strips, written into the factor
    L22 = tiled right-looking factorization of the S22 region in place

One (cap, cap) buffer holds the factor from start to end; K21 and K22 are
built strip by strip from the inputs and consumed at once, so the peak is
the factor plus a few (cap - h, B) strips. Every write lands on or below the
block diagonal and every diagonal tile ends lower-triangular, so the factor
needs no final mask.

On the card the leaf's panel strips are the panel-strip kernel with the
strip's rows ending at ``h`` (``ops/panel_fused.panel_strip``, ``end``), K21
and K22 are the covariance-tile kernel (``ops/covariance.covariance_tile``:
K21 in cross mode, whose dead rows are zero; K22's lower strips in train
mode, shifted to the strip's own diagonal), and the downdates, the L21
sweep's products and the triangular solves are cuBLAS through
``torch.linalg`` on views of the factor, as they are ``jnp.dot`` and
``solve_triangular`` in the JAX package. Both downdates contract one panel
of L at a time: S22's as the JAX package's loop does, L21's where the JAX
package's forward sweep contracts a whole row of L11 in one product a step.
cuBLAS's float32 GEMM accumulates a contraction in one chain of fused
multiply-adds: at capacity 100,512 on an NVIDIA H100 80GB HBM3 (700 W),
L21's last strip and S22's first, 48,860 and 50,256 deep, were 4.9e-4 and
7.2e-4 from float64 as one product and 9.6e-6 and 9.8e-6 panel by panel
(``chip_smoke.py`` phase 9b, PERF.md). The JAX package's float32
inverse-GEMM in place of the triangular solves (a TPU workaround) and its
``mirror_diag`` are not carried over (``ops/tiled.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import scope
from .covariance import covariance_tile
from .partition import pick_block
from .streamed import factor_panels
from .tiled import region_cholesky_inplace


def _hybrid_region(kernel, x_pad: torch.Tensor, n: int, noise, eps: Optional[float], block: int,
                   method: str, levels: int, h: int, l_full: torch.Tensor, size: int) -> None:
    """Factor K(x_pad[:size]) into ``l_full[:size, :size]`` with a split at
    row ``h``; the leading [0, h) region recurses (or streams at the leaf).
    ``h`` and ``size - h`` are multiples of ``block``."""
    if levels > 1 and h % 2 == 0 and (h // 2) % block == 0:
        _hybrid_region(kernel, x_pad, n, noise, eps, block, method, levels - 1, h // 2, l_full, h)
    else:
        with scope("hybrid/leaf"):
            factor_panels(l_full, kernel, x_pad, n, noise, (block,) * (h // block), eps, method)
    x2 = x_pad[h:size]
    with scope("hybrid/l21"):
        # L21[:, j] = (K21[:, j] - L21[:, :j] L11[j, :j]^T) Ld_j^-T; K21's
        # rows >= n are zero, and when n <= h every row of it is
        for j0 in range(0, h, block):
            j1 = j0 + block
            strip = covariance_tile(kernel, x2, x_pad[j0:j1], n, method=method, row0=h)
            for k0 in range(0, j0, block):
                k1 = k0 + block
                strip.addmm_(l_full[h:size, k0:k1], l_full[j0:j1, k0:k1].mT, alpha=-1)
            l_full[h:size, j0:j1] = torch.linalg.solve_triangular(
                l_full[j0:j1, j0:j1].mT, strip, upper=True, left=False
            )
            del strip
    with scope("hybrid/s22"):
        # K22's rows c0.. by columns c0..c1 is the padded training covariance
        # of x_pad[c0:] with its live block shifted to n - c0
        for c0 in range(h, size, block):
            c1 = c0 + block
            strip = covariance_tile(kernel, x_pad[c0:size], x_pad[c0:c1], max(n - c0, 0), noise,
                                    train=True, method=method)
            for k0 in range(0, h, block):
                k1 = k0 + block
                strip.addmm_(l_full[c0:size, k0:k1], l_full[c0:c1, k0:k1].mT, alpha=-1)
            l_full[c0:size, c0:c1] = strip
            del strip
    with scope("hybrid/l22"):
        region_cholesky_inplace(l_full, h, (size - h) // block, block, eps)


def hybrid_cholesky_factor(kernel, x_pad: torch.Tensor, n: int, noise,
                           eps: Optional[float] = None, block: int = 2048,
                           method: str = "gram", levels: int = 1,
                           split: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Covariance build and split hybrid factorization. Returns ``(L,
    ok)``, ``ok`` a 0-d bool tensor: the whole factor is finite.

    The panel width is ``pick_block(cap // 2, block)``; ``split`` sets the
    leading region's share (rounded to a panel boundary, at least one panel
    on each side); ``levels > 1`` splits the leading region again where its
    half is a whole number of panels. The capacity must be even."""
    cap = x_pad.shape[0]
    if cap % 2:
        raise ValueError("hybrid factorization needs even capacity")
    b = pick_block(cap // 2, block)
    h = max(b, min(cap - b, int(round(cap * split / b)) * b))
    l_full = torch.zeros((cap, cap), dtype=x_pad.dtype, device=x_pad.device)
    _hybrid_region(kernel, x_pad, n, noise, eps, b, method, levels, h, l_full, cap)
    return l_full, torch.isfinite(torch.sum(l_full))
