"""Streamed (never-materialize-K) blocked Cholesky factorization.

Counterpart of ``friedrich_tpu/ops/streamed.py``: the left-looking panel
loop of ``_unrolled_body`` (``:241-312``) as a Python loop. Each column
panel of the padded training covariance is generated from the inputs,
downdated against the factored panels to its left, and factored:

    for each panel [j0, j0+B):
        S   = K(X[j0:], X[j0:j0+B]) - L[j0:, :j0] L[j0:j0+B, :j0]^T
        Ld  = chol(S[:B])                (eps: per-pivot substitute)
        L[j0:, j0:j0+B] = [Ld; S[B:] Ld^-T]

The strip ``S`` is one launch of the panel-strip kernel on the GPU
(``ops/panel_fused.py``); the diagonal block goes to cuSOLVER and the
block below it to cuBLAS's triangular solve, through ``torch.linalg``. The
panels are written in place into one (cap, cap) factor, so only L and one
(cap - j0, B) strip (plus the solve's output) live on the device: K is
never held. That is what lets a capacity past the dense backend's limit (K
and L together) fit the card. A rebuild can hand in the old factor as that
buffer (``l0``), so that old and new factor never coexist.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.errors import not_ported
from .cholesky import cholesky, cholesky_with_substitute
from .panel_fused import panel_strip
from .partition import panel_widths


def streamed_cholesky_factor(kernel, x_pad: torch.Tensor, n: int, noise,
                             eps: Optional[float] = None, block=None,
                             method: str = "gram", storage: Optional[str] = None,
                             precision: Optional[str] = None,
                             l0: Optional[torch.Tensor] = None,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Covariance build and Cholesky factorization of the padded training
    covariance, K never materialized. Returns ``(L, ok)``, ``ok`` a 0-d
    bool tensor: the whole factor is finite.

    ``block``: a panel width (snapped to a divisor of the capacity), a
    schedule of widths summing to the capacity, or None for the default
    (:func:`~.partition.panel_widths`). ``eps``: per-pivot substitution in
    each diagonal block (``cholesky_with_substitute``). ``storage`` and
    ``precision``, the JAX package's factor storage dtype and matmul
    precision, are not ported: the strips are computed in the input dtype.

    ``l0``: a (cap, cap) buffer of the input dtype on the input device (the
    JAX package's donated workspace, ``friedrich_tpu/ops/streamed.py:192-206``),
    zeroed and then written with the factor, which is returned in it; by
    default a new buffer. Its old contents are lost, whether or not the
    factorization succeeds.
    """
    if storage is not None:
        raise not_ported(f"factor storage {storage!r}")
    if precision is not None:
        raise not_ported(f"factor precision {precision!r}")
    cap = x_pad.shape[0]
    if l0 is None:
        l_full = torch.zeros((cap, cap), dtype=x_pad.dtype, device=x_pad.device)
    else:
        if (l0.shape != (cap, cap) or l0.dtype != x_pad.dtype or l0.device != x_pad.device
                or not l0.is_contiguous()):
            raise ValueError(
                f"factor buffer must be a contiguous ({cap}, {cap}) {x_pad.dtype} tensor on "
                f"{x_pad.device}, got {tuple(l0.shape)} {l0.dtype} on {l0.device}"
            )
        # the loop writes the lower triangle and each diagonal block; the
        # strict upper triangle right of each diagonal block must be zero
        l_full = l0.zero_()
    j0 = 0
    for width in panel_widths(cap, block):
        end = j0 + width
        strip = panel_strip(kernel, x_pad[j0:], x_pad[j0:end], l_full, n, noise, j0, width,
                            method)
        if eps is None:
            ld, _ = cholesky(strip[:width])
        else:
            ld = cholesky_with_substitute(strip[:width], eps)
        l_full[j0:end, j0:end] = ld
        if end < cap:
            # below @ Ld^T = S[B:]
            l_full[end:, j0:end] = torch.linalg.solve_triangular(
                ld.mT, strip[width:], upper=True, left=False
            )
        del strip
        j0 = end
    # whole-factor finiteness: a sum propagates NaN/inf with no (cap, cap) temporary
    return l_full, torch.isfinite(torch.sum(l_full))
