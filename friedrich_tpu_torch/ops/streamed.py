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

``storage="bf16"`` keeps the factor in bfloat16 (half the memory) while every
panel is computed in float32 and rounded only when written back;
``precision`` names the arithmetic of the downdate (see
:func:`streamed_cholesky_factor`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..config import MATMUL_PRECISION_MODES, matmul_precision
from ..utils.errors import ConfigError
from .cholesky import cholesky, cholesky_with_substitute
from .panel_fused import panel_strip
from .partition import panel_widths

#: Factor storage dtypes: None stores L in the input dtype, "bf16" in
#: bfloat16 (``friedrich_tpu/ops/streamed.py:STORAGE_DTYPES``).
STORAGE_DTYPES = {None: None, "bf16": torch.bfloat16}


def check_storage(storage: Optional[str], precision: Optional[str], dtype: torch.dtype) -> None:
    """Raise :class:`ConfigError` for a storage and precision pair the
    factorization does not run, with the JAX package's wording
    (``friedrich_tpu/ops/streamed.py:471-494``)."""
    if precision is not None and precision not in MATMUL_PRECISION_MODES:
        raise ConfigError(
            f"precision must be None or one of {sorted(MATMUL_PRECISION_MODES)}, got {precision!r}"
        )
    if storage not in STORAGE_DTYPES:
        raise ConfigError(
            f"storage must be None or one of {sorted(k for k in STORAGE_DTYPES if k)}, "
            f"got {storage!r}"
        )
    if storage == "bf16":
        if dtype != torch.float32:
            raise ConfigError(f"storage='bf16' requires float32 inputs, got {dtype}")
        if precision not in (None, "bf16"):
            raise ConfigError(
                f"storage='bf16' is incompatible with precision={precision!r}: multi-pass modes "
                "recover f32 operand precision that bf16 storage has already discarded"
            )


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
    each diagonal block (``cholesky_with_substitute``).

    ``storage``: None keeps L in the input dtype; ``"bf16"`` stores it in
    bfloat16 (float32 inputs only) while each panel is computed in float32
    (strip, diagonal factorization, triangular solve) and rounded when
    written back, as in the JAX package. ``precision``: the JAX package's
    matmul precision mode of the whole factorization, run as a
    ``config.matmul_precision`` scope; on the card it also picks the panel
    strip's instantiation: ``"bf16"`` multiplies bfloat16-rounded operands
    in one pass, None, ``"f32x3"`` and ``"f32"`` the near-float32 3xTF32
    product. With bf16 storage it must be None or ``"bf16"`` (the same
    arithmetic: the prefix is already bfloat16).

    ``l0``: a (cap, cap) buffer of the storage dtype on the input device
    (the JAX package's donated workspace,
    ``friedrich_tpu/ops/streamed.py:192-206``), zeroed and then written with
    the factor, which is returned in it; by default a new buffer. Its old
    contents are lost, whether or not the factorization succeeds.
    """
    check_storage(storage, precision, x_pad.dtype)
    store_dtype = STORAGE_DTYPES[storage] or x_pad.dtype
    cap = x_pad.shape[0]
    if l0 is None:
        l_full = torch.zeros((cap, cap), dtype=store_dtype, device=x_pad.device)
    else:
        if l0.dtype != store_dtype:
            raise ValueError(
                f"factor buffer dtype {l0.dtype} does not match the factor storage dtype "
                f"{store_dtype}"
            )
        if l0.shape != (cap, cap) or l0.device != x_pad.device or not l0.is_contiguous():
            raise ValueError(
                f"factor buffer must be a contiguous ({cap}, {cap}) {store_dtype} tensor on "
                f"{x_pad.device}, got {tuple(l0.shape)} {l0.dtype} on {l0.device}"
            )
        # the loop writes the lower triangle and each diagonal block; the
        # strict upper triangle right of each diagonal block must be zero
        l_full = l0.zero_()
    scope = matmul_precision(precision) if precision is not None else contextlib.nullcontext()
    with scope:
        factor_panels(l_full, kernel, x_pad, n, noise, panel_widths(cap, block), eps, method,
                      precision)
    # whole-factor finiteness: a sum propagates NaN/inf with no (cap, cap)
    # temporary; bfloat16 storage accumulates in float32
    acc = torch.float32 if store_dtype == torch.bfloat16 else store_dtype
    return l_full, torch.isfinite(torch.sum(l_full, dtype=acc))


def factor_panels(l_full: torch.Tensor, kernel, x_pad: torch.Tensor, n: int, noise, widths,
                  eps: Optional[float] = None, method: str = "gram",
                  precision: Optional[str] = None) -> None:
    """The left-looking panel loop of :func:`streamed_cholesky_factor` over
    the leading ``size = sum(widths)`` rows and columns of the (cap, cap)
    factor ``l_full``, in place: the factor of K(x_pad[:size]) is written
    into ``l_full[:size, :size]`` (lower triangle and diagonal blocks; rows
    and columns from ``size`` are not touched). The whole factorization
    takes ``size = cap``; the hybrid factorization's leading region
    (``ops/hybrid.py``) a smaller one, each panel strip then ending at row
    ``size``."""
    size = sum(widths)
    j0 = 0
    for width in widths:
        end = j0 + width
        strip = panel_strip(kernel, x_pad[j0:size], x_pad[j0:end], l_full, n, noise, j0, width,
                            method, precision, end=size)
        if eps is None:
            ld, _ = cholesky(strip[:width])
        else:
            ld = cholesky_with_substitute(strip[:width], eps)
        # written back in the storage dtype (rounded for bf16 storage)
        l_full[j0:end, j0:end] = ld
        if end < size:
            # below @ Ld^T = S[B:]
            l_full[end:size, j0:end] = torch.linalg.solve_triangular(
                ld.mT, strip[width:], upper=True, left=False
            )
        del strip
        j0 = end
