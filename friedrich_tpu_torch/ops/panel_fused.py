"""The panel strip of the streamed Cholesky: covariance-strip build fused
with the left-looking downdate.

Counterpart of ``friedrich_tpu/ops/pallas/panel_fused.py``. For the panel at
column offset ``j0`` and width ``B`` of ``ops/streamed.py``, the pre-factor
strip is

    S = K(X[j0:], X[j0:j0+B])  [analytic diagonal + noise^2, identity padding]
        - P @ P[:B]^T,     P = L[j0:, :j0]  (or a given prefix)

A rank of the distributed factorization (``parallel/distributed_cholesky.py``)
below the panel's owner holds rows that are not the panel's: its strip is
``K(X_rank, X_j) - P_rank @ Q^T`` with ``Q`` the panel's rows of the prefix,
broadcast by the owner, as a second operand (``panel_rows``).

:func:`panel_strip` launches the hand-written CUDA kernel
(``ops/cuda/panel_strip_cuda.py``) for tensors on the GPU and runs
:func:`plain_panel_strip`, the plain PyTorch version the kernel is held
against, for tensors on the CPU.
"""

from __future__ import annotations

import torch

from .covariance import plain_train_covariance_block
from .cuda import panel_strip_cuda


def downdate_operand(p: torch.Tensor, dtype: torch.dtype, precision=None) -> torch.Tensor:
    """A prefix as the downdate multiplies it, in the strip's ``dtype``: a
    bfloat16 prefix upcast (its products are exact in float32), a float32
    one rounded to bfloat16 first under the factor precision ``"bf16"``
    (the single-pass instantiation's operands)."""
    if precision == "bf16" and p.dtype == torch.float32:
        p = p.to(torch.bfloat16)
    return p.to(dtype)


def plain_panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor,
                      l_full: torch.Tensor | None, n: int, noise, j0: int, block: int,
                      method: str = "gram", precision=None,
                      prefix: torch.Tensor | None = None, end: int | None = None,
                      panel_rows: torch.Tensor | None = None,
                      row0: int | None = None) -> torch.Tensor:
    """Plain version of :func:`panel_strip`: the masked kernel strip of
    ``friedrich_tpu/ops/streamed.py:_train_cov_panel_tail`` minus the fat-K
    downdate of ``_unrolled_body`` (``:268-281``), its operands as
    :func:`downdate_operand` gives them; with ``panel_rows``, the strip of
    a rank below the panel in ``friedrich_tpu/parallel/distributed_cholesky.py``
    (``:108-127``)."""
    first = j0 if row0 is None else row0
    strip = plain_train_covariance_block(kernel, x_tail, xj, n, noise, row0=first, col0=j0,
                                         method=method)
    p = prefix if prefix is not None else l_full[j0:end, :j0]
    if p.shape[1] > 0:
        q = p[:block] if panel_rows is None else panel_rows[:, :p.shape[1]]
        p = downdate_operand(p, strip.dtype, precision)
        strip = strip - p @ downdate_operand(q, strip.dtype, precision).mT
    return strip


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor, l_full: torch.Tensor | None,
                n: int, noise, j0: int, block: int, method: str = "gram", precision=None,
                prefix: torch.Tensor | None = None, end: int | None = None,
                panel_rows: torch.Tensor | None = None, row0: int | None = None) -> torch.Tensor:
    """The (rows, block) pre-factor strip.

    ``x_tail`` holds rows ``j0..end`` of the padded inputs, ``xj`` rows
    ``j0..j0+block``, and ``l_full`` is the (cap, cap) factor whose first
    ``j0`` columns are factored (float32, float64, or bfloat16 under float32
    inputs), ``end`` (default cap) the row after the strip's last; or
    ``l_full`` is None and ``prefix`` (rows, C) is the prefix.
    ``precision`` is the factor precision: ``"bf16"`` rounds a float32
    prefix to bfloat16 (one pass), any other mode keeps it. ``panel_rows``
    (block, >= C) and ``row0``: the panel's rows as an operand of their own
    and the global row of ``x_tail``'s first row, for a strip whose rows
    are not the panel's (the distributed factorization, ``parallel/``).
    """
    if x_tail.device.type == "cpu":
        return plain_panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method,
                                 precision, prefix, end, panel_rows, row0)
    return panel_strip_cuda.panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method,
                                        precision, prefix, end, panel_rows, row0)
