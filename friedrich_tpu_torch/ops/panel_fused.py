"""The panel strip of the streamed Cholesky: covariance-strip build fused
with the left-looking downdate.

Counterpart of ``friedrich_tpu/ops/pallas/panel_fused.py``. For the panel at
column offset ``j0`` and width ``B`` of ``ops/streamed.py``, the pre-factor
strip is

    S = K(X[j0:], X[j0:j0+B])  [analytic diagonal + noise^2, identity padding]
        - P @ P[:B]^T,     P = L[j0:, :j0]  (or a given prefix)

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
                      prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`panel_strip`: the masked kernel strip of
    ``friedrich_tpu/ops/streamed.py:_train_cov_panel_tail`` minus the fat-K
    downdate of ``_unrolled_body`` (``:268-281``), its operands as
    :func:`downdate_operand` gives them."""
    strip = plain_train_covariance_block(kernel, x_tail, xj, n, noise, row0=j0, col0=j0,
                                         method=method)
    p = prefix if prefix is not None else l_full[j0:, :j0]
    if p.shape[1] > 0:
        p = downdate_operand(p, strip.dtype, precision)
        strip = strip - p @ p[:block].mT
    return strip


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor, l_full: torch.Tensor | None,
                n: int, noise, j0: int, block: int, method: str = "gram", precision=None,
                prefix: torch.Tensor | None = None) -> torch.Tensor:
    """The (cap - j0, block) pre-factor strip.

    ``x_tail`` holds rows ``j0..cap`` of the padded inputs, ``xj`` rows
    ``j0..j0+block``, and ``l_full`` is the (cap, cap) factor whose first
    ``j0`` columns are factored (float32, float64, or bfloat16 under float32
    inputs); or ``l_full`` is None and ``prefix`` (cap - j0, C) is the
    prefix. ``precision`` is the factor precision: ``"bf16"`` rounds a
    float32 prefix to bfloat16 (one pass), any other mode keeps it.
    """
    if x_tail.device.type == "cpu":
        return plain_panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method,
                                 precision, prefix)
    return panel_strip_cuda.panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method,
                                        precision, prefix)
