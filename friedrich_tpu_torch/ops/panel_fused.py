"""The panel strip of the streamed Cholesky: covariance-strip build fused
with the left-looking downdate.

Counterpart of ``friedrich_tpu/ops/pallas/panel_fused.py``. For the panel at
column offset ``j0`` and width ``B`` of ``ops/streamed.py``, the pre-factor
strip is

    S = K(X[j0:], X[j0:j0+B])  [analytic diagonal + noise^2, identity padding]
        - L[j0:, :j0] @ L[j0:j0+B, :j0]^T

:func:`panel_strip` launches the hand-written CUDA kernel
(``ops/cuda/panel_strip_cuda.py``) for tensors on the GPU and runs
:func:`plain_panel_strip`, the plain PyTorch version the kernel is held
against, for tensors on the CPU.
"""

from __future__ import annotations

import torch

from .covariance import plain_train_covariance_block
from .cuda import panel_strip_cuda


def plain_panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor,
                      l_full: torch.Tensor, n: int, noise, j0: int, block: int,
                      method: str = "gram") -> torch.Tensor:
    """Plain version of :func:`panel_strip`: the masked kernel strip of
    ``friedrich_tpu/ops/streamed.py:_train_cov_panel_tail`` minus the fat-K
    downdate of ``_unrolled_body`` (``:268-281``)."""
    strip = plain_train_covariance_block(kernel, x_tail, xj, n, noise, row0=j0, col0=j0,
                                         method=method)
    if j0 > 0:
        strip = strip - l_full[j0:, :j0] @ l_full[j0:j0 + block, :j0].mT
    return strip


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor, l_full: torch.Tensor,
                n: int, noise, j0: int, block: int, method: str = "gram") -> torch.Tensor:
    """The (cap - j0, block) pre-factor strip of the panel at ``j0``.

    ``x_tail`` holds rows ``j0..cap`` of the padded inputs, ``xj`` rows
    ``j0..j0+block``, and ``l_full`` is the (cap, cap) factor whose first
    ``j0`` columns are factored.
    """
    if x_tail.device.type == "cpu":
        return plain_panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method)
    return panel_strip_cuda.panel_strip(kernel, x_tail, xj, l_full, n, noise, j0, block, method)
