"""Inner-product (non-stationary) kernels: Linear, Polynomial, HyperTan.

Counterpart of ``friedrich_tpu/kernels/dot.py``: exact transcriptions of
the reference formulas and gradients (``parameters/kernel.rs:342-402``
Linear, ``:411-485`` Polynomial, ``:934-1001`` HyperTan). None are scalable
and none define heuristic fits, matching the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..ops.distance import DOT
from .base import KernelBase


@dataclasses.dataclass(frozen=True, eq=False)
class Linear(KernelBase):
    """``x1 . x2 + c`` (``kernel.rs:376-382``). Param: [c]."""

    c: Any = 0.0

    PARAM_FIELDS = ("c",)
    NEEDS = frozenset({DOT})

    def pointwise(self, feats):
        (c,) = self.params_like(feats)
        return feats[DOT] + c

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:384-391: grad_c = 1
        return (torch.ones_like(feats[DOT]),)


@dataclasses.dataclass(frozen=True, eq=False)
class Polynomial(KernelBase):
    """``(alpha * x1.x2 + c)^d`` (``kernel.rs:451-457``).
    Params: [alpha, c, d]."""

    alpha: Any = 1.0
    c: Any = 0.0
    d: Any = 1.0

    PARAM_FIELDS = ("alpha", "c", "d")
    NEEDS = frozenset({DOT})

    def pointwise(self, feats):
        alpha, c, d = self.params_like(feats)
        return (alpha * feats[DOT] + c) ** d

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:459-472
        alpha, c, d = self.params_like(feats)
        x = feats[DOT]
        inner = alpha * x + c
        grad_c = d * inner ** (d - 1.0)
        grad_alpha = x * grad_c
        grad_d = torch.log(inner) * inner**d
        return (grad_alpha, grad_c, grad_d)


@dataclasses.dataclass(frozen=True, eq=False)
class HyperTan(KernelBase):
    """``tanh(alpha * x1.x2 + c)`` (``kernel.rs:971-977``).
    Params: [alpha, c]."""

    alpha: Any = 1.0
    c: Any = 0.0

    PARAM_FIELDS = ("alpha", "c")
    NEEDS = frozenset({DOT})

    def pointwise(self, feats):
        alpha, c = self.params_like(feats)
        return torch.tanh(alpha * feats[DOT] + c)

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:979-989
        alpha, c = self.params_like(feats)
        x = feats[DOT]
        grad_c = 1.0 / torch.cosh(alpha * x + c) ** 2
        grad_alpha = x * grad_c
        return (grad_alpha, grad_c)
