"""Stationary kernels (functions of the pairwise distance).

Counterpart of ``friedrich_tpu/kernels/stationary.py``. Formulas and
gradients are exact transcriptions of the reference
(``parameters/kernel.rs``), including its documented quirks (COMPAT.md):

- ``Exponential`` divides the *non-squared* distance by ``2*ls^2``
  (``kernel.rs:663-665``).
- ``Matern2``'s ls-gradient (``kernel.rs:890-896``) is the reference's own
  expression, and its ``x`` uses the unsanitized ``ls``.
- ``Multiquadric`` computes ``hypot(||d||^2, c)`` (``kernel.rs:1049``) and
  its gradient uses the *non-squared* norm (``kernel.rs:1057``); it is a
  consistent 1-parameter kernel (the reference declares 2).

All parameters arrive "unsanitized" from the multiplicative ADAM optimizer
(possibly negative); sanitization matches the reference (abs/signum noted
per formula).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..ops.distance import DIST, SQDIST
from .base import KernelBase, _StationaryAmplKernel, signum

SQRT3 = 3.0**0.5
SQRT5 = 5.0**0.5


@dataclasses.dataclass(frozen=True, eq=False)
class SquaredExp(_StationaryAmplKernel):
    """Squared-exponential / RBF: ``|ampl| * exp(-||d||^2 / (2 ls^2))``
    (``kernel.rs:507-601``). Params: [ls, ampl]; scalable."""

    ls: Any = 1.0
    ampl: Any = 1.0

    NEEDS = frozenset({SQDIST})

    def pointwise(self, feats):
        ls, ampl = self.params_like(feats)
        return torch.abs(ampl) * torch.exp(-feats[SQDIST] / (2.0 * ls * ls))

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:563-576
        ls, ampl_raw = self.params_like(feats)
        sq = feats[SQDIST]
        ampl = torch.abs(ampl_raw)
        e = torch.exp(-sq / (2.0 * ls * ls))
        grad_ls = (sq * ampl * e) / (ls**3)
        grad_ampl = signum(ampl_raw) * e
        return (grad_ls, grad_ampl)


#: The reference aliases ``Gaussian = SquaredExp`` (``kernel.rs:496``).
Gaussian = SquaredExp


@dataclasses.dataclass(frozen=True, eq=False)
class Exponential(_StationaryAmplKernel):
    """``|ampl| * exp(-||d|| / (2 ls^2))`` — distance NOT squared but the
    denominator still is (``kernel.rs:660-665``). Params: [ls, ampl];
    scalable."""

    ls: Any = 1.0
    ampl: Any = 1.0

    NEEDS = frozenset({DIST})

    def pointwise(self, feats):
        ls, ampl = self.params_like(feats)
        return torch.abs(ampl) * torch.exp(-feats[DIST] / (2.0 * ls * ls))

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:668-681
        ls, ampl_raw = self.params_like(feats)
        dist = feats[DIST]
        ampl = torch.abs(ampl_raw)
        e = torch.exp(-dist / (2.0 * ls * ls))
        grad_ls = (dist * ampl * e) / (ls**3)
        grad_ampl = signum(ampl_raw) * e
        return (grad_ls, grad_ampl)


@dataclasses.dataclass(frozen=True, eq=False)
class Matern1(_StationaryAmplKernel):
    """Matern nu=3/2: ``|ampl| (1 + x) exp(-x)``, ``x = sqrt(3)||d||/|ls|``
    (``kernel.rs:760-772``). Params: [ls, ampl]; scalable."""

    ls: Any = 1.0
    ampl: Any = 1.0

    NEEDS = frozenset({DIST})

    def pointwise(self, feats):
        ls, ampl = self.params_like(feats)
        x = SQRT3 * feats[DIST] / torch.abs(ls)
        return torch.abs(ampl) * (1.0 + x) * torch.exp(-x)

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:774-788
        ls, ampl_raw = self.params_like(feats)
        dist = feats[DIST]
        ampl = torch.abs(ampl_raw)
        x = SQRT3 * dist / torch.abs(ls)
        e = torch.exp(-x)
        grad_ls = (3.0 * ampl * dist * dist * e) / (ls**3)
        grad_ampl = signum(ampl_raw) * (1.0 + x) * e
        return (grad_ls, grad_ampl)


@dataclasses.dataclass(frozen=True, eq=False)
class Matern2(_StationaryAmplKernel):
    """Matern nu=5/2: ``|ampl| (1 + x + 5||d||^2/(3 l^2)) exp(-x)``,
    ``x = sqrt(5)||d||/|l|`` (``kernel.rs:867-879``).
    Params: [ls, ampl]; scalable."""

    ls: Any = 1.0
    ampl: Any = 1.0

    NEEDS = frozenset({DIST})

    def pointwise(self, feats):
        ls, ampl = self.params_like(feats)
        l = torch.abs(ls)
        dist = feats[DIST]
        x = SQRT5 * dist / l
        return torch.abs(ampl) * (1.0 + x + (5.0 * dist * dist) / (3.0 * l * l)) * torch.exp(-x)

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:881-900 — the gradient's ``x`` uses the UNSANITIZED ls
        # (kernel.rs:891) while the rest uses l = |ls|; grad_ls is the
        # reference's own expression, transcribed verbatim.
        ls, ampl_raw = self.params_like(feats)
        dist = feats[DIST]
        ampl = torch.abs(ampl_raw)
        l = torch.abs(ls)
        x = SQRT5 * dist / ls
        e = torch.exp(-x)
        grad_ls = (
            signum(ls)
            * ampl
            * ((2.0 * l / 3.0 + 1.0) + dist * SQRT5 * ((l * l / 3.0 + l + 1.0) / (l * l)))
            * e
        )
        grad_ampl = (
            signum(ampl_raw)
            * (1.0 + x + (5.0 * dist * dist) / (3.0 * l * l))
            * e
        )
        return (grad_ls, grad_ampl)


@dataclasses.dataclass(frozen=True, eq=False)
class Multiquadric(KernelBase):
    """``hypot(||d||^2, c)`` (``kernel.rs:1044-1050``). Param: [c]."""

    c: Any = 0.0

    PARAM_FIELDS = ("c",)
    NEEDS = frozenset({SQDIST, DIST})

    def pointwise(self, feats):
        (c,) = self.params_like(feats)
        return torch.hypot(feats[SQDIST], c)

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:1052-1058 — gradient uses the non-squared norm.
        (c,) = self.params_like(feats)
        return (c / torch.hypot(feats[DIST], c),)


@dataclasses.dataclass(frozen=True, eq=False)
class RationalQuadratic(KernelBase):
    """``(1 + ||d||^2 / (2 alpha ls^2))^(-alpha)`` (``kernel.rs:1116-1123``).
    Params: [alpha, ls]."""

    alpha: Any = 1.0
    ls: Any = 1.0

    PARAM_FIELDS = ("alpha", "ls")
    NEEDS = frozenset({SQDIST})

    def pointwise(self, feats):
        alpha, ls = self.params_like(feats)
        return (1.0 + feats[SQDIST] / (2.0 * alpha * ls * ls)) ** (-alpha)

    def pointwise_grads(self, feats) -> Tuple[torch.Tensor, ...]:
        # kernel.rs:1125-1145 — transcribed verbatim (l = |ls| sanitized for
        # grad_alpha; grad_ls divides by unsanitized ls^3).
        alpha, ls = self.params_like(feats)
        sq = feats[SQDIST]
        l = torch.abs(ls)
        l2 = l * l
        grad_alpha = ((sq + 2.0 * l2 * alpha) / (l2 * alpha)) ** (-alpha) * (
            2.0**alpha * (1.0 - torch.log((sq + 2.0 * l2 * alpha) / (2.0 * l2 * alpha)))
            - (l2 * 2.0 ** (alpha + 1.0) * alpha) / (sq + 2.0 * l2 * alpha)
        )
        grad_ls = (
            sq * (sq / (2.0 * alpha * l * l) + 1.0) ** (-alpha - 1.0) / (ls**3)
        )
        return (grad_alpha, grad_ls)
