"""Kernel system: kernels as dataclasses of hyperparameters.

Counterpart of ``friedrich_tpu/kernels/base.py`` and of the reference's
``Kernel`` trait (``parameters/kernel.rs:22-86``). A kernel is data (its
hyperparameters) plus two elementwise maps applied to whole pairwise
feature tiles (see ``ops/distance.py``):

- ``pointwise(feats)``  -> covariance tile       (== trait fn ``kernel``)
- ``pointwise_grads(feats)`` -> per-parameter gradient tiles
  (== trait fn ``gradient``, ``kernel.rs:68-71``; the reference's analytic
  formulas are transcribed exactly — including their quirks — for parity)

Hyperparameters are Python floats or 0-d tensors; the maps convert them to
the features' dtype and device. Kernels compose with ``+`` and ``*`` like
the reference's ``KernelArith`` wrapper (``kernel.rs:312-332``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, FrozenSet, Tuple

import torch

from .heuristics import fit_amplitude_var, fit_bandwidth_mean


def signum(v: torch.Tensor) -> torch.Tensor:
    """Rust ``f64::signum`` semantics: +1 for +0.0 (``torch.sign`` gives 0)."""
    return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.tensor(float(v), dtype=torch.float64)


class KernelBase:
    """Shared kernel API. Concrete kernels are frozen dataclasses
    inheriting from this."""

    # Names of the hyperparameter fields, in the reference's
    # get_parameters/gradient order.
    PARAM_FIELDS: ClassVar[Tuple[str, ...]] = ()
    # Pairwise features this kernel needs ({"dot","sqdist","dist"}).
    NEEDS: ClassVar[FrozenSet[str]] = frozenset()
    # Whether the amplitude can be rescaled in closed form
    # (``kernel.rs:33-36``; unlocks the scaled fit path).
    SCALABLE: ClassVar[bool] = False

    # -- parameter vector plumbing ------------------------------------------
    @property
    def nb_params(self) -> int:
        """Trait fn ``nb_parameters`` (``kernel.rs:27``)."""
        return len(self.PARAM_FIELDS)

    @property
    def needs(self) -> FrozenSet[str]:
        return self.NEEDS

    @property
    def is_scalable(self) -> bool:
        return self.SCALABLE

    def replace(self, **changes) -> "KernelBase":
        return dataclasses.replace(self, **changes)

    def get_params(self) -> torch.Tensor:
        """Flat parameter vector in gradient order (``kernel.rs:74``)."""
        return torch.stack([_as_tensor(getattr(self, f)) for f in self.PARAM_FIELDS])

    def with_params(self, vec: torch.Tensor) -> "KernelBase":
        """Functional ``set_parameters`` (``kernel.rs:77``)."""
        return self.replace(**{f: vec[i] for i, f in enumerate(self.PARAM_FIELDS)})

    def to(self, dtype: torch.dtype, device) -> "KernelBase":
        """The same kernel with every hyperparameter a 0-d tensor of
        ``dtype`` on ``device``."""
        return self.replace(**{
            f: torch.as_tensor(getattr(self, f), dtype=dtype, device=device)
            for f in self.PARAM_FIELDS
        })

    def params_like(self, feats: dict) -> Tuple[torch.Tensor, ...]:
        """The hyperparameters as 0-d tensors of the features' dtype and
        device, in ``PARAM_FIELDS`` order."""
        ref = next(iter(feats.values()))
        return tuple(
            torch.as_tensor(getattr(self, f), dtype=ref.dtype, device=ref.device)
            for f in self.PARAM_FIELDS
        )

    def rescale(self, scale) -> "KernelBase":
        """Multiply the kernel amplitude by ``scale`` (``kernel.rs:38-54``).

        Raises for non-scalable kernels, matching the reference's panic.
        """
        if not self.SCALABLE:
            raise NotImplementedError(
                "You tried to rescale a Kernel that is not Scalable!"
            )
        return self.replace(ampl=self.ampl * scale)

    def heuristic_fit(self, x: torch.Tensor, y: torch.Tensor) -> "KernelBase":
        """Fast data-driven init (``kernel.rs:81-85``); default: no-op."""
        del x, y
        return self

    # -- elementwise maps (implemented by concrete kernels) ------------------
    def pointwise(self, feats: dict) -> torch.Tensor:
        raise NotImplementedError

    def pointwise_grads(self, feats: dict) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    # -- composition ----------------------------------------------------------
    def __add__(self, other: "KernelBase") -> "KernelSum":
        return KernelSum(k1=self, k2=other)

    def __mul__(self, other: "KernelBase") -> "KernelProd":
        return KernelProd(k1=self, k2=other)


class _StationaryAmplKernel(KernelBase):
    """Shared plumbing for (ls, ampl) stationary kernels (RBF/Exp/Matern)."""

    PARAM_FIELDS = ("ls", "ampl")
    SCALABLE = True

    def heuristic_fit(self, x: torch.Tensor, y: torch.Tensor) -> "KernelBase":
        """ls = mean pairwise distance, ampl = var(y)
        (``kernel.rs:594-600`` and identical blocks for Exp/Matern)."""
        return self.replace(ls=fit_bandwidth_mean(x), ampl=fit_amplitude_var(y))


# ---------------------------------------------------------------------------
# Combinators (KernelSum / KernelProd, ``kernel.rs:132-307``)
# ---------------------------------------------------------------------------


class _Composite(KernelBase):
    """Parameter plumbing shared by Sum and Prod: parameters are the
    concatenation [k1-params, k2-params]."""

    k1: Any
    k2: Any

    @property
    def nb_params(self) -> int:
        return self.k1.nb_params + self.k2.nb_params

    @property
    def needs(self) -> FrozenSet[str]:
        return self.k1.needs | self.k2.needs

    def get_params(self) -> torch.Tensor:
        return torch.cat([self.k1.get_params(), self.k2.get_params()])

    def with_params(self, vec: torch.Tensor) -> "_Composite":
        n1 = self.k1.nb_params
        return self.replace(
            k1=self.k1.with_params(vec[:n1]), k2=self.k2.with_params(vec[n1:])
        )

    def to(self, dtype: torch.dtype, device) -> "_Composite":
        return self.replace(k1=self.k1.to(dtype, device), k2=self.k2.to(dtype, device))

    def heuristic_fit(self, x: torch.Tensor, y: torch.Tensor) -> "_Composite":
        return self.replace(
            k1=self.k1.heuristic_fit(x, y), k2=self.k2.heuristic_fit(x, y)
        )


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSum(_Composite):
    """Sum of two kernels (``kernel.rs:132-211``).

    Scalable iff both children are (``kernel.rs:150-153``); rescale applies
    to both (``kernel.rs:174-178``)."""

    k1: Any = None
    k2: Any = None

    @property
    def is_scalable(self) -> bool:
        return self.k1.is_scalable and self.k2.is_scalable

    def rescale(self, scale) -> "KernelSum":
        return self.replace(k1=self.k1.rescale(scale), k2=self.k2.rescale(scale))

    def pointwise(self, feats: dict) -> torch.Tensor:
        return self.k1.pointwise(feats) + self.k2.pointwise(feats)

    def pointwise_grads(self, feats: dict) -> Tuple[torch.Tensor, ...]:
        return tuple(self.k1.pointwise_grads(feats)) + tuple(
            self.k2.pointwise_grads(feats)
        )


@dataclasses.dataclass(frozen=True, eq=False)
class KernelProd(_Composite):
    """Pointwise product of two kernels (``kernel.rs:221-307``).

    Product-rule gradients (``kernel.rs:252-262``); scalable iff either child
    is (``kernel.rs:239-242``); rescale applies to the first scalable child
    (``kernel.rs:264-274``)."""

    k1: Any = None
    k2: Any = None

    @property
    def is_scalable(self) -> bool:
        return self.k1.is_scalable or self.k2.is_scalable

    def rescale(self, scale) -> "KernelProd":
        if self.k1.is_scalable:
            return self.replace(k1=self.k1.rescale(scale))
        return self.replace(k2=self.k2.rescale(scale))

    def pointwise(self, feats: dict) -> torch.Tensor:
        return self.k1.pointwise(feats) * self.k2.pointwise(feats)

    def pointwise_grads(self, feats: dict) -> Tuple[torch.Tensor, ...]:
        v1 = self.k1.pointwise(feats)
        v2 = self.k2.pointwise(feats)
        g1 = self.k1.pointwise_grads(feats)
        g2 = self.k2.pointwise_grads(feats)
        return tuple(g * v2 for g in g1) + tuple(g * v1 for g in g2)
