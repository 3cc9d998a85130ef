"""Priors — the regression mean in the absence of data.

Counterpart of ``friedrich_tpu/priors.py`` and of the reference's ``Prior``
trait (``parameters/prior.rs:19-33``): ``mean(x)`` maps an (n, d) input
batch to an (n,) prior mean, and ``fit(x, y)`` returns a NEW fitted prior.

- :class:`ZeroPrior` (``prior.rs:43-56``)
- :class:`ConstantPrior` — fit = mean of outputs (``prior.rs:66-99``)
- :class:`LinearPrior` — fit = SVD least squares on ``[1 | X]``
  (``prior.rs:108-160``); here the pseudo-inverse, which is SVD-based and
  gives the minimum-norm solution like ``jnp.linalg.lstsq``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


class PriorBase:
    """Shared API for priors (immutable dataclasses)."""

    def replace(self, **changes) -> "PriorBase":
        return dataclasses.replace(self, **changes)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Prior mean for each row of ``x`` (trait fn ``prior``)."""
        raise NotImplementedError

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "PriorBase":
        """Fit on training data; default no-op (``prior.rs:28-32``)."""
        del x, y
        return self

    def fit_padded(self, x_pad: torch.Tensor, y_pad: torch.Tensor,
                   live: torch.Tensor) -> "PriorBase":
        """Masked fit on capacity-padded buffers.

        ``live`` is a boolean (cap,) mask; dead rows of ``y_pad`` must be
        zero. Default: no-op.
        """
        del x_pad, y_pad, live
        return self

    def to(self, dtype: torch.dtype, device) -> "PriorBase":
        """The same prior with its parameters as tensors of ``dtype`` on
        ``device``; default: parameterless."""
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroPrior(PriorBase):
    """Always zero (``prior.rs:43-56``)."""

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)

    @classmethod
    def default(cls, input_dim: int) -> "ZeroPrior":
        """``Prior::default`` (``prior.rs:46-49``) — parameterless."""
        del input_dim
        return cls()


@dataclasses.dataclass(frozen=True, eq=False)
class ConstantPrior(PriorBase):
    """A constant; fit sets it to mean(y) (``prior.rs:66-99``)."""

    c: Any = 0.0

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return _like(self.c, x).repeat(x.shape[0])

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "ConstantPrior":
        del x
        return self.replace(c=torch.mean(y))

    def fit_padded(self, x_pad, y_pad, live) -> "ConstantPrior":
        del x_pad
        n = torch.sum(live.to(y_pad.dtype))
        return self.replace(c=torch.sum(torch.where(live, y_pad, 0.0)) / n)

    def to(self, dtype: torch.dtype, device) -> "ConstantPrior":
        return self.replace(c=torch.as_tensor(self.c, dtype=dtype, device=device))

    @classmethod
    def default(cls, input_dim: int) -> "ConstantPrior":
        del input_dim
        return cls(c=0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearPrior(PriorBase):
    """``x @ weights + intercept``; fit = SVD least squares on ``[1 | X]``
    (``prior.rs:108-160``)."""

    weights: Any = None  # (d,)
    intercept: Any = 0.0

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x @ _like(self.weights, x) + _like(self.intercept, x)

    def _solve(self, design: torch.Tensor, rhs: torch.Tensor) -> "LinearPrior":
        sol = torch.linalg.pinv(design) @ rhs
        return self.replace(intercept=sol[0], weights=sol[1:])

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "LinearPrior":
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return self._solve(torch.cat([ones, x], dim=1), y)

    def fit_padded(self, x_pad, y_pad, live) -> "LinearPrior":
        # Zeroed dead rows contribute ||0 - 0||^2 = 0 to the least-squares
        # objective, so the masked solve equals the live-only solve.
        ones = torch.ones((x_pad.shape[0], 1), dtype=x_pad.dtype, device=x_pad.device)
        design = torch.where(live[:, None], torch.cat([ones, x_pad], dim=1), 0.0)
        return self._solve(design, torch.where(live, y_pad, 0.0))

    def to(self, dtype: torch.dtype, device) -> "LinearPrior":
        return self.replace(
            weights=torch.as_tensor(self.weights, dtype=dtype, device=device),
            intercept=torch.as_tensor(self.intercept, dtype=dtype, device=device),
        )

    @classmethod
    def default(cls, input_dim: int) -> "LinearPrior":
        return cls(weights=torch.zeros((input_dim,), dtype=torch.float64), intercept=0.0)


#: Registry for specs.
PRIOR_REGISTRY = {
    "ZeroPrior": ZeroPrior,
    "ConstantPrior": ConstantPrior,
    "LinearPrior": LinearPrior,
}
